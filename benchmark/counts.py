"""Frozen counts: the work a training step needs, read the same whatever
implements it, and the card's peaks.

`flops_per_example` is a copy of goctr_tpu_torch/parallel/scanned.py
`model_flops_per_example` (6 × the tower's multiply-adds for forward and
backward, plus the attention pool's 12·T·D vector operations).

`needed_bytes_per_example` counts what one step must move at the least,
and no intermediate: each distinct row of the batch read once and written
once (D float32 weights and its float32 accumulator), the batch's dataset
rows read once, and the dense parameters with adam's two moments read and
written once a step. The step's shares of the peaks therefore sit far
below 100%.

`pool_needed_bytes` is the DIN pool's forward (K2) and backward (K2b) at
the compute dtype: K2 reads the behaviors, item, mask and att0 and writes
the pooled rows; K2b reads the pooled rows' gradient, behaviors, item,
att0 and mask and writes the behaviors', item's and att0's gradients.
"""
from __future__ import annotations

# (bf16 dense tensor FLOP/s, HBM bytes/s) by torch.cuda.get_device_name():
# the H100 SXM5 data sheet (989.4 TFLOP/s dense bf16; 3.35 TB/s)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_dims(model: dict) -> list[int]:
    concat = model["u_profile_dim"] + 2 * model["emb_dim"] + model["ctx_dim"]
    return [concat, *model["hidden"], 1]


def dense_params(model: dict, t: int) -> int:
    """Dense parameters: the tower's weights and biases and att0 [T]."""
    dims = layer_dims(model)
    return t + sum(dims[i] * dims[i + 1] + dims[i + 1]
                   for i in range(len(dims) - 1))


def flops_per_example(model: dict, t: int) -> float:
    dims = layer_dims(model)
    macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return 6.0 * macs + 3.0 * (4.0 * t * model["emb_dim"])


def dataset_bytes_per_example(model: dict, t: int) -> float:
    """A row of the dataset: profile, ctx and label float32, T behavior
    ids and one item id int32."""
    return (model["u_profile_dim"] + model["ctx_dim"] + 1) * 4.0 + (t + 1) * 4.0


def needed_bytes_per_example(model: dict, t: int, batch: int,
                             unique_share: float) -> float:
    """Bytes a step needs, over its batch's examples; unique_share is the
    share of a batch's T + 1 ids a row that are distinct."""
    d = model["emb_dim"]
    rows = unique_share * batch * (t + 1)
    table = 2.0 * rows * (4.0 * d + 4.0)
    dense = 2.0 * 3.0 * 4.0 * dense_params(model, t)
    return (table + dense) / batch + dataset_bytes_per_example(model, t)


def pool_needed_bytes(model: dict, t: int, batch: int) -> float:
    """K2 + K2b bytes of one step (module docstring)."""
    e = DTYPE_BYTES[model["compute_dtype"]]
    d = model["emb_dim"]
    beh, row, mask, att0 = batch * t * d * e, batch * d * e, batch * t * 4, t * 4
    fwd = beh + row + mask + att0 + row
    bwd = row + beh + row + att0 + mask + beh + row + att0
    return float(fwd + bwd)


def card_peaks(name: str) -> tuple[float, float]:
    if name not in CARD_PEAKS:
        raise ValueError(f"no peaks known for the card {name!r}")
    return CARD_PEAKS[name]
