"""DLRMDCNv2 — DLRM with a DCN-v2 low-rank cross net over multi-hot
sum-pooled features (Naumov et al., arXiv:1906.00091; Wang et al.,
arXiv:2008.13535), the recommendation model of MLPerf Training
(mlcommons/training recommendation_v2/torchrec_dlrm), trained by the
scanned trainer `parallel.scanned.train_sparse_scanned`.

    bottom MLP   dense features [B, 13] → 512 → 256 → 128, ReLU on every
                 layer (torchrec's DenseArch)
    features     F = 26 bags, bag f of hotness[f] ids into feature f's
                 table, each sum-pooled → [B, F, 128]
    interaction  x0 = [bottom | pooled_0 | ... | pooled_25], [B, 27·128]
    cross net    x_{l+1} = x0 ⊙ (W_l (V_l x_l) + b_l) + x_l for l < 3:
                 V_l 3,456 → 512 without a bias, W_l 512 → 3,456 with one
                 (torchrec's LowRankCrossNet)
    top MLP      3,456 → 1024 → 1024 → 512 → 256 with ReLU, → 1 linear
    loss         the mean sigmoid cross-entropy of the logit (weighted:
                 the trainer's pad rows weigh 0)

The widths are constructor arguments; the defaults are MLPerf's. The F
tables are one [V, D] float32 table (V = Σ rows), feature f's rows from
`row_offsets[f]`; the ids arrive as each feature's own, [B, K] int32 with
K = Σ hotness, bag f in columns col_offsets[f] .. col_offsets[f+1] - 1,
each in [0, rows[f]) (there are no pads), and are offset into the table
once on the card. The lookup is kernel K3 (ops/kernels/embedding_lookup.py
`fused_gather_pool` with column offsets): all F bags of the batch pooled
in float32 in one launch, straight from the table the trainer updates
(fused at D = 128: [V, 128] weights with the accumulator apart; dedup,
sorted and plain: [rows, D]). The table never enters autograd: the
pooled rows' gradient [B, F, D] is spread to each id's row
(`update_stream`, `bag_row_grads`), the stream the table update takes.

Numerics, SparseCTR's dtype policy: every product takes compute-dtype
operands and gives float32 (`matmul_f32`, with JAX's backward), bias
adds, ReLU and the cross net's elementwise terms in float32. The values
rounded to the compute dtype are the ones a product reads (the dense
features, the weights, each layer's output, the pooled rows, the cross
net's rank-512 projection); each rounded value's gradient is rounded to
it once, after every use of the value has added its share in float32
(x0 and each x_l are float32 tensors holding compute-dtype values, so
their gradients sum in float32). The pooled rows' gradient is therefore
compute-dtype valued, and the spread stream is exact in the compute
dtype. benchmark/families/dlrm_dcnv2_reference.py computes the same model
in float32 with the same rounding points.

Dense parameters (`param_leaves`, the solver's order; the state_dict
names): bottom_w.i [in, out], bottom_b.i, cross_v.l [3456, 512],
cross_w.l [512, 3456], cross_b.l [3456], top_w.i, top_b.i. `init_params`
draws them as torchrec does (nn.Linear's U(±1/√fan_in) for the MLPs'
weights and biases, xavier-normal cross weights, zero cross biases) and
the table feature by feature, U(±1/√N_f) with N_f the feature's row count
(`init_rows`, the published count where the table holds a share of it).

Spans (core/profiling.py): goctr.dlrm.bottom, .cross and .top around the
forward blocks (inside the trainer's goctr.train.fwd_bwd), and
goctr.train.bag_grad around the spread (inside goctr.train.update_front).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.core.profiling import span
from goctr_tpu_torch.ops.kernels.embedding_lookup import (
    bag_row_grads, fused_gather_pool,
)
from goctr_tpu_torch.ops.losses import bce_loss
from goctr_tpu_torch.ops.matmul import matmul_f32

# MLPerf Training's DLRM-DCNv2 (recommendation_v2/torchrec_dlrm): the
# Criteo 1TB multi-hot sizes and table rows
MLPERF_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                  12, 100, 27, 10, 3, 1, 1)
MLPERF_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
               40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
               40000000, 40000000, 40000000, 590152, 12973, 108, 36)


@dataclasses.dataclass
class DLRMSample:
    """Rows of DLRM training data."""
    dense: np.ndarray      # [N, 13] float32
    ids: np.ndarray        # [N, K] int32, each feature's own ids
    labels: np.ndarray     # [N] float32

    @property
    def rows(self) -> int:
        return self.labels.shape[0]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u.mul_(2.0 * bound).sub_(bound)


class DLRMDCNv2(nn.Module):

    # a trainer batch's rows by name, in the order `train_step` takes them
    batch_names = ("dense", "ids", "labels", "weights")

    def __init__(self, hotness: Sequence[int] = MLPERF_HOTNESS,
                 rows: Sequence[int] = MLPERF_ROWS, emb_dim: int = 128,
                 dense_dim: int = 13,
                 bottom: Sequence[int] = (512, 256, 128),
                 cross_layers: int = 3, cross_rank: int = 512,
                 top: Sequence[int] = (1024, 1024, 512, 256),
                 compute_dtype: torch.dtype = torch.float32,
                 init_rows: Optional[Sequence[int]] = None,
                 device: str | torch.device = "cuda"):
        """Parameters start at 0: draw them with `init_params` or load them
        with `load_state_dict`."""
        super().__init__()
        if len(hotness) != len(rows) or not hotness:
            raise ValueError("hotness and rows need one entry a feature")
        if min(hotness) < 1 or min(rows) < 1:
            raise ValueError("every feature needs an id and a row")
        if bottom[-1] != emb_dim:
            raise ValueError(f"the bottom MLP's output ({bottom[-1]}) must "
                             f"be emb_dim ({emb_dim}) wide")
        self.hotness = tuple(int(h) for h in hotness)
        self.rows = tuple(int(r) for r in rows)
        self.init_rows = tuple(int(r) for r in (init_rows or rows))
        if len(self.init_rows) != len(self.rows):
            raise ValueError("init_rows needs one entry a feature")
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.bottom = tuple(bottom)
        self.cross_layers = cross_layers
        self.cross_rank = cross_rank
        self.top = tuple(top)
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        row_offsets = np.concatenate([[0], np.cumsum(self.rows)])
        col_offsets = np.concatenate([[0], np.cumsum(self.hotness)])
        if row_offsets[-1] >= 2 ** 31 - 1:
            raise ValueError("the table's rows must fit int32 ids")
        self.row_offsets = tuple(int(x) for x in row_offsets[:-1])
        feature = np.repeat(np.arange(self.n_features), self.hotness)
        # [F + 1] K3's column offsets; [K] each column's feature and the
        # row its feature's table starts at
        self.register_buffer("col_offsets", torch.tensor(
            col_offsets, dtype=torch.int32, device=dev), persistent=False)
        self.register_buffer("col_feature", torch.tensor(
            feature, dtype=torch.int64, device=dev), persistent=False)
        self.register_buffer("col_base", torch.tensor(
            row_offsets[feature], dtype=torch.int32, device=dev),
            persistent=False)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        bd = (dense_dim,) + self.bottom
        self.bottom_w = nn.ParameterList(zeros(bd[i], bd[i + 1])
                                         for i in range(len(bd) - 1))
        self.bottom_b = nn.ParameterList(zeros(w) for w in bd[1:])
        x = self.interaction_dim
        self.cross_v = nn.ParameterList(zeros(x, cross_rank)
                                        for _ in range(cross_layers))
        self.cross_w = nn.ParameterList(zeros(cross_rank, x)
                                        for _ in range(cross_layers))
        self.cross_b = nn.ParameterList(zeros(x)
                                        for _ in range(cross_layers))
        td = (x,) + self.top + (1,)
        self.top_w = nn.ParameterList(zeros(td[i], td[i + 1])
                                      for i in range(len(td) - 1))
        self.top_b = nn.ParameterList(zeros(w) for w in td[1:])

    @property
    def n_features(self) -> int:
        return len(self.hotness)

    @property
    def ids_per_example(self) -> int:
        return sum(self.hotness)

    @property
    def item_vocab(self) -> int:
        """Rows of the one table (the trainer's name for them)."""
        return sum(self.rows)

    @property
    def interaction_dim(self) -> int:
        return (self.n_features + 1) * self.emb_dim

    def config(self) -> dict:
        return {"hotness": list(self.hotness), "rows": list(self.rows),
                "emb_dim": self.emb_dim, "dense_dim": self.dense_dim,
                "bottom": list(self.bottom),
                "cross_layers": self.cross_layers,
                "cross_rank": self.cross_rank, "top": list(self.top),
                "init_rows": list(self.init_rows)}

    def param_leaves(self) -> list[nn.Parameter]:
        """The dense parameters in the solver's order (module
        docstring)."""
        return [*self.bottom_w, *self.bottom_b, *self.cross_v,
                *self.cross_w, *self.cross_b, *self.top_w, *self.top_b]

    def leaf_names(self) -> list[str]:
        """The state_dict names of `param_leaves`, in its order."""
        out = []
        for group in ("bottom_w", "bottom_b", "cross_v", "cross_w",
                      "cross_b", "top_w", "top_b"):
            out += [f"{group}.{i}" for i in range(len(getattr(self, group)))]
        return out

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, table_group: int = 1
                    ) -> torch.Tensor:
        """Draw fresh dense parameters from `generator` (module docstring)
        and return a fresh [V, D] float32 table on the generator's
        device, feature by feature."""
        if table_group != 1:
            raise ValueError("DLRMDCNv2's table is [rows, D]: no lines")
        for w, b in [*zip(self.bottom_w, self.bottom_b),
                     *zip(self.top_w, self.top_b)]:
            bound = 1.0 / math.sqrt(w.shape[0])
            w.copy_(_uniform(generator, w.shape, bound))
            b.copy_(_uniform(generator, b.shape, bound))
        for v, w, b in zip(self.cross_v, self.cross_w, self.cross_b):
            for p in (v, w):
                std = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device).mul_(std))
            b.zero_()
        table = torch.empty((self.item_vocab, self.emb_dim),
                            device=generator.device)
        for r0, n, n_init in zip(self.row_offsets, self.rows,
                                 self.init_rows):
            table[r0:r0 + n] = _uniform(generator, (n, self.emb_dim),
                                        1.0 / math.sqrt(n_init))
        return table

    # ---- the forward ----------------------------------------------------

    def apply_pooled(self, dense: torch.Tensor, pooled: torch.Tensor
                     ) -> torch.Tensor:
        """Logits [B] from the dense features [B, 13] and the pooled bags
        [B, F, D] float32. Differentiable with respect to the dense
        parameters and the pooled rows."""
        cd = self.compute_dtype

        def rounded(x):
            # x's value in the compute dtype, kept float32: its gradient
            # sums in float32 and is rounded once
            return x.to(cd).float()

        with span("goctr.dlrm.bottom"):
            h = dense.to(cd)
            for w, b in zip(self.bottom_w, self.bottom_b):
                h = torch.relu(matmul_f32(h, w.to(cd)) + b).to(cd)
        with span("goctr.dlrm.cross"):
            x0 = torch.cat([h.float(),
                            rounded(pooled.reshape(pooled.shape[0], -1))],
                           1)
            x = x0
            for v, w, b in zip(self.cross_v, self.cross_w, self.cross_b):
                u = matmul_f32(x.to(cd), v.to(cd)).to(cd)
                x = rounded(x0 * (matmul_f32(u, w.to(cd)) + b) + x)
        with span("goctr.dlrm.top"):
            h = x.to(cd)
            last = len(self.top_w) - 1
            for i, (w, b) in enumerate(zip(self.top_w, self.top_b)):
                h = matmul_f32(h, w.to(cd)) + b
                if i < last:
                    h = torch.relu(h).to(cd)
            return h[:, 0]

    forward = apply_pooled

    def pool(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """[B, F, D] float32: each feature's bag of `ids` ([B, K] int32,
        each feature's own) sum-pooled from the [rows, D] table (K3, one
        launch)."""
        if table.dim() != 2 or table.shape[1] != self.emb_dim:
            raise ValueError(
                f"DLRMDCNv2 pools a [rows, {self.emb_dim}] table with K3; "
                f"got {tuple(table.shape)} (train it with update_mode "
                "'fused' at D = 128, or 'dedup', 'sorted' or 'plain')")
        return fused_gather_pool(table, ids + self.col_base, "sum",
                                 self.col_offsets)

    # ---- the scanned trainer's step (parallel/scanned.py `train_step`):
    # the members SparseCTR implements alike

    def trainer_arrays(self, sample: DLRMSample) -> dict:
        """{name: (array, fill of the padded tail rows)} that the scanned
        trainer uploads, in `batch_names` order (the row weights are the
        trainer's own; pad rows read id 0 of each feature)."""
        return {"dense": (np.asarray(sample.dense, np.float32), 0),
                "ids": (np.asarray(sample.ids, np.int32), 0),
                "labels": (np.asarray(sample.labels, np.float32).ravel(),
                           0)}

    def lookup_rows(self, table: torch.Tensor, batch: dict,
                    sorted_gather: bool = False, group: int = 1
                    ) -> torch.Tensor:
        """The batch's pooled bags [B, F, D] float32 (`pool`; K3 reads in
        batch order, so `sorted_gather` does not apply)."""
        if group != 1:
            raise ValueError("DLRMDCNv2's table is [rows, D]: no lines")
        return self.pool(table, batch["ids"])

    def batch_loss(self, emb: torch.Tensor, batch: dict,
                   generator: torch.Generator | None = None
                   ) -> torch.Tensor:
        """The training loss of one batch over its pooled bags `emb`."""
        logits = self.apply_pooled(batch["dense"], emb)
        return bce_loss(logits, batch["labels"], batch["weights"])

    def update_stream(self, batch: dict, g_emb: torch.Tensor):
        """(ids [B·K] int32, offset into the table; their rows' gradients
        [B·K, D] in the compute dtype: row b·K + k is the pooled gradient
        of row b's bag that holds column k, `bag_row_grads`)."""
        with span("goctr.train.bag_grad"):
            ids = (batch["ids"] + self.col_base).reshape(-1)
            return ids, bag_row_grads(g_emb, self.col_feature,
                                      self.compute_dtype)
