"""The card's peaks, which every family's shares are taken over. A family's
own frozen counts (the FLOPs and bytes an example needs, the bytes a step
of a kernel group needs) are in its module (families/)."""
from __future__ import annotations

# (bf16 dense tensor FLOP/s, HBM bytes/s) by torch.cuda.get_device_name():
# the H100 SXM5 data sheet (989.4 TFLOP/s dense bf16; 3.35 TB/s)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}


def card_peaks(name: str) -> tuple[float, float]:
    if name not in CARD_PEAKS:
        raise ValueError(f"no peaks known for the card {name!r}")
    return CARD_PEAKS[name]
