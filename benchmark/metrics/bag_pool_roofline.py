"""DLRM's bag pooling's share of its roofline: the least time K3 could take
(its needed bytes over the HBM rate: each batch's distinct rows read once,
the ids, the [B, F, 128] float32 output; the dlrm_dcnv2 family's
`bag_pool_bytes`, `kernel_bytes["bag_pool"]`) over the device time of the
trainer's lookup stage, which is K3 and the ids' offset add (the span
goctr.train.lookup; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    ms = stage_ms("goctr.train.lookup")
    if not ms or "bag_pool" not in t.kernel_bytes:
        return None
    return 100.0 * t.kernel_bytes["bag_pool"] / t.peak_bytes * 1e3 / ms
