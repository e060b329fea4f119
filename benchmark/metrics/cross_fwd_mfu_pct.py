"""The DCN-v2 cross net's forward share of the card's bf16 dense peak: its
products' FLOPs a step (3 layers × 2 products × 2 × 3,456 × 512 × the
batch) over the device time of the span goctr.dlrm.cross (the cross net's
forward, x0's assembly included; program_spans.py)."""
from benchmark.program_spans import stage_ms

LAYERS, WIDTH, RANK = 3, 3456, 512


def read(t):
    ms = stage_ms("goctr.dlrm.cross")
    if not ms or t.steps <= 0:
        return None
    flops = LAYERS * 2 * 2.0 * WIDTH * RANK * t.examples / t.steps
    return 100.0 * flops / (ms / 1e3) / t.peak_flops
