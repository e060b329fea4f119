"""Device ms a step in the table's row write: the split update (K1 read,
torch, K4) or the one-pass kernel (K5 rows, K6 lines) (the span
goctr.train.update_rmw; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.update_rmw")
