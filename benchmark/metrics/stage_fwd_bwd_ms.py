"""Device ms a step in the loss and its gradients: the DIN pool (K2, K2b)
and the tower forward and backward, `batch_loss` and autograd (the span
goctr.train.fwd_bwd; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.fwd_bwd")
