"""Device ms a step in spreading DLRM's pooled rows' gradient to each id's
row, the table update's stream (the span goctr.train.bag_grad, inside
goctr.train.update_front; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.bag_grad")
