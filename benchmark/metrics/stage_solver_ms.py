"""Device ms a step in the dense solver's update and its in-place adds
(the span goctr.train.solver; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.solver")
