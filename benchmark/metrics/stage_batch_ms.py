"""Device ms a step in the trainer's batch selection: the epoch order
sliced and the six dataset selections (the span goctr.train.batch;
program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.batch")
