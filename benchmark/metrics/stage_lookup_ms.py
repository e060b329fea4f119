"""Device ms a step in the lookup of the batch's rows, `gather_batch_rows`
with K1 (the span goctr.train.lookup; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.lookup")
