"""Device ms a step in the table update's front end, everything before
the row write: the id stream, the sort and compaction (`update_rows`,
K9) and on grouped lines `line_stream` (the span
goctr.train.update_front; program_spans.py)."""
from benchmark.program_spans import stage_ms


def read(t):
    return stage_ms("goctr.train.update_front")
