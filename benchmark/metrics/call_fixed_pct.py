"""Share of the trainer call's host time outside its epochs: the rows'
upload, the table and solver state's resume and the result's return,
over the whole call (the spans goctr.train.upload, .resume, .return and
goctr.train; program_spans.py)."""
from benchmark.program_spans import call_fixed_pct


def read(t):
    return call_fixed_pct()
