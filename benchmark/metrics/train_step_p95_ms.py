"""p95 of the trainer's device step period, by the nearest rank over
every step of the newest call: from a step's start to the next step's
start in its epoch, an epoch's last step to its own end (the program's
goctr.train.step spans; program_spans.py)."""
from benchmark.program_spans import step_p95_ms


def read(t):
    return step_p95_ms()
