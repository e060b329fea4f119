"""Device ms a step in kernel K1 (row gathers: the forward lookups and the
split row update's read)."""


def read(t):
    ms = t.class_ms({"k1"})
    return ms / t.steps if ms > 0 else None
