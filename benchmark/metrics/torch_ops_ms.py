"""Device ms a step in PyTorch's own kernels and copies: the step's glue
(sorts, cumsums, permutes, gathers, casts, elementwise ops, copies)."""


def read(t):
    ms = t.class_ms({"torch"})
    return ms / t.steps if ms > 0 else None
