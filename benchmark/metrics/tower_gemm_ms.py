"""Device ms a step in the library's matrix-product kernels (the tower's
forward and backward products)."""


def read(t):
    ms = t.class_ms({"gemm"})
    return ms / t.steps if ms > 0 else None
