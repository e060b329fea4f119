"""Device ms a step in the port's table-update kernels K4-K9."""


def read(t):
    ms = t.class_ms({"k4", "k5_k6", "k7", "k8", "k9"})
    return ms / t.steps if ms > 0 else None
