"""The DIN pool's share of its roofline: the least time K2 and K2b could
take (their needed bytes over the HBM rate; the sparse_din family's
`pool_needed_bytes`, `kernel_bytes["din_pool"]`) over their device
time."""


def read(t):
    ms = t.class_ms({"k2", "k2b"})
    if ms <= 0 or "din_pool" not in t.kernel_bytes:
        return None
    bound_ms = t.steps * t.kernel_bytes["din_pool"] / t.peak_bytes * 1e3
    return 100.0 * bound_ms / ms
