"""Share of the untraced window in which no kernel or copy ran on the
card: 1 - the device's busy seconds in the traced window (the same call,
the same work) over the untraced window's seconds, so that the
profiler's cost on the host does not read as idle."""


def read(t):
    if t.rate_window_s <= 0 or t.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.profile.busy_s / t.rate_window_s)
