"""The whole step's share of the card's HBM rate: the run's examples/s,
over the untraced window as train_examples_per_s takes it, × the bytes an
example needs (the family's `needed_bytes_per_example`; sparse_din's:
distinct rows, the dataset rows and the dense state, each moved once; no
intermediate)."""


def read(t):
    if t.rate_window_s <= 0:
        return None
    return (100.0 * t.examples / t.rate_window_s
            * t.needed_bytes_per_example / t.peak_bytes)
