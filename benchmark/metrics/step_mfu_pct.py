"""The whole step's share of the card's bf16 dense peak: the run's
examples/s, over the untraced window as train_examples_per_s takes it,
× the frozen FLOPs an example (the family's `flops_per_example`)."""


def read(t):
    if t.rate_window_s <= 0:
        return None
    return (100.0 * t.examples / t.rate_window_s * t.flops_per_example
            / t.peak_flops)
