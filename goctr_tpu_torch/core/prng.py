"""PRNG discipline: one root seed, named streams (port of
goctr_tpu/core/prng.py).

The reference relies on Go's global math/rand plus a numpy-compatible
randomkit RNG (its nn/base/source.go). The JAX package names split keys
so training code never reuses one; here each name gets its own
`torch.Generator`, seeded from the root seed and the name's FNV-1a hash
(the JAX package's `_stable_hash`, copied bit for bit). Torch's streams
are not JAX's: the same seed and name give other numbers in the two
packages, but the same numbers in every run of either.
"""
from __future__ import annotations

import torch

from goctr_tpu_torch.core.dtypes import resolve_device


class PRNGPool:
    """Derives named, counted generators from a root seed.

    >>> pool = PRNGPool(42, device="cpu")
    >>> g1 = pool.next("dropout")   # a fresh stream every call
    >>> g2 = pool.named("init")     # the same stream for a given name
    """

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._root = int(seed)
        self._counters: dict[str, int] = {}

    def _generator(self, *words: int) -> torch.Generator:
        # the root seed and the words, folded FNV-1a style into 63 bits
        h = (self._root * 0x100000001B3) & 0x7FFFFFFFFFFFFFFF
        for w in words:
            h = ((h ^ w) * 0x100000001B3) & 0x7FFFFFFFFFFFFFFF
        return torch.Generator(device=self.device).manual_seed(h)

    def named(self, name: str) -> torch.Generator:
        """A new generator at the start of `name`'s stream."""
        return self._generator(_stable_hash(name))

    def next(self, name: str) -> torch.Generator:
        """A new generator of `name`'s next counted stream."""
        c = self._counters.get(name, 0)
        self._counters[name] = c + 1
        return self._generator(_stable_hash(name), c)


def _stable_hash(s: str) -> int:
    # FNV-1a 32-bit over the UTF-8 bytes; stable across processes (unlike hash()).
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


# torch's CUDA normal draw (ATen/native/cuda/DistributionTemplates.h):
# blocks of 256 threads, at most (threads an SM / 256) blocks an SM; each
# thread draws 4 floats a Philox call (curand_normal4), which advances the
# generator's offset by 4; a draw past 2^31 bytes is cut into halves
# (first halves first) that draw in turn after the whole draw's own
# increment; each increment is rounded up to a multiple of 4.
_BLOCK = 256
_UNROLL = 4
_MAX_BYTES = 2 ** 31 - 1


def _philox_layout(numel: int, sm_count: int, threads_per_sm: int):
    """The pieces of a CUDA float32 draw of `numel` elements: a list of
    (first element, elements, Philox offset relative to the draw's start,
    grid stride in elements), and the offset the whole draw consumes."""
    cap = sm_count * (threads_per_sm // _BLOCK)

    def stride(n):
        return _BLOCK * min(cap, -(-n // _BLOCK))

    def increment(n):
        return -(-n // (stride(n) * _UNROLL)) * 4

    pieces, offset = [], increment(numel)
    stack = [(0, numel)]
    if (numel - 1) * 4 + 1 <= _MAX_BYTES:
        return [(0, numel, 0, stride(numel))], offset
    offset = increment(numel)
    while stack:
        start, n = stack.pop()
        if (n - 1) * 4 + 1 <= _MAX_BYTES:
            pieces.append((start, n, offset, stride(n)))
            offset += increment(n)
            continue
        half = n // 2
        stack.append((start + half, n - half))
        stack.append((start, half))
    return pieces, offset


def randn_rows(generator: torch.Generator, shape: tuple[int, ...],
               start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) (of dim 0) of `torch.randn(shape, generator=
    generator)` as float32, on the generator's device, and the generator
    left as that whole draw leaves it. A CUDA generator draws only those
    rows and at most a grid stride's worth around them (Philox counters
    are addressable: the draw of a tensor's elements from a stride
    boundary on, at the counter offset of that boundary, is the whole
    draw's); a CPU generator draws the whole tensor."""
    rows = shape[0]
    width = 1
    for x in shape[1:]:
        width *= x
    if not 0 <= start <= stop <= rows:
        raise ValueError(f"rows [{start}, {stop}) are not in [0, {rows})")
    dev = generator.device
    if dev.type != "cuda":
        full = torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)
        return full[start:stop].clone()
    props = torch.cuda.get_device_properties(dev)
    pieces, used = _philox_layout(rows * width, props.multi_processor_count,
                                  props.max_threads_per_multi_processor)
    base = generator.get_offset()
    a, b = start * width, stop * width
    out = torch.empty((stop - start,) + tuple(shape[1:]), dtype=torch.float32,
                      device=dev)
    flat = out.view(-1)
    for p0, n, off, stride in pieces:
        lo, hi = max(a, p0), min(b, p0 + n)
        if lo >= hi:
            continue
        span = stride * _UNROLL
        # from the stride boundary at or before lo, at least one stride
        e0 = (lo - p0) // span * span
        e1 = max(hi - p0, min(e0 + stride, n))
        if e1 - e0 < stride:                   # a piece under one stride
            e0, e1 = 0, n
        generator.set_offset(base + off + e0 // span * 4)
        part = torch.randn(e1 - e0, generator=generator,
                           dtype=torch.float32, device=dev)
        flat[lo - a:hi - a] = part[lo - p0 - e0:hi - p0 - e0]
    generator.set_offset(base + used)
    return out
