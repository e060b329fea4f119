"""The "xla" compaction's wrapper (ops/kernels/compact_xla.py) on the CPU,
where it runs its plain version, against the glue it replaced in the
fused table update: `sort_updates` on the f32 rows, `_compact_xla`, and
`pack_grads` at G = 1 — bit for bit, on streams that cross the 1024-row
blocks of the cumsum in every way the kernel has to follow. And the
table update given bf16 row gradients against the same call given their
f32 cast, bit for bit, in every update path: each path casts where it
sums in f32 (the cast is exact), the "xla" compaction reads bf16 as it is.

tests/test_torch_cuda.py holds the CUDA kernel against this plain version
on a card, on the same streams (`compaction_case`) and at the benchmark's
full shapes. This file imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest
import torch

from goctr_tpu_torch.ops.kernels import compact_xla as cx
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.parallel import scanned as tsc
from goctr_tpu_torch.parallel.scanned import TableOptConfig

# name → (rows n0, vocab, slots capr, what it holds)
COMPACTION_CASES = {
    # pads (-1) among the ids, n0 not a multiple of 1024 (the stream is
    # padded), fewer real runs than slots (junk slots)
    "mixed": (5000, 700, 2048),
    # one id 40% of the rows: a run of ~2,500 rows across three blocks
    "hot run": (6144, 500, 1024),
    # every row its own run, exactly as many runs as slots
    "distinct": (3072, 4000, 3072),
    # every id a pad: no real run, every slot junk
    "all pads": (2000, 100, 1024),
    # more real runs than slots: overflow
    "overflow": (8000, 5000, 1024),
}


def compaction_case(name: str, d: int, dtype: torch.dtype, seed: int = 0):
    """(ids_flat [n0] int32, g_flat [n0, d] in `dtype`, vocab, capr) of a
    named stream of COMPACTION_CASES, on the CPU. Pad rows carry nonzero
    gradients of both signs, as autograd's may before the mask."""
    n0, vocab, capr = COMPACTION_CASES[name]
    rng = np.random.default_rng(seed)
    if name == "hot run":
        ids = np.where(rng.random(n0) < 0.4, vocab // 3,
                       rng.integers(0, vocab, n0))
    elif name == "distinct":
        ids = rng.permutation(n0)
    elif name == "all pads":
        ids = np.full(n0, -1)
    else:
        ids = rng.integers(-1, vocab, n0)
    g = rng.normal(0, 1, (n0, d)) * rng.choice([1e-3, 1.0, 30.0], (n0, 1))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(g.astype(np.float32)).to(dtype), vocab, capr)


def glue(ids, g, vocab, capr, packed):
    """The fused update's "xla" front end before the kernel."""
    s_ids, g_s = tsc.sort_updates(ids, g.float(), vocab)
    tgt, rows, over = tsc._compact_xla(s_ids, g_s, vocab, capr)
    return tgt, tro.pack_grads(rows) if packed else rows, over


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 16])
@pytest.mark.parametrize("name", list(COMPACTION_CASES))
def test_plain_compaction_equals_the_glue(name, d, dtype):
    ids, g, vocab, capr = compaction_case(name, d, dtype)
    packed = tro.group_size(d) == 1
    s_ids, order = cx.sort_ids(ids, vocab)
    before = cx.compact_xla_rows.launches
    tgt, rows, over = cx.compact_xla_rows(ids, s_ids, order, g, vocab,
                                          capr, packed)
    assert cx.compact_xla_rows.launches == before   # the CPU runs no kernel
    w_tgt, w_rows, w_over = glue(ids, g, vocab, capr, packed)
    assert tuple(rows.shape) == (capr, tro.LANES if packed else d)
    assert torch.equal(tgt, w_tgt) and tgt.dtype == torch.int32
    assert torch.equal(bits(rows), bits(w_rows))
    assert over.dtype == torch.int32 and int(over) == int(w_over)
    n_real = int((tgt < vocab).sum())
    assert (int(over) > 0) == (name == "overflow")
    assert (n_real < capr) == (name in ("mixed", "hot run", "all pads"))
    assert torch.equal(tgt[n_real:], vocab + 1 + torch.arange(
        n_real, capr, dtype=torch.int32))
    assert not rows[n_real:].any()


@pytest.mark.parametrize("d", [64, 16])
def test_update_rows_takes_the_compaction(d):
    """update_rows's "xla" route: the wrapper's rows, packed at G = 1
    (the row update's input, `pack_grads` not needed), [capr, D] on
    grouped lines."""
    ids, g, vocab, _ = compaction_case("mixed", d, torch.bfloat16)
    topt = TableOptConfig(compact_cap=2048, compact_impl="xla")
    tgt, rows, packed, over = tsc.update_rows(ids, g, topt, vocab)
    w_tgt, w_rows, w_over = glue(ids, g, vocab, 2048, False)
    assert torch.equal(tgt, w_tgt) and int(over) == int(w_over)
    assert torch.equal(bits(rows), bits(w_rows))
    if tro.group_size(d) == 1:
        assert torch.equal(bits(packed), bits(tro.pack_grads(w_rows)))
    else:
        assert packed is None


# every path of the table update: (update_mode, compact_cap, compact_impl,
# rmw_impl)
UPDATE_PATHS = [("fused", 2048, "xla", "split"), ("fused", 2048, "xla",
                                                    "kernel"),
                ("fused", 2048, "kernel", "split"), ("fused", 0, "xla",
                                                       "split"),
                ("fused2", 0, "xla", "split"), ("runfused", 0, "xla",
                                                  "split"),
                ("dedup", 0, "xla", "split"), ("sorted", 0, "xla", "split"),
                ("plain", 0, "xla", "split")]


@pytest.mark.parametrize("d", [64, 16])
@pytest.mark.parametrize("mode,cap,impl,rmw", UPDATE_PATHS)
def test_table_update_takes_bf16_as_its_f32_cast(mode, cap, impl, rmw, d):
    ids, g, vocab, _ = compaction_case("mixed", d, torch.bfloat16, seed=1)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(0, 0.01, (vocab, d)).astype(np.float32))
    acc0 = torch.from_numpy(rng.random(vocab).astype(np.float32))
    rows = vocab + (tsc.table_pad_rows(ids.shape[0], 0) if mode == "dedup"
                    else 0)
    topt = TableOptConfig(lr=0.3, update_mode=mode, compact_cap=cap,
                          compact_impl=impl, rmw_impl=rmw)
    out = []
    for grads in (g, g.float()):
        table, acc = tsc._layout_table(mode, w, acc0, vocab, rows)
        over = tsc._table_update(table, ids, grads, topt, vocab, acc)
        out.append((table, acc, int(over)))
    (t_bf, a_bf, o_bf), (t_f, a_f, o_f) = out
    assert o_bf == o_f
    assert torch.equal(bits(t_bf), bits(t_f))
    assert (a_bf is None) == (a_f is None)
    if a_bf is not None:
        assert torch.equal(bits(a_bf), bits(a_f))
    assert not torch.equal(t_bf, tsc._layout_table(mode, w, acc0, vocab,
                                                   rows)[0])
