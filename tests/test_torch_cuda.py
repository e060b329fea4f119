"""Each CUDA kernel of the port against its plain PyTorch version, on a
card. Skipped without one: a CUDA kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (tests/conftest.py imports JAX; skip it there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: K1 is a copy plus a round-to-nearest-even cast — bit exact.
K2 sums in f32 in another order than the plain version — atol 1e-6,
rtol 1e-5 in f32; in bf16 both round an f32 value that agrees to a few
f32 ulps, so they agree to one bf16 ulp — rtol 2^-7. K2b likewise on
d_behaviors and d_item (for float32 inputs K2b and its plain version both
work in float64: a zero item row's d_item cancels over t, and float32
rounding alone moves it by ~1e-5 of itself); its d_att0 sums B rows in
another order (atol 1e-5, rtol 1e-5). K4 is a copy — bit exact on every
touched row, and every other row unchanged. The "xla" compaction's
kernel adds the same f32 terms in the same order as its plain version
(the glue's blocked cumsum and run-end differences) — targets, overflow
and Σg bit exact; its packed ‖Σg‖² lane is summed in f64 and rounded
once, against PyTorch's f32 sum — rtol 1e-6. K9 returns the same
targets and overflow; its run sums add the same f32 rows in another
order, so each lies within 1e-5 of the run's sum of |g| (plus 1e-6). K5
and K6 round each term as
the plain version does; only rsqrtf may differ from torch.rsqrt — rtol
1e-6, atol 1e-7, and untouched lines bit exact; under sgd (no rsqrt)
the lines are bit exact. K7 and K8 take gradient
rows on a dyadic grid (multiples of 1/16, |g| <= 1/4) and accumulators
that are multiples of 1/64, so every run sum and cumsum is exact in f32
whatever the order of its adds: K8's sums in tile order equal the plain
version's cumsum differences. ‖Σg‖² is exact too, except for the long
stream's hot run (40,000 rows) at d >= 64, where its ~10^7 units of
1/256 pass 2^24 and two orders of adds may round it an ulp apart
(relative 6e-8). So only rsqrtf and that ulp may differ — the same rtol
1e-6, atol 1e-7, untouched lines bit exact. K3 sums the same
f32 rows in another order than its plain version (atol 1e-6, rtol 1e-5;
on rows of 129-300 ids both are held to the f64 sum instead, within 1e-6
of the sum of the terms' magnitudes); ids past the table give NaN rows
in both. Its backward is torch glue:
held to autograd through the plain pool in f64; index_add_'s f32 atomics
add a row's terms (up to ~2·10^4 for a hot id) in any order, so each
entry lies within 1e-4 of the sum of its terms' magnitudes (+1e-7).
The steps that promise never to make the host wait (parallel/
step_cases.py) run under torch.cuda.set_sync_debug_mode("error"); the
mask-free scatter and dedup, and a headline-shape epoch in dedup, sorted
and plain, equal the masked versions they replaced bit for bit.
"""
import numpy as np
import pytest
import torch

from goctr_tpu_torch.ops.kernels import compact as k9
from goctr_tpu_torch.ops.kernels import compact_xla as kx
from goctr_tpu_torch.ops.kernels import din_attention as k2
from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
from goctr_tpu_torch.ops.kernels import row_gather as k1
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.ops.kernels import run_optimizer as k8
from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.ops.segsum import _cumsum_rows
from goctr_tpu_torch.parallel.embedding import _dedup_flat
from goctr_tpu_torch.parallel.step_cases import sample_arrays, step_cases
from test_torch_compact_xla import COMPACTION_CASES, compaction_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# POOL_SHAPES: rows past 512 B (200, 264), rows of 6 or 12 bytes (D = 3:
# the generic path), the grouped training shape (16 lanes a warp
# instruction), B not a multiple of the persistent grid's warp slots,
# T = 5000 (T-tiles), and the dense DIN's shapes: the ML-20M protocol's
# batch (B = 16,384, T = 10, D = 16) and the test widths (T = 3, D = 7:
# rows of 14 or 28 bytes, the generic path)
POOL_SHAPES = [(64, 6, 264), (128, 9, 3), (65536, 32, 16), (5000, 32, 64),
               (8, 5000, 16), (16384, 10, 16), (200, 3, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(512, 300, 64), (256, 32, 16),
                                   (64, 7, 200), *POOL_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_din_kernel_matches_plain(cuda, dtype, b, t, d):
    rng = np.random.default_rng(4)
    beh = torch.from_numpy(rng.normal(0, 1, (b, t, d)).astype(np.float32))
    beh[0, min(3, t - 1)] = 0.0                      # a zero behavior row
    mask = torch.from_numpy((rng.random((b, t)) > 0.3).astype(np.float32))
    mask[1] = 0.0                                    # an all-masked row
    item = torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
    att0 = torch.from_numpy(rng.normal(1, 0.3, t).astype(np.float32))
    beh, item = beh.to(cuda, dtype), item.to(cuda, dtype)
    att0, mask = att0.to(cuda), mask.to(cuda)
    before = k2.din_attention_pool.launches
    got = k2.din_attention_pool(beh, item, att0, mask)
    want = k2.din_attention_pool_plain(beh, item, att0, mask)
    torch.cuda.synchronize()
    assert k2.din_attention_pool.launches == before + 1
    assert got.dtype == dtype and bool((got[1] == 0).all())
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=rtol)


# K1_LAYOUTS: (layout, dim, group) — plain [V, D] at widths that take
# the aligned path (16, 64, 264) and element loads (3); packed [V, 128]
# rows; grouped lines, whose rows start off 16 bytes (G = 7 at D = 16,
# G = 2 at D = 48, G = 32 at D = 3); the split update's read of all 128
# f32 lanes of a line; and a [V, 64] table whose start is not on 16 bytes
# (element loads).
K1_LAYOUTS = [("plain", 3, 1), ("plain", 16, 1), ("plain", 64, 1),
              ("plain", 264, 1), ("packed", 3, 1), ("packed", 16, 1),
              ("packed", 64, 1), ("grouped", 16, 7), ("grouped", 48, 2),
              ("grouped", 3, 32), ("lines", 128, 1), ("unaligned", 64, 1)]


def _gather_table(layout, dim, dev, rows=1000):
    """(table, dim argument) of a K1 layout holding `rows` rows."""
    gen = torch.Generator(device=dev).manual_seed(dim)
    w = torch.randn(rows, dim, generator=gen, device=dev)
    if layout == "plain":
        return w, dim
    if layout == "packed":
        return tro.pack_table(w), dim
    if layout == "grouped":
        return tro.pack_table_grouped(w), dim
    if layout == "lines":
        return torch.randn(rows, 128, generator=gen, device=dev), None
    flat = torch.randn(rows * dim + 1, generator=gen, device=dev)
    return flat[1:].view(rows, dim), dim                   # 4 bytes off


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
@pytest.mark.parametrize("layout,dim,group", K1_LAYOUTS)
def test_gather_kernel_matches_plain(cuda, layout, dim, group, n):
    """K1 bit-exact against its plain version in both output dtypes, with
    n not a multiple of the rows a warp takes, ids below 0 and past the
    end (NaN rows)."""
    table, dim_arg = _gather_table(layout, dim, cuda)
    rows = table.shape[0] * group
    gen = torch.Generator(device=cuda).manual_seed(n)
    ids = torch.randint(0, rows, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    if n > 1:
        ids[0], ids[-1] = -3, rows
    if n > 4:
        ids[n // 2], ids[n // 3] = rows + 7, rows - 1
    before = k1.gather_rows.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        got = k1.gather_rows(table, ids, group=group, dim=dim_arg,
                             out_dtype=out_dtype)
        want = k1.gather_rows_plain(table, ids, group=group, dim=dim_arg,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (n, dim) and got.dtype == out_dtype
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert bool(torch.isnan(got[ids < 0]).all())
    assert k1.gather_rows.launches == before + 2


def _pool_inputs(b, k, v, d, dev, seed=7):
    """Zipf-like ids (a hot head repeats) with pads, a fully padded row
    and two ids past the table."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    ids = np.minimum(rng.zipf(1.3, (b, k)) - 1, v - 1).astype(np.int32)
    ids[rng.random((b, k)) < 0.25] = -1
    ids[min(1, b - 1)] = -1
    if b > 3:
        ids[2, 0], ids[3, k - 1] = v, v + 100
    return (torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,d", [(4096, 32, 64), (8191, 32, 64),
                                   (1000, 1, 64), (777, 40, 16),
                                   (512, 9, 128), (300, 5, 256),
                                   (256, 7, 3), (256, 6, 10),
                                   (300, 5, 264), (100, 7, 600)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_kernel_matches_plain(cuda, combiner, b, k, d):
    table, ids = _pool_inputs(b, k, 5000, d, cuda)
    before = k3.fused_gather_pool.launches
    got = k3.fused_gather_pool(table, ids, combiner)
    want = k3.fused_gather_pool_plain(table, ids, combiner)
    torch.cuda.synchronize()
    assert k3.fused_gather_pool.launches == before + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if b > 3:
        assert bool(torch.isnan(got[2]).all()) and bool((got[1] == 0).all())
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               atol=1e-6, rtol=1e-5)


def _shared_pool_inputs(b, k, v, d, share, dev, seed=9, offset=0):
    """Uniform ids of which a share `share` are real (the rest -1, as a
    mesh rank's masking leaves them); where any are real, row 1 is fully
    padded, row 3 has exactly one real id and row 2 one id past the table.
    offset > 0 places the table `offset` floats past an aligned address."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    ids[rng.random((b, k)) >= share] = -1
    if share > 0:
        ids[1] = -1
        ids[3] = -1
        ids[3, k // 2] = 7
        ids[2, 0] = v + 3
    flat = torch.from_numpy(rng.normal(0, 0.1, v * d + offset).astype(
        np.float32)).to(dev)
    table = flat[offset:].view(v, d)
    return table, torch.from_numpy(ids).to(dev)


def _check_pool(table, ids, combiner):
    before = k3.fused_gather_pool.launches
    got = k3.fused_gather_pool(table, ids, combiner)
    want = k3.fused_gather_pool_plain(table, ids, combiner)
    torch.cuda.synchronize()
    assert k3.fused_gather_pool.launches == before + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               atol=1e-6, rtol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.12, 0.5, 1.0])
@pytest.mark.parametrize("d", [1, 3, 16, 64, 264, 600])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_kernel_at_real_shares(cuda, combiner, d, share):
    """K3 loads only the real ids of a row: rows of 0%, 12%, 50% and 100%
    real ids, across the 32-id chunk (K = 40), at every load width."""
    table, ids = _shared_pool_inputs(999, 40, 3000, d, share, cuda)
    got = _check_pool(table, ids, combiner)
    if share == 0.0:
        assert bool((got == 0).all())
    else:
        assert bool((got[1] == 0).all()) and bool(torch.isnan(got[2]).all())
        assert torch.equal(got[3], table[7])       # one real id: its row


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.12, 1.0])
@pytest.mark.parametrize("k", [129, 300])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_kernel_on_long_rows(cuda, combiner, k, share):
    """Rows longer than the ids a warp compacts at once (128). Over up to
    300 f32 adds either order moves an entry near 0 by more than TOL's
    atol (the plain version reads 1.3e-6 from the f64 sum at K = 300), so
    kernel and plain version are each held to the f64 sum, within 1e-6
    of the sum of the terms' magnitudes (+1e-7)."""
    table, ids = _shared_pool_inputs(513, k, 3000, 64, share, cuda)
    before = k3.fused_gather_pool.launches
    got = k3.fused_gather_pool(table, ids, combiner)
    want = k3.fused_gather_pool_plain(table, ids, combiner)
    torch.cuda.synchronize()
    assert k3.fused_gather_pool.launches == before + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    v = table.shape[0]
    ok = (ids >= 0) & (ids < v)
    rows = table.double()[torch.where(ok, ids, 0).long()] * ok[..., None]
    ref, mag = rows.sum(1), rows.abs().sum(1)
    if combiner == "mean":
        n = (ids >= 0).sum(1, keepdim=True).clamp_min(1).double()
        ref, mag = ref / n, mag / n
    fine = ~torch.isnan(want)
    for out in (got, want):
        err = (out.double() - ref).abs()[fine]
        assert bool((err <= 1e-6 * mag[fine] + 1e-7).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset", [(64, 1), (64, 2), (16, 1), (16, 2)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_kernel_on_misaligned_tables(cuda, combiner, d, offset):
    """A table 4 or 8 bytes off a 16-byte boundary takes the scalar or
    float2 loads; half its ids real."""
    table, ids = _shared_pool_inputs(1000, 32, 3000, d, 0.5, cuda,
                                     offset=offset)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    _check_pool(table, ids, combiner)


@pytest.mark.cuda
def test_gather_pool_mean_gradient(cuda):
    table, ids = _pool_inputs(2048, 32, 3000, 64, cuda)
    g = torch.randn(2048, 64, device=cuda)
    t = table.clone().requires_grad_()
    before = k3.fused_gather_pool.launches
    k3.GatherPoolMean.apply(t, ids).backward(g)
    assert k3.fused_gather_pool.launches == before + 1
    valid = ids >= 0
    ok = valid & (ids < table.shape[0])
    count = valid.sum(1, keepdim=True).clamp_min(1)

    def plain_grad(gg):            # autograd through the plain pool, f64
        t2 = table.double().requires_grad_()
        rows = t2[torch.where(ok, ids, 0).long()] * ok[..., None]
        (rows.sum(1) / count).backward(gg.double())
        return t2.grad

    err = (t.grad.double() - plain_grad(g)).abs()
    assert bool((err <= 1e-4 * plain_grad(g.abs()) + 1e-7).all())


def _din_bwd_inputs(b, t, d, dtype, dev, seed=5):
    rng = np.random.default_rng(seed)
    beh = torch.from_numpy(rng.normal(0, 1, (b, t, d)).astype(np.float32))
    beh[0, min(3, t - 1)] = 0.0                      # a zero behavior row
    mask = torch.from_numpy((rng.random((b, t)) > 0.3).astype(np.float32))
    mask[1] = 0.0                                    # an all-masked row
    item = torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
    item[2] = 0.0                                    # a zero item row
    att0 = torch.from_numpy(rng.normal(1, 0.3, t).astype(np.float32))
    dout = torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
    return (dout.to(dev, dtype), beh.to(dev, dtype), item.to(dev, dtype),
            att0.to(dev), mask.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(512, 32, 64), (64, 300, 16),
                                   (37, 7, 200), *POOL_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_din_bwd_kernel_matches_plain(cuda, dtype, b, t, d):
    args = _din_bwd_inputs(b, t, d, dtype, cuda)
    before = k2.din_attention_pool_bwd.launches
    got = k2.din_attention_pool_bwd(*args)
    want = k2.din_attention_pool_bwd_plain(*args)
    torch.cuda.synchronize()
    assert k2.din_attention_pool_bwd.launches == before + 1
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6,
                                   rtol=rtol)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    # the all-masked row takes no gradient through the gate
    assert bool((got[0][1] == 0).all())
    # repeatable bit for bit (no float atomics)
    again = k2.din_attention_pool_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", POOL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_din_kernels_unmasked_match_plain(cuda, dtype, b, t, d):
    """The dense DIN's call: no mask (every behavior counts; K2 takes
    None as all ones), and through DinAttentionPool a gradient for att0
    only (behaviors and item are data). Limits as in the masked tests."""
    dout, beh, item, att0, _ = _din_bwd_inputs(b, t, d, dtype, cuda)
    mask = torch.ones(b, t, device=cuda)
    got = k2.din_attention_pool(beh, item, att0)
    want = k2.din_attention_pool_plain(beh, item, att0, mask)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=rtol)
    want_b = k2.din_attention_pool_bwd_plain(dout, beh, item, att0, mask)
    got_b = k2.din_attention_pool_bwd(dout, beh, item, att0, mask)
    torch.cuda.synchronize()
    for g, w in zip(got_b[:2], want_b[:2]):
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6,
                                   rtol=rtol)
    torch.testing.assert_close(got_b[2], want_b[2], atol=1e-5, rtol=1e-5)
    a = att0.clone().requires_grad_()
    before = k2.din_attention_pool_bwd.launches
    k2.DinAttentionPool.apply(beh, item, a, mask).backward(dout)
    assert k2.din_attention_pool_bwd.launches == before + 1
    torch.testing.assert_close(a.grad, want_b[2], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_din_pool_gradient_runs_through_k2b(cuda):
    dout, beh, item, att0, mask = _din_bwd_inputs(64, 32, 64,
                                                  torch.bfloat16, cuda)
    beh.requires_grad_()
    item.requires_grad_()
    att0.requires_grad_()
    before = (k2.din_attention_pool.launches,
              k2.din_attention_pool_bwd.launches)
    out = k2.DinAttentionPool.apply(beh, item, att0, mask)
    out.backward(dout)
    assert (k2.din_attention_pool.launches,
            k2.din_attention_pool_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = k2.din_attention_pool_bwd_plain(dout, beh.detach(),
                                           item.detach(), att0.detach(),
                                           mask)
    torch.testing.assert_close(beh.grad.float(), want[0].float(),
                               atol=1e-6, rtol=2.0 ** -7)
    torch.testing.assert_close(att0.grad, want[2], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    v, n = 5000, 4096
    table = torch.randn(v, 128, generator=gen, device=cuda)
    real = torch.randperm(v, generator=gen, device=cuda)[:1500]
    junk = v + 1 + torch.arange(n - 1500, device=cuda)     # past the table
    ids = torch.cat([real, junk])[torch.randperm(n, generator=gen,
                                                 device=cuda)].int()
    rows = torch.randn(n, 128, generator=gen, device=cuda)
    want = tro.scatter_rows_packed_plain(table.clone(), ids, rows, skip_ge=v)
    before = tro.scatter_rows_packed.launches
    got = tro.scatter_rows_packed(table.clone(), ids, rows, skip_ge=v)
    torch.cuda.synchronize()
    assert tro.scatter_rows_packed.launches == before + 1
    assert torch.equal(got, want)
    touched = torch.zeros(v, dtype=torch.bool, device=cuda)
    touched[real] = True
    assert torch.equal(got[~touched], table[~touched])
    # skip_ge below V: the ids in [skip_ge, V) are skipped as well
    got = tro.scatter_rows_packed(table.clone(), ids, rows, skip_ge=v // 2)
    want = tro.scatter_rows_packed_plain(table.clone(), ids, rows,
                                         skip_ge=v // 2)
    assert torch.equal(got, want)


def _sorted_stream(n, vocab, n_pad, dev, dim=64, hot=30000, seed=6):
    """Sorted ids with a hot run across many tiles (`hot` rows of one id),
    many short runs, and n_pad pads (id = vocab) last."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(hot, 7), rng.integers(0, vocab,
                                                        n - hot - n_pad)])
    ids = np.concatenate([np.sort(ids), np.full(n_pad, vocab)])
    g = rng.normal(0, 1, (n, dim)).astype(np.float32)
    g[n - n_pad:] = 0.0
    return (torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(g).to(dev))


def _compact_case(case, dev):
    """(ids, g, vocab, capr) of a K9 card case."""
    vocab = 3000
    if case.startswith("d="):              # each lane layout: 8, 2, 1 rows
        d = int(case[2:])                  # a step (126: element loads)
        return (*_sorted_stream(70656, vocab, 1000, dev, dim=d), vocab, 4096)
    if case == "n ragged":                 # n % 128 != 0, D % 4 != 0
        return (*_sorted_stream(70001, vocab, 1000, dev, dim=37), vocab, 4096)
    if case == "run of 70000":             # ~547 tiles of one run
        return (*_sorted_stream(100000, vocab, 1000, dev, dim=16,
                                hot=70000), vocab, 4096)
    if case == "every row a run":
        n = 5000
        rng = np.random.default_rng(8)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        g = torch.from_numpy(rng.normal(0, 1, (n, 64)).astype(np.float32))
        return ids, g.to(dev), 10000, 8192
    if case == "every id a pad":           # total 0: every slot junk
        rng = np.random.default_rng(9)
        ids = torch.full((4000,), vocab, dtype=torch.int32, device=dev)
        g = torch.from_numpy(rng.normal(0, 1, (4000, 16)).astype(np.float32))
        return ids, g.to(dev), vocab, 1024
    if case == "overflow":                 # capr below the real runs
        return (*_sorted_stream(70656, vocab, 1000, dev), vocab, 1024)
    if case == "g unaligned":              # g not on 16 bytes: element loads
        ids, g = _sorted_stream(70656, vocab, 1000, dev)
        buf = torch.empty(g.numel() + 1, device=dev)
        g_off = buf[1:].view(g.shape)
        g_off.copy_(g)
        return ids, g_off, vocab, 4096
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d=16", "d=64", "d=126", "n ragged",
                                  "run of 70000", "every row a run",
                                  "every id a pad", "overflow",
                                  "g unaligned"])
def test_compact_kernel_matches_plain(cuda, case):
    s_ids, g, vocab, capr = _compact_case(case, cuda)
    d = g.shape[1]
    before = k9.compact_runsums_block.launches
    tgt, rows, over = k9.compact_runsums_block(s_ids, g, vocab, capr)
    w_tgt, w_rows, w_over = k9.compact_runsums_plain(s_ids, g, vocab, capr)
    torch.cuda.synchronize()
    assert k9.compact_runsums_block.launches == before + 1
    assert torch.equal(tgt, w_tgt) and int(over) == int(w_over)
    assert (int(over) > 0) == (case == "overflow")
    _, abs_rows, _ = k9.compact_runsums_plain(s_ids, g.abs(), vocab, capr)
    limit = 1e-5 * abs_rows[:, :d] + 1e-6
    assert bool(((rows[:, :d] - w_rows[:, :d]).abs() <= limit).all())
    torch.testing.assert_close(rows[:, d], w_rows[:, d], rtol=1e-4,
                               atol=1e-4)
    assert bool((rows[:, d + 1:] == 0).all())
    again = k9.compact_runsums_block(s_ids, g, vocab, capr)
    assert all(torch.equal(x, y) for x, y in zip(again, (tgt, rows, over)))


# the "xla" compaction's kernel: the CPU tests' streams at D 64 (packed
# rows) and 16 (grouped lines), bf16 and f32; widths and layouts that take
# the other routes (P = 4 columns a lane at D = 126, element loads at an
# odd D and for rows off their alignment); and the benchmark cells' full
# shapes, zipf ids with a tenth pads: (rows, vocab, D, capr)
XLA_CELL_STREAMS = {"cell 1": (65_536 * 33, 10_000_000, 64, 596_992),
                    "cell 2": (65_536 * 33, 100_000_000, 16, 768_000),
                    "cell 3": (16_384 * 257, 10_000_000, 64, 1_048_576)}


def _xla_cell_stream(cell, dev):
    n0, vocab, d, capr = XLA_CELL_STREAMS[cell]
    rng = np.random.default_rng(11)
    ranks = np.minimum(rng.zipf(1.05, n0), vocab) - 1
    ids = (ranks * 2_654_435_761) % vocab          # hot ids spread out
    ids[rng.random(n0) < 0.1] = -1
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    g = torch.randn(n0, d, generator=gen, device=dev).to(torch.bfloat16)
    return ids, g, vocab, capr


def _check_xla_compaction(ids, g, vocab, capr):
    """The kernel against its plain version on the card: targets,
    overflow and the D weight lanes bit for bit; the packed ‖Σg‖² lane
    within rtol 1e-6 (f64 then rounded once, against PyTorch's f32 sum),
    the lanes past it 0; a second call bit for bit; one launch a call."""
    d = g.shape[1]
    packed = tro.group_size(d) == 1 and d < tro.LANES   # 128: unpacked
    s_ids, order = kx.sort_ids(ids, vocab)
    before = kx.compact_xla_rows.launches
    tgt, rows, over = kx.compact_xla_rows(ids, s_ids, order, g, vocab, capr,
                                          packed)
    again = kx.compact_xla_rows(ids, s_ids, order, g, vocab, capr, packed)
    w_tgt, w_rows, w_over = kx.compact_xla_rows_plain(ids, s_ids, order, g,
                                                      vocab, capr, packed)
    torch.cuda.synchronize()
    assert kx.compact_xla_rows.launches == before + 2
    assert torch.equal(tgt, w_tgt) and int(over) == int(w_over)
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(rows[:, :d]), bits(w_rows[:, :d]))
    if packed:
        torch.testing.assert_close(rows[:, d], w_rows[:, d], rtol=1e-6,
                                   atol=0.0)
        assert torch.equal(bits(rows[:, d + 1:]), bits(w_rows[:, d + 1:]))
    assert all(torch.equal(bits(x), bits(y))
               for x, y in zip(again, (tgt, rows, over)))
    return int((tgt < vocab).sum()), int(over)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 16])
@pytest.mark.parametrize("name", list(COMPACTION_CASES))
def test_compact_xla_kernel_matches_plain(cuda, name, d, dtype):
    ids, g, vocab, capr = compaction_case(name, d, dtype)
    _check_xla_compaction(ids.to(cuda), g.to(cuda), vocab, capr)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["d=126", "d=63", "g unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_compact_xla_kernel_on_other_routes(cuda, route, dtype):
    d = {"d=126": 126, "d=63": 63}.get(route, 64)
    ids, g, vocab, capr = compaction_case("hot run", d, dtype)
    g = g.to(cuda)
    if route == "g unaligned":
        buf = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)
        g_off = buf[1:].view(g.shape)
        g_off.copy_(g)
        g = g_off
    _check_xla_compaction(ids.to(cuda), g, vocab, capr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(COMPACTION_CASES))
def test_compact_xla_kernel_unpacked_at_d128(cuda, name, dtype):
    """D = 128, where the weights and the accumulator are kept apart
    (DLRM's rows): the kernel's unpacked [capr, 128] run sums against its
    plain version; the packed layout is refused there."""
    ids, g, vocab, capr = compaction_case(name, 128, dtype)
    _check_xla_compaction(ids.to(cuda), g.to(cuda), vocab, capr)
    s_ids, order = kx.sort_ids(ids.to(cuda), vocab)
    with pytest.raises(ValueError, match="packed"):
        kx.compact_xla_rows(ids.to(cuda), s_ids, order, g.to(cuda), vocab,
                            capr, True)


def _bag_inputs(b, d, dev, hotness, seed=3):
    """A table and [B, K] ids of bags of `hotness` (a zero-width bag
    among them), pads, a fully padded row and an id past the table."""
    rng = np.random.default_rng(seed)
    v, k = 5000, sum(hotness)
    table = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    ids = np.minimum(rng.zipf(1.2, (b, k)) - 1, v - 1).astype(np.int32)
    ids[rng.random((b, k)) < 0.1] = -1
    ids[1] = -1
    ids[2, 0] = v + 5
    off = np.concatenate([[0], np.cumsum(hotness)]).astype(np.int32)
    return (torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(off).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(4096, 128), (777, 64), (300, 10),
                                 (64, 264)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_kernel_with_offsets_matches_plain(cuda, combiner, b, d):
    """K3 with column offsets (MLPerf DLRM's 26 bags, 214 ids a row, and a
    zero-width bag) against its plain version, in one launch; offsets
    [0, K] give the one-bag pool bit for bit; other offsets (a
    control) do not match."""
    from goctr_tpu_torch.parallel.dlrm import MLPERF_HOTNESS

    hot = MLPERF_HOTNESS[:5] + (0,) + MLPERF_HOTNESS[5:]
    table, ids, off = _bag_inputs(b, d, cuda, hot)
    before = k3.fused_gather_pool.launches
    got = k3.fused_gather_pool(table, ids, combiner, off)
    want = k3.fused_gather_pool_plain(table, ids, combiner, off)
    torch.cuda.synchronize()
    assert k3.fused_gather_pool.launches == before + 1
    assert tuple(got.shape) == (b, len(hot), d)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert not got[:, 5].any() and not got[1].any()
    torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                               atol=1e-6, rtol=1e-5)
    one = torch.tensor([0, ids.shape[1]], dtype=torch.int32, device=cuda)
    assert torch.equal(
        bits(k3.fused_gather_pool(table, ids, combiner, one)[:, 0]),
        bits(k3.fused_gather_pool(table, ids, combiner)))
    shifted = off.clone()
    shifted[1:-1] += 1
    other = k3.fused_gather_pool(table, ids, combiner, shifted)
    assert not torch.allclose(torch.nan_to_num(other),
                              torch.nan_to_num(want), atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(XLA_CELL_STREAMS))
def test_compact_xla_kernel_at_the_cells_shapes(cuda, cell):
    n_real, over = _check_xla_compaction(*_xla_cell_stream(cell, cuda))
    assert n_real > 100_000


def _rmw_inputs(v, d, group, n, dev, seed=7):
    """A packed (group 1) or grouped table with accumulators, n slots of
    which 1,500 real distinct ids (the last line among them) and the rest
    junk past the table, and lane-placed update rows (zero for junk).
    Lanes past the groups hold a sentinel in both, which the update must
    leave in the table and never read from the update rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    stride = d + 1
    table = torch.zeros(v, 128, device=dev)
    for grp in range(group):
        table[:, grp * stride:grp * stride + d] = 0.1 * torch.randn(
            v, d, generator=gen, device=dev)
        table[:, grp * stride + d] = torch.rand(v, generator=gen, device=dev)
    table[:, group * stride:] = 7.0
    real = torch.randperm(v - 1, generator=gen, device=dev)[:1499]
    real = torch.cat([real, torch.full((1,), v - 1, device=dev)])
    junk = v + 1 + torch.arange(n - 1500, device=dev)
    ids = torch.cat([real, junk])[torch.randperm(n, generator=gen,
                                                 device=dev)].int()
    upd = torch.zeros(n, 128, device=dev)
    for grp in range(group):
        g = 0.3 * torch.randn(n, d, generator=gen, device=dev)
        upd[:, grp * stride:grp * stride + d] = g
        upd[:, grp * stride + d] = (g * g).sum(1)
    upd[ids >= v] = 0.0
    upd[:, group * stride:] = -3.0
    return table, ids, upd


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-8, 0.0])
@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d,grouped", [(64, False), (16, False), (64, True),
                                       (30, True), (16, True)])
def test_rmw_kernels_match_plain(cuda, d, grouped, kind, eps):
    """K5 (packed rows) and K6 (grouped lines, G = 1, 4, 7): the same f32
    terms, each rounded on its own, as the plain version; rsqrtf and
    torch.rsqrt may differ, so rtol 1e-6, atol 1e-7 (a few ulps of the
    weights); untouched lines are unchanged bit for bit. At eps = 0 every
    lane stays finite (only weight lanes take the rsqrt)."""
    group = tro.group_size(d) if grouped else 1
    v, n = 5000, 4096
    table, ids, upd = _rmw_inputs(v, d, group, n, cuda)
    wrapper, plain = ((tro.apply_line_updates, tro.apply_line_updates_plain)
                      if grouped else
                      (tro.apply_row_updates, tro.apply_row_updates_plain))
    before = wrapper.launches
    got = wrapper(table.clone(), ids, upd, lr=0.25, d=d, kind=kind,
                  eps=eps, skip_ge=v)
    want = plain(table.clone(), ids, upd, lr=0.25, d=d, kind=kind, eps=eps,
                 skip_ge=v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert bool((got[:, group * (d + 1):] == 7.0).all())
    touched = torch.zeros(v, dtype=torch.bool, device=cuda)
    touched[ids[ids < v].long()] = True
    assert torch.equal(got[~touched], table[~touched])
    assert bool((got[touched] != table[touched]).any(1).all())
    # skip_ge below the table: ids in [skip_ge, V) are left as they are
    got = wrapper(table.clone(), ids, upd, lr=0.25, d=d, kind=kind,
                  eps=eps, skip_ge=v // 2)
    want = plain(table.clone(), ids, upd, lr=0.25, d=d, kind=kind, eps=eps,
                 skip_ge=v // 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[v // 2:], table[v // 2:])


def stage4_case(n, lines, skip_ge, share, layout, d, group, seed=0):
    """A table, an update stream and its rows shaped like one model
    shard's stage-4 stream of a (data, model) mesh (parallel/train.py),
    as numpy: (table [lines, 128], ids [n] int32, updates [n, 128]).
    `share` of the n slots carry real ids (distinct, sorted, in [0,
    skip_ge)). layout "shard 0": the real ids are the run ends of one
    stretch of sorted runs (~80% of its slots; the runs' other positions
    hold junk past the table), followed by the other shard's ids (a third
    of what is left: ids in [skip_ge, lines) where skip_ge < lines, else
    junk past the table) and the junk tail of stage 1's unused slots;
    "shard 1": the other shard's ids come first; "last tile": the real
    ids lie only in the stream's last 128 slots, its last four 32-slot
    chunks, which the kernel deals to the last tiles of four blocks.
    The table holds weights N(0, 0.1²) and accumulators U(0, 1) in each
    of the line's `group` (w | acc) groups of width d and 7.0 past them;
    the update rows (Σg | ‖Σg‖²) in each group, -3.0 past them, and zero
    at skipped slots (stage 4 zeroes them)."""
    rng = np.random.default_rng(seed)
    n_real = min(int(round(share * n)), skip_ge)
    real = np.sort(rng.choice(skip_ge, n_real, replace=False))
    ids = lines + 1 + np.arange(n)              # junk, past the table
    if layout == "last tile":
        pos = n - 1 - np.sort(rng.choice(min(n, 128), n_real,
                                         replace=False))[::-1]
    else:
        stretch = min(n, -(-n_real * 5 // 4))
        other = (n - stretch) // 3
        start = 0 if layout == "shard 0" else other
        pos = start + np.sort(rng.choice(stretch, n_real, replace=False))
        at = (np.arange(stretch, stretch + other) if layout == "shard 0"
              else np.arange(other))
        if skip_ge < lines:
            ids[at] = rng.integers(skip_ge, lines, at.size)
    ids[pos] = real
    stride = d + 1
    table = np.full((lines, 128), 7.0, np.float32)
    upd = np.full((n, 128), -3.0, np.float32)
    for grp in range(group):
        table[:, grp * stride:grp * stride + d] = rng.normal(0, 0.1,
                                                             (lines, d))
        table[:, grp * stride + d] = rng.random(lines)
        g = rng.normal(0, 0.3, (n, d))
        upd[:, grp * stride:grp * stride + d] = g
        upd[:, grp * stride + d] = (g * g).sum(1)
    upd[(ids < 0) | (ids >= skip_ge), :group * stride] = 0.0
    return table, ids.astype(np.int32), upd


def check_rmw(got, table, ids, want, skip_ge, group, d, exact):
    """The checks of a K5 / K6 result `got` against the plain version's
    `want` from the same table: bit for bit (exact) or within rtol 1e-6,
    atol 1e-7; every line not named by a real slot and every lane past the
    groups unchanged; every named line changed."""
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    touched = torch.zeros(table.shape[0], dtype=torch.bool,
                          device=table.device)
    touched[ids[(ids >= 0) & (ids < skip_ge)].long()] = True
    assert torch.equal(got[~touched], table[~touched])
    assert bool((got[touched] != table[touched]).any(1).all())
    assert bool((got[:, group * (d + 1):] == 7.0).all())


# (layout, real share, skip_ge as a share of the lines, slots): stage-4
# streams at the shares the mesh gives (~12%), the scanned trainer's
# (~50-100%) and none; real slots only in the stream's last chunks; n not
# a multiple of a block's 1,024-slot tile or of a 32-slot chunk; skip_ge
# below the lines (the ids between are skipped) and skip_ge = 0 (every id
# is skipped). The kernel's grid holds at most the blocks the card keeps
# resident, and each block works through its tiles in turn: the streams
# of LONG_STREAM slots and more give every block more than one tile
# (the next tile's ids loaded while this one's rows are updated), as the
# mesh's 2,162,688-slot streams do; the shorter ones give each one tile.
LONG_STREAM = 2_162_688
STAGE4_STREAMS = [("shard 0", 0.0, 1.0, 50_021),
                  ("shard 0", 0.12, 1.0, 50_021),
                  ("shard 1", 0.12, 1.0, 50_021),
                  ("shard 0", 0.5, 1.0, 50_021),
                  ("shard 0", 1.0, 1.0, 50_021),
                  ("last tile", 100 / 50_021, 1.0, 50_021),
                  ("shard 1", 0.12, 0.9, 50_021),
                  ("shard 0", 0.12, 0.0, 50_021),
                  ("shard 1", 0.5, 1.0, 97),
                  ("shard 0", 0.12, 1.0, LONG_STREAM),
                  ("last tile", 100 / (LONG_STREAM + 37), 1.0,
                   LONG_STREAM + 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,eps", [("sgd", 1e-8), ("adagrad", 1e-8),
                                      ("adagrad", 0.0)])
@pytest.mark.parametrize("d,grouped", [(64, False), (16, True)],
                         ids=["K5", "K6"])
@pytest.mark.parametrize("layout,share,skip,n", STAGE4_STREAMS)
def test_rmw_kernels_on_stage4_streams(cuda, d, grouped, kind, eps, layout,
                                       share, skip, n):
    """K5 (packed rows, d = 64) and K6 (grouped lines, d = 16, G = 7) on
    stage-4-shaped streams against their plain versions: bit for bit
    under sgd; under adagrad only rsqrtf and torch.rsqrt may differ (rtol
    1e-6, atol 1e-7). Lines past skip_ge or not named are unchanged. The
    control, one real row's line written one line on, fails the check."""
    group = tro.group_size(d) if grouped else 1
    if n >= LONG_STREAM:
        # more slots than 32 chunks of 32 for each block the card can
        # hold (an SM holds at most 2,048 threads: 8 blocks of 256)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert n > 32 * 32 * 8 * sms
    lines = max(60_000, n // 4)
    skip_ge = int(skip * lines)
    table, ids, upd = (torch.from_numpy(a).to(cuda) for a in stage4_case(
        n, lines, skip_ge, share, layout, d, group, seed=n + d))
    wrapper, plain = ((tro.apply_line_updates, tro.apply_line_updates_plain)
                      if grouped else
                      (tro.apply_row_updates, tro.apply_row_updates_plain))
    kw = dict(lr=0.25, d=d, kind=kind, eps=eps, skip_ge=skip_ge)
    before = wrapper.launches
    got = wrapper(table.clone(), ids, upd, **kw)
    want = plain(table.clone(), ids, upd, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert bool(torch.isfinite(got).all())
    exact = kind == "sgd"
    check_rmw(got, table, ids, want, skip_ge, group, d, exact)
    real = ids[(ids >= 0) & (ids < skip_ge)].long()
    if real.numel() == 0:
        return
    # the control: the last real row's new line written one line on
    named = torch.zeros(lines + 1, dtype=torch.bool, device=cuda)
    named[real] = True
    r = int(real[(real + 1 < lines) & ~named[real + 1]][-1])
    moved = got.clone()
    moved[r + 1], moved[r] = got[r], table[r]
    with pytest.raises(AssertionError):
        check_rmw(moved, table, ids, want, skip_ge, group, d, exact)


def _dyadic_stream(vocab, d, dev, n=8192, hot=3000, n_pad=300, seed=8):
    """A sorted stream with a hot run of `hot` rows (id 7: it crosses many
    128-row tiles and the 1024 boundaries), many short runs, some across
    a 1024 boundary, and n_pad pads (id = vocab) last; gradient rows on a
    dyadic grid (zero for pads), a packed table whose accumulators are
    multiples of 1/64 and whose padding lanes hold a sentinel."""
    rng = np.random.default_rng(seed + d)
    ids = np.concatenate([np.full(hot, 7),
                          rng.integers(0, vocab, n - hot - n_pad)])
    ids = np.concatenate([np.sort(ids), np.full(n_pad, vocab)])
    g = (rng.integers(-4, 5, (n, d)) / 16).astype(np.float32)
    g[n - n_pad:] = 0.0
    table = np.zeros((vocab, 128), np.float32)
    table[:, :d] = rng.normal(0, 0.1, (vocab, d))
    table[:, d] = rng.integers(1, 65, vocab) / 64
    table[:, d + 1:] = 7.0
    return (torch.from_numpy(table).to(dev),
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(g).to(dev))


# (n, hot run): the short stream; a long one (n = 49·1024: its last carry
# group of 128 tiles is partial) whose hot run of 40,000 rows crosses
# three carry groups
SORTED_STREAMS = [(8192, 3000), (50176, 40000)]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-8, 0.0])
@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [8, 16, 64, 127])
@pytest.mark.parametrize("which", ["K7", "K8"])
@pytest.mark.parametrize("n,hot", SORTED_STREAMS)
def test_sorted_stream_kernels_match_plain(cuda, which, d, kind, eps, n,
                                           hot):
    """K7 (on the stream's cumsum rows) and K8 (on its rows) against
    their plain versions, with skip_ge = V and with skip_ge = V // 2 (ids
    in [skip_ge, V) are skipped too); see the module docstring for the
    tolerance."""
    vocab = 3000
    table, s_ids, g = _dyadic_stream(vocab, d, cuda, n=n, hot=hot)
    if which == "K7":
        wrapper, plain = tro.apply_csum_updates, tro.apply_csum_updates_plain
        rows = _cumsum_rows(g)
    else:
        wrapper, plain = k8.apply_run_updates, k8.apply_run_updates_plain
        rows = g
    for skip_ge in (vocab, vocab // 2):
        kw = dict(lr=0.25, d=d, kind=kind, eps=eps, skip_ge=skip_ge)
        before = wrapper.launches
        got = wrapper(table.clone(), s_ids, rows, **kw)
        want = plain(table.clone(), s_ids, rows, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        assert bool((got[:, d + 1:] == 7.0).all())
        touched = torch.zeros(vocab, dtype=torch.bool, device=cuda)
        touched[s_ids[s_ids < skip_ge].long()] = True
        assert torch.equal(got[~touched], table[~touched])
        assert bool((got[touched] != table[touched]).any(1).all())
        # the same call repeats bit for bit (no float atomics)
        assert torch.equal(wrapper(table.clone(), s_ids, rows, **kw), got)


@pytest.mark.cuda
def test_sorted_stream_kernels_refuse_bad_inputs(cuda):
    table = torch.zeros(4096, 128, device=cuda)
    s_ids = torch.arange(1024, dtype=torch.int32, device=cuda)
    rows = torch.zeros(1024, 16, device=cuda)
    alias = table.view(-1)[:1024 * 16].view(1024, 16)
    for wrapper, cap in ((tro.apply_csum_updates, 2 ** 30 - 2),
                         (k8.apply_run_updates, 2 ** 29 - 2)):
        before = wrapper.launches
        with pytest.raises(ValueError, match="alias"):
            wrapper(table, s_ids, alias, lr=0.1, d=16)
        with pytest.raises(ValueError, match="id cap"):
            wrapper(table, s_ids, rows, lr=0.1, d=16, skip_ge=cap + 1)
        with pytest.raises(ValueError, match="multiple of 1024"):
            wrapper(table, s_ids[:1000], rows[:1000], lr=0.1, d=16)
        with pytest.raises(ValueError, match="0 < d"):
            wrapper(table, s_ids, torch.zeros(1024, 128, device=cuda),
                    lr=0.1, d=128)
        assert wrapper.launches == before


@pytest.mark.cuda
def test_scatter_add_rows_order_is_fixed(cuda):
    """The unpacked update modes' scatter on the card: repeated ids add in
    the order they come, so the batch's stream and its stable sort (the
    plain and sorted modes) give the same bits, run after run."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    ids = torch.randint(-1, 500, (200_000,), generator=gen, device=cuda)
    ids[:60_000] = 7                                     # a hot id
    ids = ids[torch.randperm(ids.numel(), generator=gen, device=cuda)]
    rows = torch.randn(ids.numel(), 64, generator=gen, device=cuda)
    table = torch.randn(500, 64, generator=gen, device=cuda)
    order = torch.sort(ids, stable=True).indices
    got = scatter_add_rows(table.clone(), ids, rows)
    for _ in range(2):
        assert torch.equal(scatter_add_rows(table.clone(), ids[order],
                                            rows[order]), got)
        assert torch.equal(scatter_add_rows(table.clone(), ids, rows), got)
    acc = torch.rand(500, generator=gen, device=cuda)
    sq = (rows * rows).sum(1)[:, None]
    want = scatter_add_rows(acc.clone()[:, None], ids, sq)
    assert torch.equal(scatter_add_rows(acc.clone()[:, None], ids[order],
                                        sq[order]), want)


@pytest.mark.cuda
def test_streaming_trainer_on_the_card(cuda):
    """The streaming trainer's pinned buffers and side-stream copies: on
    the card, two chunks (the second ragged) train as on the CPU (f32 sums
    in other orders: loss curves within rtol 1e-5), and one chunk as the
    resident trainer on the card (the same arithmetic; cuBLAS may take
    another kernel for the chunk buffer's row stride: rtol 1e-6)."""
    from goctr_tpu_torch.models import MLPTower, SampleInfo, TrainSample
    from goctr_tpu_torch.models.base import param_leaves
    from goctr_tpu_torch.models.streaming import train_ranker_streaming
    from goctr_tpu_torch.models.trainer import (
        TrainedRanker, TrainerConfig, train_ranker)

    rng = np.random.default_rng(3)
    x = rng.random((2500, 10)).astype(np.float32)
    y = (x[:, 0] > x[:, 1]).astype(np.float32)
    sample = TrainSample(x=x, y=y, info=SampleInfo((0, 10), (10, 10),
                                                   (10, 10), (10, 10)))
    cfg = TrainerConfig(batch_size=128, epochs=3, early_stop=0,
                        shuffle=False, lr=5e-3)
    p0 = MLPTower(in_dim=10, hidden=(8,)).init_params(
        torch.Generator().manual_seed(0))

    class Fixed(MLPTower):
        def init_params(self, generator):
            return {k: [t.to(generator.device, copy=True) for t in v]
                    for k, v in p0.items()}

    runs = {d: train_ranker_streaming(Fixed(in_dim=10, hidden=(8,)), sample,
                                      cfg, chunk_rows=2048, device=d)
            for d in ("cpu", cuda)}
    np.testing.assert_allclose(runs[cuda].loss_curve, runs["cpu"].loss_curve,
                               rtol=1e-5)
    one = train_ranker_streaming(Fixed(in_dim=10, hidden=(8,)), sample, cfg,
                                 chunk_rows=2560, device=cuda)
    res = train_ranker(Fixed(in_dim=10, hidden=(8,)), sample, cfg,
                       resume_from=TrainedRanker(
                           model=MLPTower(in_dim=10, hidden=(8,)),
                           params=p0, info=sample.info, behavior_len=0,
                           loss_curve=[]), device=cuda)
    np.testing.assert_allclose(one.loss_curve, res.loss_curve, rtol=1e-6)
    for a, b in zip(param_leaves(one.params), param_leaves(res.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _same_draws_w2v(source):
    """A Word2Vec whose draws come from a generator on `source` and are
    moved to the model's device: the card and the CPU train on the same
    draws."""
    from goctr_tpu_torch.embedding.word2vec import EpochDraws, Word2Vec

    class SameDraws(Word2Vec):
        def _draws(self, gen, it, chunk, n):
            dev = torch.device(self.device)
            g = torch.Generator(device=source).manual_seed(
                self.opts.seed * 1000 + it)
            d = Word2Vec._draws(self, g, it, chunk, n)
            neg = d.negatives
            return EpochDraws(d.uniform.to(dev), d.radius.to(dev),
                              None if neg is None else
                              (lambda b: neg(b).to(dev)))
    return SameDraws


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["skipgram", "cbow"])
@pytest.mark.parametrize("opt", ["hs", "ns"])
def test_word2vec_on_the_card_matches_the_cpu(cuda, model, opt):
    """The item2vec epoch (no kernel: torch gathers, bmm, index_add_) on
    the card and on the CPU from the same draws: index_add_'s atomics and
    cuBLAS sum in other orders — tables within atol 1e-5, rtol 1e-4 after
    2 iterations, pair counts equal."""
    rng = np.random.default_rng(11)
    docs = [[f"w{c * 30 + i}" for i in rng.integers(0, 30, rng.integers(
        3, 60))] for c in rng.integers(0, 5, 500)]
    kw = dict(dim=16, window=5, iters=2, min_count=1, batch_size=2048,
              seed=2, model=model, optimizer=opt)
    cls = _same_draws_w2v("cpu")
    c = cls(**kw, device="cpu").train(docs)
    g = cls(**kw, device=cuda).train(docs)
    assert g.words_trained == c.words_trained
    np.testing.assert_allclose(g.w_in, c.w_in, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(g.w_out, c.w_out, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_searcher_on_the_card_matches_the_cpu(cuda):
    """One f32 product each (TF32 off): similarities within 1e-6, the
    same words in the same order (ties in index order on both)."""
    from goctr_tpu_torch.embedding.search import Searcher

    rng = np.random.default_rng(12)
    emb = {f"i{k}": rng.normal(size=16).astype(np.float32)
           for k in range(2000)}
    q = rng.normal(size=(64, 16)).astype(np.float32)
    for a, b in zip(Searcher(emb, device="cpu").search_vec(q, 10),
                    Searcher(emb, device=cuda).search_vec(q, 10)):
        assert [w for w, _ in a] == [w for w, _ in b]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a],
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["adam", "sgd", "lbfgs", "bfgs", "cg"])
def test_mlp_classifier_on_the_card_matches_the_cpu(cuda, solver):
    """From the same parameters, f32 sums in other orders: loss curves
    within rtol 1e-5 (lbfgs: its first 4 iterations; its zoom line search
    branches on f32 comparisons), parameters within atol 1e-5, rtol 1e-4
    (not lbfgs)."""
    from goctr_tpu_torch.models.mlp_classifier import MLPClassifier

    rng = np.random.default_rng(13)
    X = rng.normal(size=(700, 9)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 1).astype(np.int64)
    kw = dict(hidden_layer_sizes=(12, 6), solver=solver, batch_size=64,
              max_iter=6, shuffle=False, tol=0.0, learning_rate_init=0.01)
    init = MLPClassifier(**kw, device="cpu").init_params(9, 1)
    c = MLPClassifier(**kw, device="cpu").fit(X, y, init=init)
    g = MLPClassifier(**kw, device=cuda).fit(X, y, init=init)
    n = 4 if solver == "lbfgs" else None
    np.testing.assert_allclose(g.loss_curve_[:n], c.loss_curve_[:n],
                               rtol=1e-5)
    if n is None:
        for a, b in zip(g.coefs_ + g.intercepts_, c.coefs_ + c.intercepts_):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_neural_on_the_card_matches_the_cpu(cuda):
    from goctr_tpu_torch.models.neural import Neural, NeuralConfig

    rng = np.random.default_rng(14)
    X = rng.random((600, 8)).astype(np.float32)
    y = X[:, :1] * X[:, 1:2]
    cfg = NeuralConfig(inputs=8, layout=(10, 1), activation="sigmoid",
                       loss="mse")
    nets = [Neural(cfg, seed=1, device=d) for d in ("cpu", cuda)]
    curves = [n.train(X, y, lr=0.1, epochs=2, batch_size=50, seed=3)
              for n in nets]
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5)
    np.testing.assert_allclose(nets[1].predict(X), nets[0].predict(X),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [(1, 2), (2, 1)])
def test_mesh_step_on_shared_card_matches_1x1(cuda, spec):
    """Two ranks share the card over gloo (the collectives staged through
    pinned host memory) and run one sparse step, fused with the one-pass
    row update (K5) at D = 64, from the same start as the 1×1 step on the
    card: every array within atol 1e-6 (on one data shard the stream is
    the 1×1 stream; on two, its row sums add in another order)."""
    from goctr_tpu_torch.core.meshes import launch, single_device_mesh
    from goctr_tpu_torch.parallel.mesh_cases import rank_cases, run_case
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    v, t, n = 512, 5, 256
    mc = dict(item_vocab=v, emb_dim=64, u_profile_dim=4, ctx_dim=2,
              behavior_len=t, hidden=(16,))
    rng = np.random.default_rng(5)
    model = SparseCTR(**mc, device="cpu")
    table = model.init_params(torch.Generator().manual_seed(5))
    case = dict(kind="sparse_steps", model=mc, lr=1e-3,
                dense={k: x.numpy() for k, x in model.state_dict().items()},
                table=table.numpy(), table_opt=dict(
                    kind="adagrad", lr=0.05, update_mode="fused",
                    rmw_impl="kernel"),
                batches=[dict(
                    user_profile=rng.random((n, 4)).astype(np.float32),
                    behavior_ids=rng.integers(-1, v, (n, t)).astype(np.int32),
                    item_ids=rng.integers(0, v, n).astype(np.int32),
                    ctx=rng.random((n, 2)).astype(np.float32),
                    labels=(rng.random(n) > 0.5).astype(np.float32))])
    want = run_case(case, single_device_mesh(cuda))["steps"][0]
    got = launch(rank_cases, 2, ["cuda:0"] * 2, "gloo",
                 args=(["cuda:0"] * 2, [(spec, [case])]), timeout=300)
    for rank in got:
        step = rank[0][0]["steps"][0]
        assert step["overflow"] == want["overflow"] == 0
        np.testing.assert_allclose(step["loss"], want["loss"], rtol=0,
                                   atol=1e-6)
        for key in ("table", "acc"):
            np.testing.assert_allclose(step[key], want[key], rtol=0,
                                       atol=1e-6)
        for k, x in want["dense"].items():
            np.testing.assert_allclose(step["dense"][k], x, rtol=0,
                                       atol=1e-6)


@pytest.mark.cuda
def test_randn_rows_on_the_card_equal_the_whole_draw(cuda):
    """A shard's rows of a CUDA randn drawn alone equal the whole draw's
    rows, and leave the generator where the whole draw does: draws under
    one grid stride, over it, and past 2^31 bytes (cut into halves)."""
    from goctr_tpu_torch.core.prng import randn_rows

    for shape, ranges in (((1000, 128), [(100, 700), (999, 1000)]),
                          ((100_000, 64), [(30_000, 70_000), (0, 5)]),
                          ((4_500_000, 128), [(2_200_000, 2_300_000),
                                              (0, 100)])):
        gen = torch.Generator(device=cuda).manual_seed(7)
        whole = torch.randn(shape, generator=gen, device=cuda)
        end = gen.get_offset()
        for a, b in ranges:
            g = torch.Generator(device=cuda).manual_seed(7)
            assert torch.equal(randn_rows(g, shape, a, b), whole[a:b])
            assert g.get_offset() == end
        del whole


# ------------------------------------------- steps that never wait (C.5) --
def mask_scatter_add_rows(table, ids, rows):
    """scatter_add_rows as it was: the dropped ids cut by a boolean mask
    (a nonzero: the host waits for its size)."""
    keep = (ids >= 0) & (ids < table.shape[0])
    ids, rows = ids[keep].long(), rows[keep]
    return table.index_put_((ids,), rows, accumulate=True)


def mask_dedup_flat(flat, cap):
    """_dedup_flat as it was: slots past the cap cut by a boolean mask."""
    s, order = torch.sort(flat, stable=True)
    new = torch.cat([torch.ones(1, dtype=torch.bool, device=flat.device),
                     s[1:] != s[:-1]])
    slot_sorted = torch.cumsum(new, 0) - 1
    keep = slot_sorted < cap
    uniq = flat.new_full((cap,), -1)
    uniq[slot_sorted[keep]] = s[keep]
    inv = torch.empty_like(slot_sorted)
    inv[order] = slot_sorted
    return uniq, inv, slot_sorted[-1] + 1


class no_waits:
    """torch.cuda.set_sync_debug_mode("error") for a block: any operation
    that makes the host wait on the card raises."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def bits(x):
    return x.contiguous().view(torch.int32)


SYNC_MODEL = dict(item_vocab=50_000, emb_dim=64, u_profile_dim=8, ctx_dim=4,
                  behavior_len=8, hidden=(64, 32), activation="relu")
SYNC_RANKER = dict(u_profile_dim=8, behavior_len=4, behavior_dim=16,
                   i_feature_dim=16, c_feature_dim=5)
SYNC_DLRM = dict(hotness=(3, 2, 100, 1), rows=(50_000, 10, 20_000, 3),
                 bottom=(64, 128), cross_layers=2, cross_rank=32,
                 top=(64, 32))
SYNC_CASES = dict(step_cases("cuda", SYNC_MODEL, dict(SYNC_MODEL, emb_dim=16),
                             SYNC_RANKER, 4096, dlrm=SYNC_DLRM))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SYNC_CASES))
def test_step_never_waits_on_the_card(cuda, name):
    """One step of each path that promises not to wait (the kernels on
    their paths included) raises nothing under the sync debug mode after
    its first call, which builds the kernels."""
    step = SYNC_CASES[name]()
    step()
    with no_waits():
        step()


@pytest.mark.cuda
def test_sync_guard_catches_the_mask(cuda):
    """Control: the masked scatter this replaced raises under the guard."""
    table = torch.zeros(10, 4, device=cuda)
    ids = torch.arange(-3, 12, device=cuda)
    with no_waits(), pytest.raises(RuntimeError, match="synchroniz"):
        mask_scatter_add_rows(table, ids, torch.ones(15, 4, device=cuda))


def _card_stream(kind, gen, v, n, cuda):
    """Scatter streams as the trainers give them: ids below 0 and past v
    among in-range ids with a hot id (plain order); -1 pads first, then
    ascending (the sorted mode); distinct ascending ids and most slots
    past the shard (the mesh's stage 4); a few ids of a large table."""
    if kind == "interleaved":
        ids = torch.randint(-3, v + 3, (n,), generator=gen, device=cuda)
        ids[torch.rand(n, generator=gen, device=cuda) < 0.3] = 7
    elif kind == "pads first":
        ids = torch.randint(0, v, (n,), generator=gen, device=cuda)
        ids[torch.rand(n, generator=gen, device=cuda) < 0.25] = -1
        ids = torch.sort(ids).values
    elif kind == "stage 4":
        real = torch.sort(torch.randperm(v, generator=gen, device=cuda)[
            :n // 8]).values
        ids = torch.cat([real, v + 1 + torch.arange(n - real.numel(),
                                                    device=cuda)])
    else:
        ids = torch.randint(-v // 4, v, (n,), generator=gen, device=cuda)
    return ids.int()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 16, 64])
@pytest.mark.parametrize("kind,v,n", [("interleaved", 500, 200_000),
                                      ("pads first", 500, 200_000),
                                      ("stage 4", 400_000, 200_000),
                                      ("sparse", 1_000_000, 100_000)])
def test_scatter_add_rows_equals_the_mask_on_the_card(cuda, kind, v, n, d):
    """Bit for bit the masked scatter on the same inputs, NaN and Inf rows
    at the dropped ids, +0.0 / -0.0 in the table and ids whose kept rows
    are all -0.0; and no wait."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    ids = _card_stream(kind, gen, v, n, cuda)
    dropped = (ids < 0) | (ids >= v)
    rows = torch.randn(n, d, generator=gen, device=cuda)
    rows[ids % 5 == 0] = -0.0           # ids whose sums stay -0.0
    junk = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30],
                        device=cuda)
    rows[dropped] = junk[torch.randint(0, 4, (int(dropped.sum()), d),
                                       generator=gen, device=cuda)]
    table = torch.randn(v, d, generator=gen, device=cuda)
    zero = torch.rand(v, d, generator=gen, device=cuda)
    table[zero < 0.1] = 0.0
    table[zero > 0.9] = -0.0
    want = mask_scatter_add_rows(table.clone(), ids, rows)
    got = table.clone()
    with no_waits():
        scatter_add_rows(got, ids, rows)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1024, 4095, 4096, 20_000])
def test_dedup_flat_equals_the_mask_on_the_card(cuda, cap):
    """4,096 unique ids (-1 among them) in 100,000: caps below, one below,
    at and above the unique count; equal to the masked version, no wait."""
    gen = torch.Generator(device=cuda).manual_seed(cap)
    flat = torch.cat([torch.arange(-1, 4095, device=cuda),
                      torch.randint(-1, 4095, (100_000 - 4096,),
                                    generator=gen, device=cuda)])
    flat = flat[torch.randperm(flat.numel(), generator=gen,
                               device=cuda)].int()
    want = mask_dedup_flat(flat, cap)
    with no_waits():
        got = _dedup_flat(flat, cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


HEADLINE = dict(item_vocab=10_000_000, emb_dim=64, u_profile_dim=48,
                ctx_dim=16, behavior_len=32, hidden=(1024, 512, 256),
                activation="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dedup", "sorted", "plain"])
def test_headline_epoch_equals_the_mask_scatter(cuda, mode, monkeypatch):
    """One scanned epoch at the headline's widths and batch (4 steps of
    65,536 rows, a quarter of the behaviors -1): loss, table and
    accumulator bit for bit those of the masked scatter, swapped in."""
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel import scanned
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

    sample = SparseSample(**sample_arrays(HEADLINE, 4 * 65_536, seed=1))
    cfg = TrainerConfig(batch_size=65_536, epochs=1, early_stop=0,
                        shuffle=True, seed=0)
    topt = scanned.TableOptConfig(kind="adagrad", lr=2.0, update_mode=mode)

    def run():
        model = SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16,
                          device=cuda)
        r = scanned.train_sparse_scanned(model, sample, cfg, topt,
                                         device=cuda)
        return r.loss_curve, bits(r.table).cpu(), bits(r.acc).cpu()

    got = run()
    monkeypatch.setattr(scanned, "scatter_add_rows", mask_scatter_add_rows)
    want = run()
    assert got[0] == want[0]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
