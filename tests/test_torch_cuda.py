"""Each CUDA kernel of the port against its plain PyTorch version, on a
card. Skipped without one: a CUDA kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (tests/conftest.py imports JAX; skip it there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: K1 is a copy plus a round-to-nearest-even cast — bit exact.
K2 sums in f32 in another order than the plain version — atol 1e-6,
rtol 1e-5 in f32; in bf16 both round an f32 value that agrees to a few
f32 ulps, so they agree to one bf16 ulp — rtol 2^-7. K2b likewise on
d_behaviors and d_item; its d_att0 sums B rows in another order (atol
1e-5, rtol 1e-5). K4 is a copy — bit exact on every touched row, and
every other row unchanged. K9 returns the same targets and overflow;
its run sums add the same f32 rows in another order, so each lies within
1e-5 of the run's sum of |g| (plus 1e-6). K5 and K6 round each term as
the plain version does; only rsqrtf may differ from torch.rsqrt — rtol
1e-6, atol 1e-7, and untouched lines bit exact. K7 and K8 take gradient
rows on a dyadic grid (multiples of 1/16, |g| <= 1/4) and accumulators
that are multiples of 1/64, so every run sum, cumsum and ‖Σg‖² is exact
in f32 whatever the order of its adds: K8's sums in tile order equal the
plain version's cumsum differences, and only rsqrtf may differ — the
same rtol 1e-6, atol 1e-7, untouched lines bit exact. K3 sums the same
f32 rows in another order than its plain version (atol 1e-6, rtol 1e-5);
ids past the table give NaN rows in both. Its backward is torch glue:
held to autograd through the plain pool in f64; index_add_'s f32 atomics
add a row's terms (up to ~2·10^4 for a hot id) in any order, so each
entry lies within 1e-4 of the sum of its terms' magnitudes (+1e-7).
"""
import numpy as np
import pytest
import torch

from goctr_tpu_torch.ops.kernels import compact as k9
from goctr_tpu_torch.ops.kernels import din_attention as k2
from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
from goctr_tpu_torch.ops.kernels import row_gather as k1
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.ops.kernels import run_optimizer as k8
from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.ops.segsum import _cumsum_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(512, 300, 64), (256, 32, 16),
                                   (64, 7, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_din_kernel_matches_plain(cuda, dtype, b, t, d):
    rng = np.random.default_rng(4)
    beh = torch.from_numpy(rng.normal(0, 1, (b, t, d)).astype(np.float32))
    beh[0, 3] = 0.0                                  # a zero behavior row
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


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["plain", "packed", "grouped"])
def test_gather_kernel_matches_plain(cuda, layout):
    w = torch.randn(1000, 16, device=cuda)
    table, group = {"plain": (w, 1),
                    "packed": (tro.pack_table(w), 1),
                    "grouped": (tro.pack_table_grouped(w), 7)}[layout]
    ids = torch.randint(-3, table.shape[0] * group + 3, (4097,),
                        dtype=torch.int32, device=cuda)
    before = k1.gather_rows.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        got = k1.gather_rows(table, ids, group=group, dim=16,
                             out_dtype=out_dtype)
        want = k1.gather_rows_plain(table, ids, group=group, dim=16,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
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
                                   (256, 7, 3), (256, 6, 10)])
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
    beh[0, 3] = 0.0                                  # a zero behavior row
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
                                   (37, 7, 200)])
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


def _sorted_stream(n, vocab, n_pad, dev, seed=6):
    """Sorted ids with a hot run across many tiles and groups (30,000
    rows of one id), many short runs, and n_pad pads (id = vocab) last."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(30000, 7), rng.integers(0, vocab,
                                                          n - 30000 - n_pad)])
    ids = np.concatenate([np.sort(ids), np.full(n_pad, vocab)])
    g = rng.normal(0, 1, (n, 64)).astype(np.float32)
    g[n - n_pad:] = 0.0
    return (torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(g).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("capr", [4096, 1024])           # fits, overflows
def test_compact_kernel_matches_plain(cuda, capr):
    vocab = 3000
    s_ids, g = _sorted_stream(70656, vocab, 1000, cuda)
    before = k9.compact_runsums_block.launches
    tgt, rows, over = k9.compact_runsums_block(s_ids, g, vocab, capr)
    w_tgt, w_rows, w_over = k9.compact_runsums_plain(s_ids, g, vocab, capr)
    torch.cuda.synchronize()
    assert k9.compact_runsums_block.launches == before + 1
    assert torch.equal(tgt, w_tgt) and int(over) == int(w_over)
    assert (int(over) > 0) == (capr == 1024)
    _, abs_rows, _ = k9.compact_runsums_plain(s_ids, g.abs(), vocab, capr)
    limit = 1e-5 * abs_rows[:, :64] + 1e-6
    assert bool(((rows[:, :64] - w_rows[:, :64]).abs() <= limit).all())
    torch.testing.assert_close(rows[:, 64], w_rows[:, 64], rtol=1e-4,
                               atol=1e-4)
    assert bool((rows[:, 65:] == 0).all())
    again = k9.compact_runsums_block(s_ids, g, vocab, capr)
    assert torch.equal(again[1], rows)


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


def _dyadic_stream(vocab, d, dev, n=8192, n_pad=300, seed=8):
    """A sorted stream with a hot run of 3,000 rows (id 7: it crosses many
    128-row tiles and the 1024 boundaries), many short runs, some across
    a 1024 boundary, and n_pad pads (id = vocab) last; gradient rows on a
    dyadic grid (zero for pads), a packed table whose accumulators are
    multiples of 1/64 and whose padding lanes hold a sentinel."""
    rng = np.random.default_rng(seed + d)
    ids = np.concatenate([np.full(3000, 7),
                          rng.integers(0, vocab, n - 3000 - n_pad)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-8, 0.0])
@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [8, 16, 64, 127])
@pytest.mark.parametrize("which", ["K7", "K8"])
def test_sorted_stream_kernels_match_plain(cuda, which, d, kind, eps):
    """K7 (on the stream's cumsum rows) and K8 (on its rows) against
    their plain versions, with skip_ge = V and with skip_ge = V // 2 (ids
    in [skip_ge, V) are skipped too); see the module docstring for the
    tolerance."""
    vocab = 3000
    table, s_ids, g = _dyadic_stream(vocab, d, cuda)
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
