"""The port's kernels K1 (row gather) and K2 (DIN attention pool): their
plain versions against the JAX package on the CPU, and the wrappers' CPU
routing and checks (tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on a card).

Tolerances:
  * K2 f32 vs JAX f32 (Pallas interpret mode and the jnp path): the same
    f32 formula summed in another order — atol 1e-6, rtol 1e-5.
  * K2 bf16 vs the JAX jnp path at f32 on the same bf16 inputs: the port
    computes in f32 and rounds once, so it is within one bf16 ulp —
    rtol 2^-7 (8e-3), atol 1e-6.
  * K2 bf16 vs the JAX jnp path at bf16: JAX rounds every intermediate to
    bf16 (products, the cosine, the gate, the T-sum), the port none; the
    results differ by a few bf16 ulps — atol 4e-3, rtol 2e-2. (The Pallas
    kernel itself does not take bf16 inputs in interpret mode: it stores
    its f32 accumulator into the bf16 output without a cast.)
  * K1: a copy and a round-to-nearest-even cast — bit exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.ops.pallas.din_attention import (
    din_attention_pool_jnp, din_attention_pool_pallas,
)
from goctr_tpu.ops.pallas.row_gather import gather_rows_packed
from goctr_tpu.ops.pallas.row_optimizer import pack_table_grouped
from goctr_tpu_torch.ops.kernels import din_attention as k2
from goctr_tpu_torch.ops.kernels import row_gather as k1
from goctr_tpu_torch.ops.kernels import row_optimizer as tro


def _din_inputs(b, t, d, seed=0):
    rng = np.random.default_rng(seed)
    beh = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    beh[0, 3] = 0.0                          # a zero behavior row
    item = rng.normal(0, 1, (b, d)).astype(np.float32)
    att0 = rng.normal(1, 0.3, t).astype(np.float32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    mask[1] = 0.0                            # an all-masked row
    return beh, item, att0, mask


def _port_din(beh, item, att0, mask, dtype):
    return k2.din_attention_pool(
        torch.from_numpy(beh).to(dtype), torch.from_numpy(item).to(dtype),
        torch.from_numpy(att0), torch.from_numpy(mask))


# (16, 300, 16): T not a multiple of the Pallas BLOCK_T (ragged tail) and
# three T tiles; (8, 32, 64): the headline T and D; (4, 6, 264): wider
# than the 256 the port's kernels once took
SHAPES = [(16, 300, 16), (8, 32, 64), (4, 6, 264)]


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_din_pool_f32_matches_pallas_and_jnp(b, t, d):
    beh, item, att0, mask = _din_inputs(b, t, d)
    got = _port_din(beh, item, att0, mask, torch.float32).numpy()
    args = [jnp.asarray(x) for x in (beh, item, att0, mask)]
    for want in (din_attention_pool_pallas(*args, interpret=True),
                 din_attention_pool_jnp(*args)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6,
                                   rtol=1e-5)
    assert np.all(got[1] == 0.0)             # all-masked row pools to 0


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_din_pool_bf16_within_one_ulp_of_f32_math(b, t, d):
    beh, item, att0, mask = _din_inputs(b, t, d, seed=1)
    got = _port_din(beh, item, att0, mask, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jb = jnp.asarray(beh).astype(jnp.bfloat16)
    ji = jnp.asarray(item).astype(jnp.bfloat16)
    want_f32 = din_attention_pool_jnp(jb.astype(jnp.float32),
                                      ji.astype(jnp.float32),
                                      jnp.asarray(att0), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want_f32), atol=1e-6,
                               rtol=2.0 ** -7)
    want_bf16 = din_attention_pool_jnp(jb, ji,
                                       jnp.asarray(att0).astype(jnp.bfloat16),
                                       jnp.asarray(mask).astype(jnp.bfloat16))
    np.testing.assert_allclose(got, np.asarray(want_bf16, np.float32),
                               atol=4e-3, rtol=2e-2)


def test_din_pool_cpu_uses_plain_and_checks_inputs():
    beh, item, att0, mask = _din_inputs(4, 6, 8)
    before = k2.din_attention_pool.launches
    tb = torch.from_numpy(beh)
    out = k2.din_attention_pool(tb, torch.from_numpy(item),
                                torch.from_numpy(att0))   # mask=None: all 1
    want = k2.din_attention_pool_plain(tb, torch.from_numpy(item),
                                       torch.from_numpy(att0),
                                       torch.ones(4, 6))
    assert torch.equal(out, want)
    assert k2.din_attention_pool.launches == before     # plain: not counted
    with pytest.raises(ValueError, match="contiguous"):
        k2.din_attention_pool(tb.transpose(0, 1).contiguous().transpose(0, 1),
                              torch.from_numpy(item), torch.from_numpy(att0),
                              torch.from_numpy(mask))
    with pytest.raises(ValueError, match="mask"):
        k2.din_attention_pool(tb, torch.from_numpy(item),
                              torch.from_numpy(att0),
                              torch.from_numpy(mask).double())
    with pytest.raises(ValueError, match="item"):
        k2.din_attention_pool(tb, torch.from_numpy(item).bfloat16(),
                              torch.from_numpy(att0), torch.from_numpy(mask))


# ----------------------------------------------------------------- K1 --
def test_gather_matches_pallas_row_gather_interpret():
    rng = np.random.default_rng(2)
    v, n = 300, 2048
    table = rng.normal(size=(v, 128)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    want = np.asarray(gather_rows_packed(jnp.asarray(table), jnp.asarray(ids),
                                         interpret=True))
    got = k1.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # the packed layout's first D lanes
    got_d = k1.gather_rows(torch.from_numpy(table), torch.from_numpy(ids),
                           dim=64)
    np.testing.assert_array_equal(got_d.numpy(), want[:, :64])


def _jax_rows_of(table, ids, group, d, dtype):
    """The JAX scorer's rows_of (goctr_tpu/serve/scorer.py:88-99)."""
    table = jnp.asarray(table)
    ids = jnp.asarray(ids)
    if group > 1:
        lines = jnp.take(table, ids // group, axis=0)
        l3 = lines[..., :group * (d + 1)].reshape(ids.shape + (group, d + 1))
        oh = jax.nn.one_hot(ids % group, group, dtype=jnp.float32)
        return jnp.einsum("...g,...gd->...d", oh, l3)[..., :d].astype(dtype)
    return jnp.take(table, ids, axis=0)[..., :d].astype(dtype)


def _same_bits(got: torch.Tensor, want) -> None:
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy()
        w = np.asarray(want).view(np.int16)
    else:
        g = got.numpy().view(np.int32)
        w = np.asarray(want, np.float32).view(np.int32)
    nan_g = np.isnan(got.float().numpy())
    np.testing.assert_array_equal(nan_g, np.isnan(np.asarray(want,
                                                             np.float32)))
    np.testing.assert_array_equal(g[~nan_g], w[~nan_g])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["plain", "packed", "grouped"])
def test_gather_matches_jax_rows_of(layout, dtype):
    """All three layouts, bit exact, with ids at and past the end: JAX's
    jnp.take gives NaN rows for them, and so does K1. A grouped table's
    pad rows (vocab ≤ id < lines·G) read as zeros in both."""
    rng = np.random.default_rng(3)
    v, d = 61, 16
    w = rng.normal(size=(v, d)).astype(np.float32)
    if layout == "plain":
        table, group = w, 1
    elif layout == "packed":
        table, group = np.asarray(tro.pack_table(torch.from_numpy(w))), 1
    else:
        table, group = np.array(pack_table_grouped(jnp.asarray(w))), 7
    rows = table.shape[0] * group
    ids = np.concatenate([rng.integers(0, v, (3, 5)).reshape(-1),
                          [0, v - 1, v, rows - 1, rows, rows + 9, 2**31 - 1]]
                         ).astype(np.int32).reshape(2, 11)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = _jax_rows_of(table, ids, group, d, jdt)
    got = k1.gather_rows(torch.from_numpy(table), torch.from_numpy(ids),
                         group=group, dim=d, out_dtype=tdt)
    assert tuple(got.shape) == (2, 11, d) and got.dtype == tdt
    _same_bits(got, want)
    assert torch.isnan(got.reshape(-1, d)[-3:]).all()


def test_gather_negative_ids_give_nan_and_cpu_uses_plain():
    table = torch.randn(10, 4)
    before = k1.gather_rows.launches
    out = k1.gather_rows(table, torch.tensor([-1, 3, -5], dtype=torch.int32))
    assert torch.isnan(out[0]).all() and torch.isnan(out[2]).all()
    assert torch.equal(out[1], table[3])
    assert k1.gather_rows.launches == before
    with pytest.raises(ValueError, match="int32"):
        k1.gather_rows(table, torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="contiguous"):
        k1.gather_rows(table.t().contiguous().t(),
                       torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        k1.gather_rows(torch.zeros(5, 128), torch.tensor([1],
                                                         dtype=torch.int32),
                       group=8, dim=16)
