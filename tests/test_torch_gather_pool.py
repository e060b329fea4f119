"""K3 — the fused gather + pool — against the JAX package on the CPU: the
port's `fused_gather_pool` (its plain version runs here) against JAX's
`fused_gather_pool_pallas` in interpret mode and `fused_gather_pool_jnp`,
and `GatherPoolMean`'s gradient against `jax.grad` of `gather_pool_mean`,
on the same numpy inputs.

Tolerances rtol 1e-5, atol 1e-6, as tests/test_pallas_kernels.py:58-97
holds the Pallas kernel to its jnp version: both sum the same f32 rows
in other orders. The Pallas kernel is compared where it is defined: B a
multiple of 8 and ids inside the table (its row DMA clamps an id past
the table to the last row, where `jnp.take` gives NaN, which is what the
port follows); ragged B and ids >= V are held to the jnp version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.ops.pallas.embedding_lookup import (
    fused_gather_pool_jnp, fused_gather_pool_pallas, gather_pool_mean,
)
from goctr_tpu_torch.ops.kernels import embedding_lookup as k3

TOL = dict(rtol=1e-5, atol=1e-6)
V, D = 50, 16


def _inputs(b, k, seed=0, past_table=False, d=D):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (V, d)).astype(np.float32)
    ids = rng.integers(0, V, (b, k)).astype(np.int32)
    ids[rng.random((b, k)) < 0.3] = -1                    # pads
    ids[1] = -1                                           # a fully padded row
    if past_table:
        ids[2, 0] = V                                     # NaN rows
        ids[3, -1] = V + 7
    return table, ids


def _port(table, ids, combiner):
    out = k3.fused_gather_pool(torch.from_numpy(table), torch.from_numpy(ids),
                               combiner)
    assert out.dtype == torch.float32 and tuple(out.shape) == (
        ids.shape[0], table.shape[1])
    return out.numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("b,k", [(16, 8), (8, 1), (24, 5)])
def test_matches_pallas_and_jnp(combiner, b, k):
    table, ids = _inputs(b, k)
    got = _port(table, ids, combiner)
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    for want in (fused_gather_pool_pallas(jt, ji, combiner, interpret=True),
                 fused_gather_pool_jnp(jt, ji, combiner)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.all(got[1] == 0.0)                          # fully padded


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_wide_rows_match_jnp(combiner):
    """D = 264, wider than the 256 K3 once took (the jnp path is what JAX
    runs at a D the Pallas kernel's D % 128 gate refuses)."""
    table, ids = _inputs(13, 6, seed=3, past_table=True, d=264)
    got = _port(table, ids, combiner)
    want = fused_gather_pool_jnp(jnp.asarray(table), jnp.asarray(ids),
                                 combiner)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.all(np.isnan(got[2])) and np.all(got[1] == 0.0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("b,k,past_table", [(13, 6, False), (9, 1, False),
                                             (16, 8, True)])
def test_ragged_batch_and_ids_past_table_match_jnp(combiner, b, k,
                                                   past_table):
    table, ids = _inputs(b, k, seed=1, past_table=past_table)
    got = _port(table, ids, combiner)
    want = np.asarray(fused_gather_pool_jnp(jnp.asarray(table),
                                            jnp.asarray(ids), combiner))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)
    if past_table:
        assert np.isnan(got[2]).all() and np.isnan(got[3]).all()
        assert not np.isnan(np.delete(got, [2, 3], 0)).any()


@pytest.mark.parametrize("b,k,past_table", [(16, 8, False), (13, 1, False),
                                            (16, 8, True)])
def test_mean_gradient_matches_jax(b, k, past_table):
    """The closed-form backward: g / count at every valid id, ids past the
    table dropped (their NaN forward rows do not enter the gradient)."""
    table, ids = _inputs(b, k, seed=2, past_table=past_table)
    w = np.random.default_rng(3).normal(0, 1, (b, D)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(gather_pool_mean(t, jnp.asarray(ids))
                                      * jnp.asarray(w)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    pooled = k3.GatherPoolMean.apply(t, torch.from_numpy(ids))
    (got,) = torch.autograd.grad((pooled * torch.from_numpy(w)).sum(), t)
    assert tuple(got.shape) == (V, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_calls_plain_version_and_counts_no_launch():
    table, ids = _inputs(8, 4)
    before = k3.fused_gather_pool.launches
    got = k3.fused_gather_pool(torch.from_numpy(table), torch.from_numpy(ids),
                               "mean")
    want = k3.fused_gather_pool_plain(torch.from_numpy(table),
                                      torch.from_numpy(ids), "mean")
    assert torch.equal(got, want)
    assert k3.fused_gather_pool.launches == before


@pytest.mark.parametrize("table,ids,combiner,what", [
    (torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int32), "max",
     "combiner"),
    (torch.zeros(4, 8, dtype=torch.float64),
     torch.zeros(2, 3, dtype=torch.int32), "sum", "float32"),
    (torch.zeros(4, 0), torch.zeros(2, 3, dtype=torch.int32), "sum",
     "emb dim"),
    (torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int64), "sum",
     "int32"),
    (torch.zeros(4, 8), torch.zeros(6, dtype=torch.int32), "sum", "2-D"),
    (torch.zeros(8, 4).t(), torch.zeros(2, 3, dtype=torch.int32), "sum",
     "contiguous"),
    (torch.zeros(4, 8, device="meta"),
     torch.zeros(2, 3, dtype=torch.int32, device="meta"), "sum",
     "no gather_pool kernel"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(table, ids, combiner,
                                                       what):
    with pytest.raises(ValueError, match=what):
        k3.fused_gather_pool(table, ids, combiner)


# ids about half masked to -1, as each rank of a 2-shard model axis sees
# them: K across the 32-id chunk the kernel reads its ids in (31, 33) and
# two chunks (64). Row 1 is fully masked, row 4 has exactly one real id.
# Tolerance 1e-6: the table is N(0, 0.1²), so a pooled entry is below ~1
# and f32 reorderings of its adds move it by a few 1e-8.
HALF_TOL = dict(rtol=1e-6, atol=1e-6)
HALF_K = [31, 33, 64]


def _half_masked(k, seed=11, b=16, v=V, d=D, pads=0.5):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    ids[rng.random((b, k)) < pads] = -1
    ids[1] = -1                                           # fully masked
    ids[4] = -1
    ids[4, k // 2] = rng.integers(0, v)                   # one real id
    return table, ids


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("k", HALF_K)
def test_half_masked_ids_match_pallas_and_jnp(combiner, k):
    """The plain K3 and sharded_pooled_lookup on the 1×1 mesh against the
    Pallas kernel (interpret mode) and the jnp version."""
    from goctr_tpu_torch.core.meshes import single_device_mesh
    from goctr_tpu_torch.parallel.embedding import sharded_pooled_lookup

    table, ids = _half_masked(k)
    assert 0.4 < (ids >= 0).mean() < 0.6
    got = _port(table, ids, combiner)
    lookup = sharded_pooled_lookup(torch.from_numpy(table),
                                   torch.from_numpy(ids),
                                   single_device_mesh("cpu"),
                                   combiner).numpy()
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    for want in (fused_gather_pool_pallas(jt, ji, combiner, interpret=True),
                 fused_gather_pool_jnp(jt, ji, combiner)):
        np.testing.assert_allclose(got, np.asarray(want), **HALF_TOL)
        np.testing.assert_allclose(lookup, np.asarray(want), **HALF_TOL)
    assert np.all(got[1] == 0.0) and np.all(lookup[1] == 0.0)
    one = table[ids[4][ids[4] >= 0][0]]
    np.testing.assert_array_equal(got[4], one)            # one row, / 1


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("k", HALF_K)
def test_shard_masked_path_matches_jax(monkeypatch, combiner, k):
    """sharded_pooled_lookup's branch for a mesh above 1×1, rank by rank
    on a 1×2 mesh with the psum over `model` taken by the test: each
    rank's K3 "sum" of its shard's rows at `shard_local_ids` against the
    partial sum of JAX's shard_map body (:225-233) and against the Pallas
    kernel and the jnp version on the same masked ids; the partial sums
    summed against JAX's pool of the whole table."""
    from goctr_tpu_torch.core.meshes import Mesh
    from goctr_tpu_torch.parallel import embedding as emb

    m, v = 2, 2 * V
    # no pads but rows 1 and 4: each shard's masking leaves about half
    table, ids = _half_masked(k, seed=12, v=v, pads=0.0)
    per = v // m
    monkeypatch.setattr(emb, "psum", lambda x, mesh, axis: x)
    parts = []
    for s in range(m):
        mesh = Mesh(1, m, torch.device("cpu"), rank=s, model_group=object())
        rows = table[s * per:(s + 1) * per]
        part = emb.sharded_pooled_lookup(torch.from_numpy(rows),
                                         torch.from_numpy(ids), mesh,
                                         combiner).numpy()
        local = emb.shard_local_ids(torch.from_numpy(ids), s, per).numpy()
        # JAX's shard_map body for this shard, before its psum
        rel = ids - s * per
        valid = (ids >= 0) & (rel >= 0) & (rel < per)
        jrows = jnp.take(jnp.asarray(rows), jnp.clip(rel, 0, per - 1), axis=0)
        body = np.asarray(jnp.sum(jnp.where(valid[..., None], jrows, 0.0), 1))
        np.testing.assert_array_equal(local >= 0, valid)
        jr, jl = jnp.asarray(rows), jnp.asarray(local)
        count = np.maximum((ids >= 0).sum(1, keepdims=True), 1)
        local_sum = part * count if combiner == "mean" else part
        for want in (body,
                     fused_gather_pool_pallas(jr, jl, "sum", interpret=True),
                     fused_gather_pool_jnp(jr, jl, "sum")):
            np.testing.assert_allclose(local_sum, np.asarray(want),
                                       **HALF_TOL)
        parts.append(part)
    for s in range(m):
        local = emb.shard_local_ids(torch.from_numpy(ids), s, per).numpy()
        assert 0.4 < (local >= 0).mean() < 0.6
    want = fused_gather_pool_jnp(jnp.asarray(table), jnp.asarray(ids),
                                 combiner)
    np.testing.assert_allclose(sum(parts), np.asarray(want), **HALF_TOL)
    assert np.all(sum(parts)[1] == 0.0)
