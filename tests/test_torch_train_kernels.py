"""The training slice's pieces against the JAX package on the CPU: the
plain versions of K4 (row scatter), K9 (run-sum compaction) and K2b (the
DIN pool's backward), the split row update, the segment-sum glue, the bf16
tower's gradients and the solvers. Inputs come from numpy seeds and go to
both packages (tests/test_torch_cuda.py holds each CUDA kernel against
its plain version on a card).

Tolerances:
  * K4, the dedup glue's targets, K9's targets and overflow: copies and
    integer work — exact.
  * Split row update and segment sums: the same f32 formulas; cumsums add
    in another order (XLA vs torch) — rtol 1e-5, atol 1e-6.
  * K9 run sums: the port adds each run directly. The JAX kernel
    subtracts block-local prefix sums (512 rows) — atol 1e-5; the
    rank-sort path subtracts global prefix sums, whose rounding grows
    with the prefix — atol 1e-5 · max |prefix|.
  * K2b at f32 against jax.grad of the inline pool: the same derivative
    in another association — rtol 1e-5, atol 1e-6 (d_att0, a sum over B:
    atol 1e-5). A zero item row is the exception: cos's derivative in
    the item is b / (|b|·eps + eps), ~1e8 times the usual, and the sum
    over T cancels, so its d_item holds to rtol 1e-4.
    At bf16 the port computes in f32 and rounds its outputs once, so it
    is within one bf16 ulp of jax.grad at f32 on the same bf16 inputs —
    rtol 2^-7. JAX's own bf16 gradient rounds every intermediate and
    cotangent to bf16; the two differ by a few bf16 ulps of the largest
    terms — atol 3e-2, except the zero item row, whose ~1e8-scaled
    d_item JAX forms from bf16 terms (held at f32 above).
  * Tower gradients at bf16: both round dx and dw to bf16 from f32
    products that differ in the last f32 bits, so a rounding can flip by
    one bf16 ulp — rtol 2^-7, atol 1e-5.
  * Solvers: optax's formulas in optax's order, f32 — rtol 1e-6,
    atol 1e-7; step counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from goctr_tpu.ops.activations import cosine_similarity as jax_cos
from goctr_tpu.ops.pallas.compact import (
    compact_runsums_block as jax_compact,
)
from goctr_tpu.ops.pallas.row_optimizer import (
    apply_row_updates_split as jax_split, pack_grads as jax_pack_grads,
    scatter_rows_packed as jax_scatter,
)
from goctr_tpu.ops import segsum as jseg
from goctr_tpu.optim.optimizers import make_solver as jax_make_solver
from goctr_tpu.optim.schedules import make_schedule as jax_make_schedule
from goctr_tpu.parallel.scanned import _table_update as jax_table_update
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.table_opt import TableOptConfig as JaxTopt
from goctr_tpu_torch.models.base import dropout
from goctr_tpu_torch.ops import segsum as tseg
from goctr_tpu_torch.ops.kernels import compact as k9
from goctr_tpu_torch.ops.kernels import din_attention as k2
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.optim.optimizers import make_solver
from goctr_tpu_torch.optim.schedules import make_schedule
from goctr_tpu_torch.parallel import scanned as tsc
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.table_opt import TableOptConfig


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ K4 --
def test_scatter_plain_matches_jax_kernel_with_junk_ids():
    rng = np.random.default_rng(0)
    v, n = 300, 2048
    table = rng.normal(0, 1, (v, 128)).astype(np.float32)
    real = rng.permutation(250)[:700 // 4]          # distinct, < skip_ge
    tail = np.arange(250, 300)                      # in range, >= skip_ge
    junk = v + 1 + np.arange(n - len(real) - len(tail))   # past the table
    ids = rng.permutation(np.concatenate([real, tail, junk])).astype(np.int32)
    rows = rng.normal(0, 1, (n, 128)).astype(np.float32)
    want = jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                       jnp.asarray(rows), skip_ge=250, interpret=True)
    got = tro.scatter_rows_packed(_t(table).clone(), _t(ids), _t(rows),
                                  skip_ge=250)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    untouched = np.setdiff1d(np.arange(v), real)
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])


def test_scatter_refuses_rows_that_alias_the_table():
    table = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="alias"):
        tro.scatter_rows_packed(table, torch.arange(8, dtype=torch.int32),
                                table[8:16])
    with pytest.raises(ValueError, match="skip_ge"):
        tro.scatter_rows_packed(table, torch.arange(8, dtype=torch.int32),
                                torch.zeros(8, 128), skip_ge=65)


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
def test_split_row_update_matches_jax(kind):
    rng = np.random.default_rng(1)
    v, d, n = 500, 64, 1024
    table = np.zeros((v, 128), np.float32)
    table[:, :d] = rng.normal(0, 0.1, (v, d))
    table[:, d] = rng.random(v)                      # adagrad accumulator
    ids = np.concatenate([rng.permutation(v)[:400],
                          v + 1 + np.arange(n - 400)]).astype(np.int32)
    g = rng.normal(0, 1, (n, d)).astype(np.float32)
    g[400:] = 0.0
    want = jax_split(jnp.asarray(table), jnp.asarray(ids),
                     jax_pack_grads(jnp.asarray(g)), lr=0.3, d=d, kind=kind,
                     skip_ge=v, interpret=True)
    gp = tro.pack_grads(_t(g))
    np.testing.assert_allclose(gp.numpy(), np.asarray(jax_pack_grads(
        jnp.asarray(g))), rtol=1e-6)
    got = tro.apply_row_updates_split(_t(table).clone(), _t(ids), gp,
                                      lr=0.3, d=d, kind=kind, skip_ge=v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ K9 --
def _sorted_stream(n, vocab, n_pad, seed, hot=0, dim=64):
    """Sorted ids (pads = vocab last) with an optional hot run of `hot`
    rows that spans several JAX blocks (512) and port tiles (128)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, n - n_pad - hot)
    ids = np.sort(np.concatenate([ids, np.full(hot, vocab // 3)]))
    ids = np.concatenate([ids, np.full(n_pad, vocab)]).astype(np.int32)
    g = rng.normal(0, 1, (n, dim)).astype(np.float32)
    g[n - n_pad:] = 0.0
    return ids, g


@pytest.mark.parametrize("vocab,capr,hot,dim", [
    # runs across blocks and tiles, cap fits
    pytest.param(400, 1024, 1700, 64, id="400-1024-1700"),
    # more unique ids than the cap: overflow
    pytest.param(5000, 2048, 0, 64, id="5000-2048-0"),
    # the grouped 100M x 16 path's width
    pytest.param(400, 1024, 1700, 16, id="400-1024-1700-d16"),
])
def test_compact_plain_matches_jax_kernel(vocab, capr, hot, dim):
    ids, g = _sorted_stream(6144, vocab, 700, seed=vocab, hot=hot, dim=dim)
    j_tgt, j_rows, j_over = jax_compact(jnp.asarray(ids), jnp.asarray(g),
                                        vocab, capr, interpret=True)
    tgt, rows, over = k9.compact_runsums_block(_t(ids), _t(g), vocab, capr)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))
    assert int(over) == int(j_over)
    assert (int(over) > 0) == (vocab == 5000)
    np.testing.assert_allclose(rows.numpy(), np.asarray(j_rows), atol=1e-5,
                               rtol=1e-5)


def test_compact_plain_matches_the_rank_sort_path():
    """K9's plain version against the port's rank-sort compaction (the
    JAX trainer's compact_impl="xla"): the same (tgt, Σg) pairs."""
    ids, g = _sorted_stream(4096, 300, 500, seed=3, hot=900)
    tgt, rows, over = k9.compact_runsums_plain(_t(ids), _t(g), 300, 1024)
    x_tgt, x_rows, x_over = tsc._compact_xla(_t(ids), _t(g), 300, 1024)
    np.testing.assert_array_equal(tgt.numpy(), x_tgt.numpy())
    assert int(over) == int(x_over) == 0
    prefix = np.abs(np.cumsum(g.astype(np.float64), 0)).max()
    np.testing.assert_allclose(rows[:, :64].numpy(), x_rows.numpy(),
                               atol=1e-5 * prefix)


@pytest.mark.parametrize("impl,cap", [("kernel", 2048), ("xla", 2048),
                                      ("xla", 0), ("kernel", 1024)])
def test_table_update_matches_jax(impl, cap):
    """One fused table update (sort, compaction or dedup, split adagrad)
    against the JAX trainer's _table_update on the same packed table;
    cap 1024 < the batch's unique ids overflows in both."""
    rng = np.random.default_rng(4)
    v, d, n = 1500, 64, 3000                          # n pads to 3072
    table = np.zeros((v, 128), np.float32)
    table[:, :d] = rng.normal(0, 0.01, (v, d))
    ids = rng.integers(-1, v, n).astype(np.int32)
    g = rng.normal(0, 1, (n, d)).astype(np.float32)
    j_table, _, j_over = jax_table_update(
        jnp.asarray(table), jnp.zeros((0,), jnp.float32), jnp.asarray(ids),
        jnp.asarray(g), JaxTopt(lr=0.3, compact_cap=cap, compact_impl=impl),
        v)
    p_table = _t(table).clone()
    over = tsc._table_update(p_table, _t(ids), _t(g), TableOptConfig(
        lr=0.3, compact_cap=cap, compact_impl=impl), v)
    assert int(over) == int(j_over)
    assert (int(over) > 0) == (cap == 1024)
    np.testing.assert_allclose(p_table.numpy(), np.asarray(j_table),
                               rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- segsum --
def test_segsum_glue_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3072, 8)).astype(np.float32)
    np.testing.assert_allclose(tseg._cumsum_rows(_t(x)).numpy(),
                               np.asarray(jseg._cumsum_rows(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)
    iv = rng.integers(-50, 5000, 2048).astype(np.int32)
    np.testing.assert_array_equal(
        tseg._cummax_i32(_t(iv)).numpy(),
        np.asarray(jseg._cummax_i32(jnp.asarray(iv))))
    ids = rng.integers(-1, 60, 2500).astype(np.int32)
    rows = rng.normal(0, 1, (2500, 8)).astype(np.float32)
    j_tgt, j_rows = jseg.segment_rows_dedup(jnp.asarray(ids),
                                            jnp.asarray(rows), 60,
                                            pad_to=3072)
    tgt, out = tseg.segment_rows_dedup(_t(ids), _t(rows), 60, pad_to=3072)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_rows), rtol=1e-5,
                               atol=1e-5)
    s_ids = np.sort(ids[:2048])
    j_tgt, j_rows = jseg.sorted_run_sums(jnp.asarray(s_ids),
                                         jnp.asarray(rows[:2048]), 100)
    tgt, out = tseg.sorted_run_sums(_t(s_ids), _t(rows[:2048]), 100)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_rows), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- K2b --
def _jax_pool(beh, item, att0, mask):
    """The JAX trainer's inline pool (sparse_ctr.py:121-133)."""
    cd = beh.dtype
    denom = jnp.maximum(jnp.sum(mask.astype(cd), axis=1, keepdims=True), 1.0)
    weight = (jax_cos(beh, item[:, None, :]) + 1.0) * 0.5
    gate = jax.nn.sigmoid(weight * att0.astype(cd))
    return jnp.sum(beh * (gate * mask.astype(cd))[..., None], axis=1) / denom


def _pool_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    beh = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    beh[0, 3] = 0.0                                  # a zero behavior row
    item = rng.normal(0, 1, (b, d)).astype(np.float32)
    item[2] = 0.0                                    # a zero item row
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    mask[1] = 0.0                                    # an all-masked row
    att0 = rng.normal(1, 0.3, t).astype(np.float32)
    dout = rng.normal(0, 1, (b, d)).astype(np.float32)
    return dout, beh, item, att0, mask


def _jax_pool_grads(dout, beh, item, att0, mask, dtype):
    f = lambda b, i, a: jnp.sum(_jax_pool(b, i, a, jnp.asarray(mask))
                                * jnp.asarray(dout).astype(dtype))
    return jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(beh).astype(dtype), jnp.asarray(item).astype(dtype),
        jnp.asarray(att0))


# (3, 5, 264): wider than the 256 the kernels once took; (3, 5000, 8):
# longer than the 4096 K2b once took
@pytest.mark.parametrize("b,t,d", [(6, 7, 8), (5, 32, 64), (3, 5, 264),
                                   (3, 5000, 8)])
def test_din_bwd_plain_matches_jax_grad_f32(b, t, d):
    dout, beh, item, att0, mask = _pool_inputs(b, t, d, seed=b)
    want = _jax_pool_grads(dout, beh, item, att0, mask, jnp.float32)
    got = k2.din_attention_pool_bwd(_t(dout), _t(beh), _t(item), _t(att0),
                                    _t(mask))
    rest = np.arange(b) != 2                      # row 2: the zero item
    for g, w in zip(got[:2], want[:2]):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy()[rest], np.asarray(w)[rest],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy()[2], np.asarray(want[0])[2],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy()[2], np.asarray(want[1])[2],
                               rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)
    assert bool((got[0][1] == 0).all())          # all-masked: no gradient
    # the autograd Function gives the same through backward()
    bt, it, at = (_t(x).clone().requires_grad_() for x in (beh, item, att0))
    k2.DinAttentionPool.apply(bt, it, at, _t(mask)).backward(_t(dout))
    for x, g in zip((bt, it, at), got):
        torch.testing.assert_close(x.grad, g)


def test_din_bwd_plain_matches_jax_grad_bf16():
    dout, beh, item, att0, mask = _pool_inputs(5, 32, 64, seed=9)
    bf = torch.bfloat16
    args = [_t(x).to(bf) for x in (dout, beh, item)]
    got = k2.din_attention_pool_bwd(*args, _t(att0), _t(mask))
    assert got[0].dtype == got[1].dtype == bf and got[2].dtype == torch.float32
    # one bf16 ulp of jax.grad at f32 on the same bf16-rounded inputs
    rounded = [x.float().numpy() for x in args]
    want32 = _jax_pool_grads(*rounded, att0, mask, jnp.float32)
    for g, w in zip(got[:2], want32[:2]):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want32[2]),
                               rtol=1e-5, atol=1e-5)
    # JAX's own bf16 gradient, loosely (module docstring)
    want = _jax_pool_grads(dout, beh, item, att0, mask, jnp.bfloat16)
    rest = np.arange(5) != 2
    for g, w in zip(got[:2], want[:2]):
        assert bool(torch.isfinite(g.float()).all())
        np.testing.assert_allclose(g.float().numpy()[rest],
                                   np.asarray(w, np.float32)[rest],
                                   atol=3e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2],
                                                          np.float32),
                               atol=3e-2)


# --------------------------------------------------------------- tower --
TOWER = dict(item_vocab=50, emb_dim=8, u_profile_dim=5, ctx_dim=3,
             behavior_len=4, hidden=(32, 16))


def test_bf16_tower_gradients_match_jax():
    rng = np.random.default_rng(11)
    dims = (5 + 2 * 8 + 3, 32, 16, 1)
    mlp = [rng.normal(0, 1 / np.sqrt(dims[i]), (dims[i], dims[i + 1]))
           .astype(np.float32) for i in range(3)]
    bias = [rng.normal(0, 0.1, k).astype(np.float32) for k in dims[1:]]
    b = 16
    prof, pooled, item, ctx = (rng.normal(0, 1, (b, k)).astype(np.float32)
                               for k in (5, 8, 8, 3))
    jm = JaxSparseCTR(**TOWER, compute_dtype=jnp.bfloat16)

    def jloss(params, pooled, item):
        return jnp.sum(jnp.sin(jm._tower(params, jnp.asarray(prof), pooled,
                                         item, jnp.asarray(ctx))))

    jp = {"att0": jnp.ones(4), "mlp": [jnp.asarray(w) for w in mlp],
          "bias": [jnp.asarray(x) for x in bias]}
    jg, jg_pool, jg_item = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(pooled).astype(jnp.bfloat16),
        jnp.asarray(item).astype(jnp.bfloat16))
    pm = SparseCTR(**TOWER, compute_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        for p, x in zip(pm.mlp, mlp):
            p.copy_(_t(x))
        for p, x in zip(pm.bias, bias):
            p.copy_(_t(x))
    tp = _t(pooled).to(torch.bfloat16).requires_grad_()
    ti = _t(item).to(torch.bfloat16).requires_grad_()
    torch.sin(pm._tower(_t(prof), tp, ti, _t(ctx))).sum().backward()
    tol = dict(rtol=2.0 ** -7, atol=1e-5)
    for p, w in zip(pm.mlp, jg["mlp"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **tol)
    for p, w in zip(pm.bias, jg["bias"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **tol)
    for x, w in ((tp, jg_pool), (ti, jg_item)):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def test_dropout_keeps_scaled_entries():
    x = torch.ones(20000)
    assert dropout(x, 0.5, None, True) is x               # no generator
    assert dropout(x, 0.5, torch.Generator(), False) is x  # eval
    y = dropout(x, 0.25, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02


# ------------------------------------------------------------- solvers --
SOLVER_CASES = [
    ("adam", {}), ("adam", {"l2": 1e-2, "weight_decay": 1e-3}),
    ("sgd", {}), ("sgd", {"momentum": 0.0}), ("sgd", {"nesterov": True}),
    ("adagrad", {"l2": 1e-3}), ("rmsprop", {}), ("adadelta", {}),
]


@pytest.mark.parametrize("schedule", ["constant", "invscaling"])
@pytest.mark.parametrize("name,kw", SOLVER_CASES)
def test_solver_matches_optax(name, kw, schedule):
    rng = np.random.default_rng(12)
    shapes = {"att0": (4,), "bias": [(3,), (1,)], "mlp": [(5, 3), (3, 1)]}
    params = {"att0": rng.normal(size=4).astype(np.float32),
              "bias": [rng.normal(size=s).astype(np.float32)
                       for s in shapes["bias"]],
              "mlp": [rng.normal(size=s).astype(np.float32)
                      for s in shapes["mlp"]]}
    jlr = jax_make_schedule(schedule, 0.05) if schedule == "invscaling" \
        else 0.05
    tlr = make_schedule(schedule, 0.05) if schedule == "invscaling" else 0.05
    jsolver = jax_make_solver(name, jlr, **kw)
    tsolver = make_solver(name, tlr, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jsolver.init(jparams)
    leaves = [_t(x) for x in jax.tree.leaves(params)]
    tstate = tsolver.init(leaves)
    assert [tuple(x.shape) for x in tstate] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(jstate)]
    for step in range(4):
        grads = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jupd, jstate = jsolver.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = tsolver.update([_t(x) for x in jax.tree.leaves(grads)],
                                      tstate, leaves)
        leaves = [p + u for p, u in zip(leaves, tupd)]
    for got, want in zip(leaves, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    jleaves = jax.tree.leaves(jstate)
    assert len(tstate) == len(jleaves)
    for got, want in zip(tstate, jleaves):
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_lbfgs_waits_for_its_slice():
    """lbfgs came with the sklearn-style MLPs' slice: make_solver returns
    the full-batch LBFGS (held to optax.lbfgs in tests/test_torch_mlp.py),
    whose state has optax's 7 + 5k leaves for k parameter leaves."""
    from goctr_tpu_torch.optim.optimizers import LBFGS

    solver = make_solver("lbfgs")
    assert isinstance(solver, LBFGS)
    assert len(solver.init([torch.zeros(3), torch.zeros(2, 2)])) == 17
