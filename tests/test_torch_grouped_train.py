"""The fused update mode at every width against the JAX package on the
CPU: the one-pass updates K5 (`apply_row_updates`, packed rows) and K6
(`apply_line_updates`, grouped lines) through their plain versions, the
split line update, the grouped branch of the table update, and the whole
trainer at D = 16 (G = 7 rows per 128-lane line) below and above
GROUPED_RESIDENT_MIN_V, its grouped resume and checkpoints, and the
D = 64 trainer with rmw_impl="kernel". Inputs come from numpy seeds and
go to both packages (tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on a card).

Tolerances:
  * K5 / K6 plain against the JAX kernels in interpret mode: the JAX
    test's own (tests/test_pallas_kernels.py:413-414), rtol 2e-4,
    atol 2e-5. Against the jnp fallbacks, which are the same f32
    operations (the 0/1 spread product has one nonzero term a lane, read
    directly here): rtol 1e-6, atol 1e-7, the room of one ulp of rsqrt
    on terms below 1.
  * The line stream (lane placement and run sums over line ids): integer
    targets exact; sums of the same f32 rows as differences of cumsums
    that add in another order (XLA vs torch), so each is off by a few
    ulps of the largest prefix — rtol 1e-5, atol 1e-6 of that prefix
    (the accumulator lanes' prefix reaches ~3e4 here, whose ulp is 2e-3).
  * Table updates and whole trainers: tests/test_torch_train.py's, those
    of the JAX package's own trainer parity test — loss rtol 1e-5; table,
    accumulator, dense parameters and solver state rtol 1e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.models.io import _flatten_params as jax_flatten
from goctr_tpu.models.io import _unflatten_params as jax_unflatten
from goctr_tpu.models.trainer import TrainerConfig as JaxConfig
from goctr_tpu.ops import segsum as jseg
from goctr_tpu.ops.pallas import row_optimizer as jro
from goctr_tpu.parallel import scanned as jsc
from goctr_tpu.parallel.scanned import TableOptConfig as JaxTopt
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu_torch.convert import scanned_from_jax
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.parallel import scanned as tsc
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, load_scanned_checkpoint, save_scanned_checkpoint,
    train_sparse_scanned,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample
from goctr_tpu_torch.serve.scorer import DeviceScorer
from test_torch_cuda import stage4_case

N, T, VOCAB = 3000, 5, 400
LOSS = dict(rtol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-5)
FALLBACK = dict(rtol=1e-6, atol=1e-7)
INTERPRET = dict(rtol=2e-4, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# -------------------------------------------------------------- K5 / K6 --
def _rmw_case(d, grouped, seed, n=1024):
    """A table with adagrad accumulators (packed rows, or grouped lines
    whose last line is partial) and n update slots: ~60% junk ids past
    the table, the rest real and distinct, the last real line among them
    and, for packed rows, two ids in [skip_ge, V), which are skipped.
    Returns (table, ids, updates, skip_ge) as numpy."""
    rng = np.random.default_rng(seed)
    g = jro.group_size(d) if grouped else 1
    vocab = 2400 * g - 3 if grouped else 2400
    w = rng.normal(0, 0.1, (vocab, d)).astype(np.float32)
    acc = rng.random(vocab).astype(np.float32)
    pack = jro.pack_table_grouped if grouped else jro.pack_table
    table = np.array(pack(jnp.asarray(w), jnp.asarray(acc)))
    rows = table.shape[0]
    skip_ge = rows if grouped else rows - 20
    real = rng.permutation(skip_ge - 1)[:n]
    ids = np.where(rng.random(n) < 0.6, rows + 1 + np.arange(n), real)
    ids[0] = skip_ge - 1
    if not grouped:
        ids[1:3] = [skip_ge, rows - 1]
    upd = np.zeros((n, 128), np.float32)
    stride = d + 1
    for grp in range(g):
        gw = rng.normal(0, 0.3, (n, d))
        upd[:, grp * stride:grp * stride + d] = gw
        upd[:, grp * stride + d] = (gw * gw).sum(1)
    upd[ids >= skip_ge] = 0.0
    pad_rows = rows * g - vocab       # no update reaches rows past the vocab
    if pad_rows:
        upd[ids == rows - 1, (g - pad_rows) * stride:] = 0.0
    return table, ids.astype(np.int32), upd, skip_ge


def _touched(table, ids, skip_ge):
    hit = np.zeros(table.shape[0], bool)
    hit[ids[ids < skip_ge]] = True
    return hit


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [16, 30, 64])
def test_row_rmw_plain_matches_jax(d, kind):
    """K5 on packed [V, 128] rows, at G = 1 masks for every d."""
    table, ids, upd, skip_ge = _rmw_case(d, False, seed=d)
    args = (jnp.asarray(ids), jnp.asarray(upd))
    want_k = jro.apply_row_updates(jnp.asarray(table), *args, lr=0.25, d=d,
                                   kind=kind, skip_ge=skip_ge,
                                   interpret=True)
    want_f = jro._apply_row_updates_jnp(jnp.asarray(table), *args, 0.25,
                                        kind, 1e-8, d, skip_ge)
    got = tro.apply_row_updates(_t(table), _t(ids), _t(upd), lr=0.25, d=d,
                                kind=kind, skip_ge=skip_ge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **INTERPRET)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_f), **FALLBACK)
    hit = _touched(table, ids, skip_ge)
    assert (got.numpy()[hit] != table[hit]).any(1).all()
    np.testing.assert_array_equal(got.numpy()[~hit], table[~hit])
    assert tro.apply_row_updates.launches == 0        # plain version only


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [16, 30, 64])
def test_line_rmw_plain_matches_jax(d, kind):
    """K6 on grouped lines: G = 7, 4, 1 at d = 16, 30, 64."""
    table, ids, upd, skip_ge = _rmw_case(d, True, seed=100 + d)
    args = (jnp.asarray(ids), jnp.asarray(upd))
    want_k = jro.apply_line_updates(jnp.asarray(table), *args, lr=0.25,
                                    d=d, kind=kind, skip_ge=skip_ge,
                                    interpret=True)
    want_f = jro._apply_line_updates_jnp(
        jnp.asarray(table), *args, jro.make_spread(d), 0.25, kind, 1e-8, d,
        skip_ge)
    got = tro.apply_line_updates(_t(table), _t(ids), _t(upd), lr=0.25, d=d,
                                 kind=kind, skip_ge=skip_ge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **INTERPRET)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_f), **FALLBACK)
    hit = _touched(table, ids, skip_ge)
    assert hit[-1]                                    # the last line
    assert (got.numpy()[hit] != table[hit]).any(1).all()
    np.testing.assert_array_equal(got.numpy()[~hit], table[~hit])
    assert tro.apply_line_updates.launches == 0


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d,grouped", [(64, False), (16, True)],
                         ids=["K5", "K6"])
def test_rmw_plain_matches_jax_on_stage4_streams(d, grouped, kind):
    """K5 (packed rows) and K6 (grouped lines, G = 7) on a stream shaped
    like one model shard's stage-4 stream of a mesh, the case the CUDA
    kernels are designed for (tests/test_torch_cuda.py `stage4_case`: 12%
    of the slots real, the run ends of a sorted stretch with junk between
    them, the other shard's ids and a junk tail past skip_ge; for K5 also
    ids in [skip_ge, V), which are skipped): the port's plain versions
    against the JAX kernels in interpret mode and the jnp fallbacks."""
    group = jro.group_size(d) if grouped else 1
    lines, n = 400, 1024
    skip_ge = lines if grouped else lines - 20
    table, ids, upd = stage4_case(n, lines, skip_ge, 0.12, "shard 1", d,
                                  group, seed=d)
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd))
    kw = dict(lr=0.25, d=d, kind=kind, skip_ge=skip_ge)
    if grouped:
        want_k = jro.apply_line_updates(*args, interpret=True, **kw)
        want_f = jro._apply_line_updates_jnp(*args, jro.make_spread(d), 0.25,
                                             kind, 1e-8, d, skip_ge)
        got = tro.apply_line_updates(_t(table), _t(ids), _t(upd), **kw)
    else:
        want_k = jro.apply_row_updates(*args, interpret=True, **kw)
        want_f = jro._apply_row_updates_jnp(*args, 0.25, kind, 1e-8, d,
                                            skip_ge)
        got = tro.apply_row_updates(_t(table), _t(ids), _t(upd), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **INTERPRET)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_f), **FALLBACK)
    hit = _touched(table, ids, skip_ge)
    assert hit.sum() == round(0.12 * n)
    assert (got.numpy()[hit] != table[hit]).any(1).all()
    np.testing.assert_array_equal(got.numpy()[~hit], table[~hit])


@pytest.mark.parametrize("d,grouped", [(64, False), (64, True), (16, True),
                                       (30, True)])
def test_rmw_plain_eps_zero_stays_finite(d, grouped):
    """At eps = 0 only the weight lanes take the rsqrt: the other lanes
    stay finite, those of eps = 1e-8 bit for bit, and the weight lanes
    agree with the JAX fallback's. JAX's K5 fallback (one accumulator a
    row) agrees on every lane, all finite. Its K6 fallback's spread
    product also gives NaN on the touched lines' other lanes (rsqrt(0) ·
    0); on the weight lanes both packages give NaN for the rows past the
    vocab in the last line, whose accumulator is 0 and gets no update."""
    table, ids, upd, skip_ge = _rmw_case(d, grouped, seed=300 + d)
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd))
    g = jro.group_size(d) if grouped else 1
    if grouped:
        want = jro._apply_line_updates_jnp(*args, jro.make_spread(d), 0.25,
                                           "adagrad", 0.0, d, skip_ge)
        wrapper = tro.apply_line_updates
    else:
        want = jro._apply_row_updates_jnp(*args, 0.25, "adagrad", 0.0, d,
                                          skip_ge)
        wrapper = tro.apply_row_updates
    got, ref = (wrapper(_t(table), _t(ids), _t(upd), lr=0.25, d=d, eps=eps,
                        skip_ge=skip_ge).numpy() for eps in (0.0, 1e-8))
    want = np.asarray(want)
    weight = tro.lane_masks(d, g)[0].numpy() > 0
    assert np.isfinite(got[:, ~weight]).all()
    np.testing.assert_array_equal(got[:, ~weight], ref[:, ~weight])
    np.testing.assert_allclose(got[:, weight], want[:, weight],
                               equal_nan=True, **FALLBACK)
    if grouped:
        assert np.isnan(want[_touched(table, ids, skip_ge)][:, ~weight]).any()
    else:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **FALLBACK)


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [16, 30])
def test_split_line_update_matches_jax(d, kind):
    table, ids, upd, skip_ge = _rmw_case(d, True, seed=200 + d)
    want = jro.apply_line_updates_split(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd), lr=0.25,
        d=d, kind=kind, skip_ge=skip_ge)
    got = tro.apply_line_updates_split(_t(table), _t(ids), _t(upd),
                                       lr=0.25, d=d, kind=kind,
                                       skip_ge=skip_ge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FALLBACK)
    # the one-pass plain version computes the same lines
    one = tro.apply_line_updates(_t(table), _t(ids), _t(upd), lr=0.25, d=d,
                                 kind=kind, skip_ge=skip_ge)
    assert torch.equal(one, got)


def test_acc_lanes_is_make_spread():
    for d in (1, 8, 16, 30, 63, 64, 100):
        g = tro.group_size(d)
        m_w, _ = tro.lane_masks(d, g)
        spread = np.zeros((128, 128), np.float32)
        spread[tro.acc_lanes(d, g).numpy(), np.arange(128)] = 1.0
        spread *= m_w.numpy()[None, :]
        np.testing.assert_array_equal(spread, np.asarray(jro.make_spread(d)))


def test_rmw_refuses_bad_inputs():
    table = torch.zeros(64, 128)
    ids = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="alias"):
        tro.apply_line_updates(table, ids, table[8:16], lr=0.1, d=16)
    with pytest.raises(ValueError, match="0 < d"):
        tro.apply_row_updates(table, ids, torch.zeros(8, 128), lr=0.1,
                              d=128)
    with pytest.raises(ValueError, match="optimizer"):
        tro.apply_row_updates(table, ids, torch.zeros(8, 128), lr=0.1, d=8,
                              kind="adam")


# --------------------------------------------------- grouped update step --
def _jax_line_stream(tgt, rows, V):
    """The JAX trainer's grouped branch up to the line update
    (goctr_tpu/parallel/scanned.py:346-361), written out."""
    D = rows.shape[1]
    G = jro.group_size(D)
    L = jro.packed_lines(V, D)
    n = tgt.shape[0]
    real = tgt < V
    nsq = jnp.sum(rows * rows, axis=1, keepdims=True)
    oh = jax.nn.one_hot(tgt % G, G, dtype=jnp.float32) * real[:, None]
    block = oh[:, :, None] * jnp.concatenate([rows, nsq], axis=1)[:, None]
    upd = jnp.zeros((n, 128), jnp.float32)
    upd = upd.at[:, :G * (D + 1)].set(block.reshape(n, G * (D + 1)))
    pos = jnp.arange(n, dtype=jnp.int32)
    lkey = jnp.where(real, (tgt // G).astype(jnp.int32), L + pos)
    order = jnp.argsort(lkey)
    return jseg.sorted_run_sums(jnp.take(lkey, order),
                                jnp.take(upd, order, axis=0),
                                junk_base=L + n + 1)


def test_line_stream_matches_jax():
    """Lane placement and the run sums over line ids (ops/segsum.py's
    sorted_run_sums on line keys) against the JAX trainer's."""
    rng = np.random.default_rng(7)
    V, d, n = 700, 16, 3072
    ids = rng.integers(-1, V, n).astype(np.int32)
    g = rng.normal(0, 1, (n, d)).astype(np.float32)
    tgt, rows = tsc.segment_rows_dedup(_t(ids), _t(g), V, pad_to=n)
    ltgt, lrows = tsc.line_stream(tgt, rows, V)
    j_tgt, j_rows = _jax_line_stream(jnp.asarray(tgt.numpy()),
                                     jnp.asarray(rows.numpy()), V)
    np.testing.assert_array_equal(ltgt.numpy(), np.asarray(j_tgt))
    # the largest cumsum prefix: the total of a lane over the stream
    prefix = np.abs(np.asarray(j_rows, np.float64)).sum(0).max()
    np.testing.assert_allclose(lrows.numpy(), np.asarray(j_rows), rtol=1e-5,
                               atol=1e-6 * prefix)
    # every target distinct: real lines, junk rows' L + k, non-ends'
    # L + n + 1 + k
    L = jro.packed_lines(V, d)
    assert len(np.unique(ltgt.numpy())) == n
    assert 0 < int((ltgt < L).sum()) <= L


@pytest.mark.parametrize("rmw", ["split", "kernel"])
@pytest.mark.parametrize("cap,impl", [(0, "xla"), (2048, "xla"),
                                      (2048, "kernel")])
def test_grouped_table_update_matches_jax(cap, impl, rmw):
    """One fused table update on grouped lines (D = 16, G = 7) against
    the JAX trainer's _table_update on the same lines. The row gradients
    have the trainer's scale (~1e-2): at N(0, 1) the accumulator lanes'
    cumsum prefixes reach ~3e4 and both packages' run sums carry a few
    ulps of them (test_line_stream_matches_jax holds that case)."""
    rng = np.random.default_rng(8)
    V, d, n = 1500, 16, 3000                          # n pads to 3072
    lines = np.array(jro.pack_table_grouped(
        jnp.asarray(rng.normal(0, 0.01, (V, d)).astype(np.float32)),
        jnp.asarray(rng.random(V).astype(np.float32))))
    ids = rng.integers(-1, V, n).astype(np.int32)
    g = rng.normal(0, 0.01, (n, d)).astype(np.float32)
    j_lines, _, j_over = jsc._table_update(
        jnp.asarray(lines), jnp.zeros((0,), jnp.float32), jnp.asarray(ids),
        jnp.asarray(g), JaxTopt(lr=0.3, compact_cap=cap, compact_impl=impl,
                                rmw_impl=rmw), V)
    topt = TableOptConfig(lr=0.3, compact_cap=cap, compact_impl=impl,
                          rmw_impl=rmw)
    p_lines = _t(lines)
    over = tsc._table_update(p_lines, _t(ids), _t(g), topt, V)
    assert int(over) == int(j_over) == 0
    np.testing.assert_allclose(p_lines.numpy(), np.asarray(j_lines), **STATE)
    assert not np.array_equal(p_lines.numpy(), lines)
    # the trainer's own line stream keeps the one-pass update's promise
    tgt, rows, _, _ = tsc.update_rows(_t(ids), _t(g), topt, V)
    ltgt = tsc.line_stream(tgt, rows, V)[0].numpy()
    real = ltgt[ltgt < lines.shape[0]]
    assert len(np.unique(real)) == len(real)


# --------------------------------------------------------- whole trainer --
def _model_cfg(d, vocab=VOCAB):
    return dict(item_vocab=vocab, emb_dim=d, u_profile_dim=4, ctx_dim=2,
                behavior_len=T, hidden=(16,))


def _arrays(vocab=VOCAB, seed=0):
    rng = np.random.default_rng(seed)
    return dict(user_profile=rng.random((N, 4)).astype(np.float32),
                behavior_ids=rng.integers(-1, vocab, (N, T)).astype(np.int32),
                item_ids=rng.integers(0, vocab, N).astype(np.int32),
                ctx=rng.random((N, 2)).astype(np.float32),
                labels=(rng.random(N) > 0.5).astype(np.float32))


@dataclasses.dataclass
class Start:
    """The JAX trainer's epochs=0 state as numpy (a [V, D] table and acc,
    or grouped-resident lines with an empty acc) and fresh copies of it
    for either package (the JAX trainer consumes what it resumes from)."""
    d: int
    arrays: dict
    r0: object
    flat: dict
    table: np.ndarray
    acc: np.ndarray
    opt_leaves: list
    treedef: object
    packed_group: int

    def for_jax(self):
        return dataclasses.replace(
            self.r0, dense_params=jax_unflatten(
                {k: v.copy() for k, v in self.flat.items()}),
            table=jnp.asarray(self.table.copy()),
            acc=jnp.asarray(self.acc.copy()),
            opt_state=jax.tree.unflatten(
                self.treedef, [jnp.asarray(x) for x in self.opt_leaves]))

    def for_port(self):
        return scanned_from_jax(
            SparseCTR(**_model_cfg(self.d), device="cpu"), self.flat,
            self.table, self.acc, self.opt_leaves, [], device="cpu")


def _start(d):
    jm = JaxSparseCTR(**_model_cfg(d))
    arrays = _arrays()
    r0 = jsc.train_sparse_scanned(jm, JaxSample(**arrays),
                                  JaxConfig(batch_size=1024, epochs=0,
                                            seed=1))
    return Start(d, arrays, r0, jax_flatten(r0.dense_params),
                 np.array(r0.table), np.array(r0.acc),
                 [np.array(x) for x in jax.tree.leaves(r0.opt_state)],
                 jax.tree.structure(r0.opt_state), r0.packed_group)


@pytest.fixture
def resident(monkeypatch):
    """Both packages keep grouped tables in lines from a vocab of 100."""
    monkeypatch.setattr(jsc, "GROUPED_RESIDENT_MIN_V", 100)
    monkeypatch.setattr(tsc, "GROUPED_RESIDENT_MIN_V", 100)


def _cfgs(epochs=3, **topt):
    kw = dict(batch_size=1024, epochs=epochs, early_stop=0, shuffle=False,
              seed=0)
    return (JaxConfig(**kw), TrainerConfig(**kw), JaxTopt(**topt),
            TableOptConfig(**topt))


def _train_both(st, epochs=3, **topt):
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs, **topt)
    jr = jsc.train_sparse_scanned(st.r0.model, JaxSample(**st.arrays), jcfg,
                                  jtopt, resume_from=st.for_jax())
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(st.d), device="cpu"),
                              SparseSample(**st.arrays), pcfg, ptopt,
                              resume_from=st.for_port(), device="cpu")
    return pr, jr


def _assert_same_state(pr, jr):
    np.testing.assert_allclose(pr.loss_curve, jr.loss_curve, **LOSS)
    assert pr.packed_group == jr.packed_group
    np.testing.assert_allclose(pr.table.numpy(), np.asarray(jr.table),
                               **STATE)
    if pr.packed_group > 1:
        assert pr.acc is None and np.size(jr.acc) == 0
    else:
        np.testing.assert_allclose(pr.acc.numpy(), np.asarray(jr.acc),
                                   **STATE)
    flat = jax_flatten(jr.dense_params)
    for k, v in pr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), flat[k], **STATE)
    jleaves = jax.tree.leaves(jr.opt_state)
    assert len(pr.opt_state) == len(jleaves)
    for got, want in zip(pr.opt_state, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE)
    assert pr.update_overflow_max == jr.update_overflow_max
    assert pr.loss_curve[-1] < pr.loss_curve[0]


@pytest.mark.parametrize("kind,rmw,cap,impl", [
    ("adagrad", "split", 0, "xla"),
    ("adagrad", "split", 2048, "xla"),
    ("adagrad", "kernel", 0, "xla"),
    ("adagrad", "kernel", 2048, "kernel"),
    ("sgd", "kernel", 2048, "xla"),
])
def test_grouped_trainer_matches_jax(kind, rmw, cap, impl):
    """D = 16 below GROUPED_RESIDENT_MIN_V: the [V, 16] start is packed
    into grouped lines, trained, and unpacked to [V, 16] + acc."""
    st = _start(16)
    assert st.packed_group == 1
    pr, jr = _train_both(st, kind=kind, lr=0.3 if kind == "adagrad" else 5.0,
                         compact_cap=cap, compact_impl=impl, rmw_impl=rmw)
    _assert_same_state(pr, jr)
    assert tuple(pr.table.shape) == (VOCAB, 16) and pr.table.is_contiguous()


@pytest.mark.parametrize("rmw", ["split", "kernel"])
def test_grouped_resident_trainer_matches_jax(resident, rmw):
    """D = 16 at or above GROUPED_RESIDENT_MIN_V: JAX's fresh lines are
    carried across with scanned_from_jax (the [58, 128] lines), both
    packages train in lines and return them, and the port leaves its
    resume_from as it was."""
    st = _start(16)
    assert st.packed_group == 7 and st.table.shape == (58, 128)
    port_start = st.for_port()
    before = port_start.table.clone()
    jcfg, pcfg, jtopt, ptopt = _cfgs(lr=0.3, compact_cap=2048,
                                     rmw_impl=rmw)
    jr = jsc.train_sparse_scanned(st.r0.model, JaxSample(**st.arrays), jcfg,
                                  jtopt, resume_from=st.for_jax())
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(16), device="cpu"),
                              SparseSample(**st.arrays), pcfg, ptopt,
                              resume_from=port_start, device="cpu")
    _assert_same_state(pr, jr)
    assert torch.equal(port_start.table, before)
    assert tuple(pr.table.shape) == (58, 128)
    # the trained lines serve, as JAX's predict scores them
    sample = {k: v[:64] for k, v in st.arrays.items()}
    want = np.asarray(jr.predict(JaxSample(**sample)))
    np.testing.assert_allclose(pr.predict(SparseSample(**sample)), want,
                               rtol=1e-5, atol=1e-6)
    cands = sample["item_ids"][:20]
    scores = DeviceScorer.from_scanned(pr, device="cpu").score(
        sample["user_profile"][0], sample["behavior_ids"][0],
        sample["ctx"][0], cands)
    one_user = {k: np.repeat(v[:1], 20, 0) for k, v in sample.items()}
    one_user["item_ids"] = cands
    np.testing.assert_allclose(scores, pr.predict(SparseSample(**one_user)),
                               rtol=1e-6, atol=1e-7)


def test_grouped_checkpoints_cross_packages(resident, tmp_path):
    """A grouped-resident JAX result saved (unpacked to [V, 16] on the
    host) resumes in the port as in JAX; the port's grouped result saved
    the same way resumes in JAX and in the port to the same state."""
    from goctr_tpu.parallel.scanned import (
        load_scanned_checkpoint as jax_load,
        save_scanned_checkpoint as jax_save,
    )
    st = _start(16)
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs=2, lr=0.3, compact_cap=2048)
    j2 = jsc.train_sparse_scanned(st.r0.model, JaxSample(**st.arrays), jcfg,
                                  jtopt, resume_from=st.for_jax())
    assert j2.packed_group == 7
    jax_save(tmp_path / "jax", j2, jcfg)
    jcfg1, pcfg1, _, _ = _cfgs(epochs=1)
    j3 = jsc.train_sparse_scanned(st.r0.model, JaxSample(**st.arrays), jcfg1,
                                  jtopt, resume_from=jax_load(tmp_path / "jax"))
    p2 = load_scanned_checkpoint(tmp_path / "jax", device="cpu")
    assert p2.packed_group == 1 and tuple(p2.table.shape) == (VOCAB, 16)
    p3 = train_sparse_scanned(SparseCTR(**_model_cfg(16), device="cpu"),
                              SparseSample(**st.arrays), pcfg1, ptopt,
                              resume_from=p2, device="cpu")
    _assert_same_state(p3, j3)
    assert p3.packed_group == 7 and len(p3.loss_curve) == 3

    save_scanned_checkpoint(tmp_path / "port", p3, pcfg1)
    j4 = jsc.train_sparse_scanned(st.r0.model, JaxSample(**st.arrays), jcfg1,
                                  jtopt,
                                  resume_from=jax_load(tmp_path / "port"))
    p4 = train_sparse_scanned(
        SparseCTR(**_model_cfg(16), device="cpu"), SparseSample(**st.arrays),
        pcfg1, ptopt,
        resume_from=load_scanned_checkpoint(tmp_path / "port", device="cpu"),
        device="cpu")
    assert len(p4.loss_curve) == len(j4.loss_curve) == 4
    _assert_same_state(p4, j4)


@pytest.mark.parametrize("kind,cap,impl", [("adagrad", 2048, "kernel"),
                                           ("adagrad", 0, "xla"),
                                           ("sgd", 2048, "xla")])
def test_row_kernel_trainer_matches_jax(kind, cap, impl):
    """D = 64 (one row per line) with rmw_impl="kernel": K5's path."""
    st = _start(64)
    pr, jr = _train_both(st, kind=kind, lr=0.3 if kind == "adagrad" else 5.0,
                         compact_cap=cap, compact_impl=impl,
                         rmw_impl="kernel")
    _assert_same_state(pr, jr)
    assert tuple(pr.table.shape) == (VOCAB, 64)


def test_resume_refuses_lines_of_another_group():
    st = _start(64)
    bad = dataclasses.replace(st.for_port(), packed_group=7)
    with pytest.raises(ValueError, match="packs 1"):
        train_sparse_scanned(SparseCTR(**_model_cfg(64), device="cpu"),
                             SparseSample(**st.arrays), _cfgs(1)[1],
                             resume_from=bad, device="cpu")
    with pytest.raises(ValueError, match="packs 1"):
        scanned_from_jax(SparseCTR(**_model_cfg(64), device="cpu"), st.flat,
                         np.zeros((58, 128), np.float32), device="cpu")
