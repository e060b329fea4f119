"""The scanned trainer's other update modes against the JAX package on the
CPU: fused2 (kernel K7, `apply_csum_updates`), runfused (kernel K8,
`apply_run_updates`), dedup, sorted and plain — the JAX layouts' metadata
streams, `scatter_add_rows`, the K7 and K8 plain versions, one table
update per mode, whole trainers at D = 64 and D = 16 (where fused2 and
runfused keep one row per 128-lane line, not grouped lines), resume
across layouts, dedup checkpoints, and the errors. Inputs come from numpy
seeds and go to both packages (tests/test_torch_cuda.py holds K7 and K8
against their plain versions on a card).

Tolerances:
  * pack_meta / pack_end_meta, scatter targets: integer work — exact.
  * scatter_add_rows: the same f32 adds; repeated ids add in another
    order (XLA's scatter vs index_add_) — rtol 1e-6, atol 1e-6.
  * K7 plain against the JAX kernel in interpret mode and its jnp
    fallback: the same cumsum rows and the same subtraction, so each run
    sum is the same bits; ‖Σg‖² adds d squares in another order and rsqrt
    may differ by an ulp — rtol 1e-6, atol 1e-6 (the accumulators reach
    ~10 here, whose ulp is 1e-6).
  * K8 plain against the JAX kernel in interpret mode, which sums each
    run in position order while the plain version takes cumsum
    differences: the JAX test's own oracle tolerance
    (tests/test_pallas_kernels.py:200-204), rtol 2e-4, atol 2e-5.
    Against the jnp fallback, the same cumsum differences added in
    another order (XLA vs torch): a few ulps of the largest prefix
    (~60 here, ulp 4e-6) — rtol 1e-5, atol 2e-5.
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
from goctr_tpu.ops.pallas import run_optimizer as jrun
from goctr_tpu.ops.scatter import scatter_add_rows as jax_scatter_add_rows
from goctr_tpu.parallel import scanned as jsc
from goctr_tpu.parallel.scanned import TableOptConfig as JaxTopt
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu_torch.convert import scanned_from_jax
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels import row_optimizer as tro
from goctr_tpu_torch.ops.kernels import run_optimizer as trun
from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.ops.segsum import _cumsum_rows
from goctr_tpu_torch.parallel import scanned as tsc
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, load_scanned_checkpoint, save_scanned_checkpoint,
    table_pad_rows, train_sparse_scanned,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

N, T, VOCAB, BATCH = 3000, 5, 400, 1024
LOSS = dict(rtol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-5)
MODES = ("fused2", "runfused", "dedup", "sorted", "plain")


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------- the streams --
def _sorted_stream(n, vocab, d, seed, hot=700, n_pad=100):
    """A sorted update stream as the trainer builds it: a hot run of `hot`
    rows of id 0 (longer than the JAX kernels' RING of 8, across their
    1024-row blocks), random ids with duplicates, n_pad pads at id = vocab
    (zero rows) last; and a packed table with accumulators."""
    rng = np.random.default_rng(seed)
    raw = np.concatenate([np.zeros(hot, np.int64),
                          rng.integers(0, vocab, n - hot - n_pad),
                          np.full(n_pad, -1, np.int64)])
    ids = np.where(raw >= 0, raw, vocab)
    order = np.argsort(ids, kind="stable")
    g = rng.normal(0, 0.5, (n, d)).astype(np.float32)
    g[raw < 0] = 0.0
    w0 = rng.normal(0, 1, (vocab, d)).astype(np.float32)
    acc0 = (rng.random(vocab) * 0.1).astype(np.float32)
    table = np.array(jro.pack_table(jnp.asarray(w0), jnp.asarray(acc0)))
    return ids[order].astype(np.int32), g[order], table


@pytest.mark.parametrize("seed", [0, 1])
def test_meta_streams_match_jax(seed):
    s_ids, _, _ = _sorted_stream(2048, 300, 8, seed)
    s_ids[:5] = [0, 0, 1, 2, 2]
    np.testing.assert_array_equal(
        trun.pack_meta(_t(s_ids)).numpy(),
        np.asarray(jrun.pack_meta(jnp.asarray(s_ids))))
    np.testing.assert_array_equal(
        tro.pack_end_meta(_t(s_ids)).numpy(),
        np.asarray(jro.pack_end_meta(jnp.asarray(s_ids))))


def test_scatter_add_rows_matches_jax():
    """Negative ids and ids past the table are dropped; repeated ids add
    up."""
    rng = np.random.default_rng(2)
    table = rng.normal(0, 1, (50, 8)).astype(np.float32)
    ids = rng.integers(-5, 60, 700).astype(np.int32)
    rows = rng.normal(0, 1, (700, 8)).astype(np.float32)
    want = np.asarray(jax_scatter_add_rows(jnp.asarray(table),
                                           jnp.asarray(ids),
                                           jnp.asarray(rows)))
    got = scatter_add_rows(_t(table), _t(ids), _t(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    kept = (ids >= 0) & (ids < 50)
    assert 0 < kept.sum() < 700
    untouched = np.setdiff1d(np.arange(50), ids[kept])
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])


@pytest.fixture
def threads():
    """torch.set_num_threads for one test, the old count restored."""
    before = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(before)


@pytest.mark.parametrize("n_threads", [1, 2, 4])
def test_scatter_add_rows_adds_in_stream_order(threads, n_threads):
    """On the CPU each id's rows add in the order of j at any intra-op
    thread count: bit for bit a numpy loop over j (np.add.at adds
    unbuffered, in index order). Half the stream is one hot id, and ids
    outside the table are dropped. The accumulating index_put_ this
    replaced differed from that loop by ~4e-4 at 2 threads, from call to
    call."""
    threads(n_threads)
    rng = np.random.default_rng(5)
    vocab, n = 50, 200_000
    ids = np.where(rng.random(n) < 0.5, 3,
                   rng.integers(-5, vocab + 5, n)).astype(np.int32)
    rows = rng.normal(0, 1, (n, 16)).astype(np.float32)
    table = rng.normal(0, 1, (vocab, 16)).astype(np.float32)
    want = table.copy()
    kept = (ids >= 0) & (ids < vocab)
    np.add.at(want, ids[kept], rows[kept])
    for _ in range(3):
        got = scatter_add_rows(_t(table), _t(ids), _t(rows))
        np.testing.assert_array_equal(got.numpy(), want)
    acc = scatter_add_rows(_t(table[:, 0]).clone()[:, None], _t(ids),
                           _t(rows[:, :1]))
    np.testing.assert_array_equal(acc.numpy(), want[:, :1])


# ------------------------------------------------------------------ K7 --
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
def test_csum_plain_matches_jax(kind, d):
    """K7's plain version: duplicates, pads at id V, a hot run and runs
    across the 1024 boundary (tests/test_pallas_kernels.py:230-266)."""
    vocab = 200
    s_ids, s_rows, table = _sorted_stream(2048, vocab, d, seed=d, hot=300,
                                          n_pad=64)
    c = np.asarray(jseg._cumsum_rows(jnp.asarray(s_rows)))
    args = (jnp.asarray(table), jnp.asarray(s_ids), jnp.asarray(c))
    want_k = jro.apply_csum_updates(*args, lr=0.25, d=d, kind=kind,
                                    skip_ge=vocab, interpret=True)
    want_f = jro._apply_csum_updates_jnp(*args, 0.25, kind, 1e-8, d, vocab)
    got = tro.apply_csum_updates(_t(table), _t(s_ids), _t(c), lr=0.25, d=d,
                                 kind=kind, skip_ge=vocab)
    for want in (want_k, want_f):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    touched = np.zeros(vocab, bool)
    touched[s_ids[s_ids < vocab]] = True
    np.testing.assert_array_equal(got.numpy()[~touched], table[~touched])
    assert (got.numpy()[touched] != table[touched]).any(1).all()
    assert tro.apply_csum_updates.launches == 0        # plain version only


def test_csum_plain_takes_the_port_cumsum():
    """The trainer's own cumsum (ops/segsum.py) feeds the same update."""
    s_ids, s_rows, table = _sorted_stream(3072, 300, 16, seed=5)
    c = _cumsum_rows(_t(s_rows))
    got = tro.apply_csum_updates(_t(table), _t(s_ids), c, lr=0.3, d=16,
                                 skip_ge=300)
    want = jro._apply_csum_updates_jnp(
        jnp.asarray(table), jnp.asarray(s_ids), jnp.asarray(c.numpy()), 0.3,
        "adagrad", 1e-8, 16, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------------ K8 --
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
def test_run_plain_matches_jax(kind, d):
    """K8's plain version: a run longer than RING across blocks, pads at
    id V, duplicates (tests/test_pallas_kernels.py:168-205)."""
    vocab = 300
    s_ids, s_rows, table = _sorted_stream(3 * 1024, vocab, d, seed=10 + d)
    args = (jnp.asarray(table), jnp.asarray(s_ids), jnp.asarray(s_rows))
    want_k = jrun.apply_run_updates(*args, lr=0.25, d=d, kind=kind,
                                    skip_ge=vocab, interpret=True)
    want_f = jrun._apply_run_updates_jnp(*args, 0.25, kind, 1e-8, d, vocab)
    got = trun.apply_run_updates(_t(table), _t(s_ids), _t(s_rows), lr=0.25,
                                 d=d, kind=kind, skip_ge=vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_f), rtol=1e-5,
                               atol=2e-5)
    touched = np.zeros(vocab, bool)
    touched[s_ids[s_ids < vocab]] = True
    np.testing.assert_array_equal(got.numpy()[~touched], table[~touched])
    assert trun.apply_run_updates.launches == 0


def test_run_plain_skips_ids_from_skip_ge():
    """skip_ge below V: runs of ids in [skip_ge, V) are left as they
    are, as in JAX's fallback."""
    s_ids, s_rows, table = _sorted_stream(2048, 300, 8, seed=3)
    got = trun.apply_run_updates(_t(table), _t(s_ids), _t(s_rows), lr=0.25,
                                 d=8, skip_ge=150)
    want = jrun._apply_run_updates_jnp(
        jnp.asarray(table), jnp.asarray(s_ids), jnp.asarray(s_rows), 0.25,
        "adagrad", 1e-8, 8, 150)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got.numpy()[150:], table[150:])


def test_sorted_stream_updates_refuse_bad_inputs():
    table = torch.zeros(64, 128)
    s_ids = torch.zeros(1024, dtype=torch.int32)
    rows = torch.zeros(1024, 8)
    for wrapper, cap in ((tro.apply_csum_updates, 2 ** 30 - 2),
                         (trun.apply_run_updates, 2 ** 29 - 2)):
        with pytest.raises(ValueError, match="id cap"):
            wrapper(table, s_ids, rows, lr=0.1, d=8, skip_ge=cap + 1)
        with pytest.raises(ValueError, match="0 < d"):
            wrapper(table, s_ids, torch.zeros(1024, 128), lr=0.1, d=128)
        with pytest.raises(ValueError, match="multiple of 1024"):
            wrapper(table, s_ids[:1000], rows[:1000], lr=0.1, d=8)
        big = torch.zeros(4096, 128)
        with pytest.raises(ValueError, match="alias"):
            wrapper(big, s_ids, big.view(-1)[:8192].view(1024, 8), lr=0.1,
                    d=8)
        with pytest.raises(ValueError, match="optimizer"):
            wrapper(table, s_ids, rows, lr=0.1, d=8, kind="adam")
    # the JAX wrappers refuse the same caps
    with pytest.raises(ValueError, match="cap"):
        jro.apply_csum_updates(jnp.zeros((64, 128)), jnp.zeros(1024, jnp.int32),
                               jnp.zeros((1024, 8)), 0.1, d=8,
                               skip_ge=2 ** 30 - 1)
    with pytest.raises(ValueError, match="cap"):
        jrun.apply_run_updates(jnp.zeros((64, 128)), jnp.zeros(1024, jnp.int32),
                               jnp.zeros((1024, 8)), 0.1, d=8,
                               skip_ge=2 ** 29 - 1)


# -------------------------------------------------------- table update --
def _mode_tables(mode, d, vocab, rng):
    """(table, acc) in the layout the JAX trainer keeps for `mode`."""
    w = rng.normal(0, 0.01, (vocab, d)).astype(np.float32)
    acc = rng.random(vocab).astype(np.float32)
    if mode in ("fused2", "runfused"):
        return np.array(jro.pack_table(jnp.asarray(w), jnp.asarray(acc))), None
    rows = vocab + (table_pad_rows(BATCH, T) if mode == "dedup" else 0)
    w_all = np.zeros((rows, d), np.float32)
    w_all[:vocab] = w
    a_all = np.zeros(rows, np.float32)
    a_all[:vocab] = acc
    return w_all, a_all


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("d", [64, 16])
@pytest.mark.parametrize("mode", MODES)
def test_table_update_matches_jax(mode, d, kind):
    """One batch's table update in each mode against the JAX trainer's
    _table_update on the same table (n = 1024 · 6 ids, -1 pads)."""
    rng = np.random.default_rng(20 + d)
    vocab = 700
    table, acc = _mode_tables(mode, d, vocab, rng)
    n = BATCH * (T + 1)
    ids = rng.integers(-1, vocab, n).astype(np.int32)
    g = rng.normal(0, 0.01, (n, d)).astype(np.float32)
    lr = 0.3 if kind == "adagrad" else 5.0
    j_table, j_acc, j_over = jsc._table_update(
        jnp.asarray(table),
        jnp.zeros((0,), jnp.float32) if acc is None else jnp.asarray(acc),
        jnp.asarray(ids), jnp.asarray(g),
        JaxTopt(kind=kind, lr=lr, update_mode=mode), vocab)
    p_table = _t(table)
    p_acc = None if acc is None else _t(acc)
    over = tsc._table_update(p_table, _t(ids), _t(g),
                             TableOptConfig(kind=kind, lr=lr,
                                            update_mode=mode), vocab, p_acc)
    assert int(over) == int(j_over) == 0
    np.testing.assert_allclose(p_table.numpy(), np.asarray(j_table), **STATE)
    assert not np.array_equal(p_table.numpy(), table)
    if acc is not None:
        np.testing.assert_allclose(p_acc.numpy(), np.asarray(j_acc), **STATE)
        assert (kind == "sgd") == np.array_equal(p_acc.numpy(), acc)


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
class State:
    """A JAX trainer's result as numpy, with fresh copies of it for
    either package (the JAX trainer consumes what it resumes from)."""
    d: int
    arrays: dict
    result: object
    flat: dict
    table: np.ndarray
    acc: np.ndarray
    opt_leaves: list
    treedef: object

    @classmethod
    def of(cls, d, arrays, r):
        return cls(d, arrays, r, jax_flatten(r.dense_params),
                   np.array(r.table), np.array(r.acc),
                   [np.array(x) for x in jax.tree.leaves(r.opt_state)],
                   jax.tree.structure(r.opt_state))

    def for_jax(self):
        return dataclasses.replace(
            self.result, dense_params=jax_unflatten(
                {k: v.copy() for k, v in self.flat.items()}),
            table=jnp.asarray(self.table.copy()),
            acc=jnp.asarray(self.acc.copy()),
            opt_state=jax.tree.unflatten(
                self.treedef, [jnp.asarray(x) for x in self.opt_leaves]))

    def for_port(self):
        return scanned_from_jax(
            SparseCTR(**_model_cfg(self.d), device="cpu"), self.flat,
            self.table, self.acc, self.opt_leaves,
            list(self.result.loss_curve), device="cpu")


def _start(d, mode="fused"):
    """The JAX trainer's epochs=0 state (in the layout of `mode`)."""
    arrays = _arrays()
    r0 = jsc.train_sparse_scanned(JaxSparseCTR(**_model_cfg(d)),
                                  JaxSample(**arrays),
                                  JaxConfig(batch_size=BATCH, epochs=0,
                                            seed=1),
                                  JaxTopt(update_mode=mode))
    return State.of(d, arrays, r0)


@pytest.fixture(scope="module")
def start64():
    return _start(64)


@pytest.fixture(scope="module")
def start16():
    return _start(16)


def _cfgs(epochs=3, **topt):
    kw = dict(batch_size=BATCH, epochs=epochs, early_stop=0, shuffle=False,
              seed=0)
    return (JaxConfig(**kw), TrainerConfig(**kw), JaxTopt(**topt),
            TableOptConfig(**topt))


_JAX_RUNS = {}


def _train_both(st, epochs=3, **topt):
    """Both trainers from `st`; the JAX run of each (D, epochs, topt) is
    made once in the module and shared."""
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs, **topt)
    key = (id(st), epochs, tuple(sorted(topt.items())))
    if key not in _JAX_RUNS:  # the entry holds st, so its id stays its own
        _JAX_RUNS[key] = st, jsc.train_sparse_scanned(
            st.result.model, JaxSample(**st.arrays), jcfg, jtopt,
            resume_from=st.for_jax())
    jr = _JAX_RUNS[key][1]
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(st.d), device="cpu"),
                              SparseSample(**st.arrays), pcfg, ptopt,
                              resume_from=st.for_port(), device="cpu")
    return pr, jr


def _assert_same_state(pr, jr, rows=None):
    """Loss curves, table and acc (the JAX result's first `rows` rows, all
    by default), dense parameters and solver state."""
    np.testing.assert_allclose(pr.loss_curve, jr.loss_curve, **LOSS)
    assert pr.packed_group == jr.packed_group
    j_table, j_acc = np.asarray(jr.table), np.asarray(jr.acc)
    if rows is not None:
        j_table, j_acc = j_table[:rows], j_acc[:rows]
    np.testing.assert_allclose(pr.table.numpy(), j_table, **STATE)
    if pr.packed_group > 1:
        assert pr.acc is None and np.size(jr.acc) == 0
    else:
        np.testing.assert_allclose(pr.acc.numpy(), j_acc, **STATE)
    flat = jax_flatten(jr.dense_params)
    for k, v in pr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), flat[k], **STATE)
    jleaves = jax.tree.leaves(jr.opt_state)
    assert len(pr.opt_state) == len(jleaves)
    for got, want in zip(pr.opt_state, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE)
    assert pr.update_overflow_max == jr.update_overflow_max == 0


@pytest.mark.parametrize("kind", ["adagrad", "sgd"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [64, 16])
def test_trainer_matches_jax(start64, start16, d, mode, kind):
    """Three epochs from the JAX trainer's epochs=0 state. The result is
    [V, D] + acc in every mode ([V + table_pad_rows, D] in dedup, junk rows
    included); at D = 16 fused2 and runfused train [V, 128] rows, one a
    line, as JAX does."""
    st = start64 if d == 64 else start16
    pr, jr = _train_both(st, kind=kind, lr=0.3 if kind == "adagrad" else 5.0,
                         update_mode=mode)
    _assert_same_state(pr, jr)
    rows = VOCAB + (table_pad_rows(BATCH, T) if mode == "dedup" else 0)
    assert tuple(pr.table.shape) == (rows, d) and pr.table.is_contiguous()
    assert pr.loss_curve[-1] < pr.loss_curve[0]


@pytest.mark.parametrize("mode", ["plain", "sorted"])
def test_trainer_matches_jax_at_two_threads(start16, threads, mode):
    """test_trainer_matches_jax's D = 16 adagrad case with torch at 2
    intra-op threads: the plain and sorted modes add every occurrence of
    a hot id through scatter_add_rows, whose CPU route must not depend on
    the thread count (it drifted past STATE when it did)."""
    threads(2)
    pr, jr = _train_both(start16, kind="adagrad", lr=0.3, update_mode=mode)
    _assert_same_state(pr, jr)


def test_unpacked_modes_train_wide_rows():
    """dedup, sorted and plain take emb_dim >= 128 (no packed line)."""
    st = _start(130, "plain")
    for mode in ("dedup", "plain"):
        pr, jr = _train_both(st, epochs=1, lr=0.3, update_mode=mode)
        _assert_same_state(pr, jr)


def test_runfused_at_d16_keeps_one_row_a_line(start16, monkeypatch):
    """The layout follows the mode, not emb_dim alone: at D = 16 runfused
    gathers and updates [V, 128] rows (group 1), never grouped lines."""
    seen = []
    real = tsc.apply_run_updates

    def spy(table, *a, **kw):
        seen.append(tuple(table.shape))
        return real(table, *a, **kw)

    monkeypatch.setattr(tsc, "apply_run_updates", spy)
    _, pcfg, _, ptopt = _cfgs(epochs=1, lr=0.3, update_mode="runfused")
    train_sparse_scanned(SparseCTR(**_model_cfg(16), device="cpu"),
                         SparseSample(**start16.arrays), pcfg, ptopt,
                         resume_from=start16.for_port(), device="cpu")
    assert seen and set(seen) == {(VOCAB, 128)}
    assert tsc.table_group("runfused", 16) == 1
    assert tsc.table_group("fused", 16) == 7


def _planted(n, vocab, t=5, seed=0):
    """tests/test_scanned_trainer.py's planted rule: label = item parity
    == behavior-majority parity, learnable only through embeddings."""
    rng = np.random.default_rng(seed)
    taste = rng.integers(0, 2, n)
    bids = np.where(rng.random((n, t)) < 0.85,
                    rng.integers(0, vocab // 2, (n, t)) * 2 + taste[:, None],
                    rng.integers(0, vocab, (n, t))).astype(np.int32)
    bids[rng.random((n, t)) < 0.1] = -1
    iids = (rng.integers(0, vocab // 2, n) * 2 +
            rng.integers(0, 2, n)).astype(np.int32)
    y = ((iids % 2) == taste).astype(np.float32)
    return SparseSample(
        user_profile=rng.random((n, 4)).astype(np.float32),
        behavior_ids=bids, item_ids=iids,
        ctx=rng.random((n, 2)).astype(np.float32), labels=y)


def _planted_run(seed, mode, kind, lr):
    vocab = 100
    model = SparseCTR(item_vocab=vocab, emb_dim=8, u_profile_dim=4,
                      ctx_dim=2, behavior_len=5, hidden=(16,), device="cpu")
    cfg = TrainerConfig(batch_size=512, epochs=2, early_stop=0,
                        shuffle=False, seed=3)
    r = train_sparse_scanned(model, _planted(2000, vocab, seed=seed), cfg,
                             TableOptConfig(kind=kind, lr=lr,
                                            update_mode=mode), device="cpu")
    return r.table[:vocab].numpy(), r.acc[:vocab].numpy(), r.loss_curve


def test_sgd_update_modes_are_numerically_identical():
    """The port's version of tests/test_scanned_trainer.py:60-80: sgd is
    linear in the gradient, so plain / sorted / dedup give the same tables
    (same sums, f32 order aside)."""
    tables = {mode: _planted_run(7, mode, "sgd", 5.0)[0]
              for mode in ("plain", "sorted", "dedup")}
    for mode in ("sorted", "dedup"):
        np.testing.assert_allclose(tables[mode], tables["plain"], rtol=1e-5,
                                   atol=1e-7)


def test_fused_matches_dedup_adagrad_exactly():
    """The port's version of tests/test_scanned_trainer.py:83-108: fused,
    runfused and fused2 are row-wise adagrad over summed duplicates, as
    dedup is, so tables, accumulators and losses agree (fused2's cumsum
    differences and grouped fused's line sums at D = 8 cost a few ulps)."""
    out = {mode: _planted_run(11, mode, "adagrad", 0.3)
           for mode in ("dedup", "fused", "runfused", "fused2")}
    for mode in ("fused", "runfused", "fused2"):
        tol = dict(rtol=1e-4, atol=1e-6) if mode in ("fused2", "fused") \
            else dict(rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(out[mode][0], out["dedup"][0], **tol)
        np.testing.assert_allclose(out[mode][1], out["dedup"][1], **tol)
        np.testing.assert_allclose(out[mode][2], out["dedup"][2], rtol=1e-4)


# ------------------------------------------------- resume across layouts --
@pytest.fixture
def resident(monkeypatch):
    """Both packages keep grouped tables in lines from a vocab of 100."""
    monkeypatch.setattr(jsc, "GROUPED_RESIDENT_MIN_V", 100)
    monkeypatch.setattr(tsc, "GROUPED_RESIDENT_MIN_V", 100)


def _continue_both(st, epochs=1, **topt):
    """`st` is a JAX result: resume it in both packages."""
    return _train_both(st, epochs=epochs, lr=0.3, **topt)


@pytest.mark.parametrize("mode", ["runfused", "dedup"])
def test_grouped_lines_resume_in_other_modes(resident, mode):
    """A grouped-resident fused result ([58, 128] lines at D = 16) resumes
    in runfused ([V, 128] rows) and dedup ([V + pad, 16]): both packages
    unpack the lines first."""
    st = _start(16)
    assert st.result.packed_group == 7
    pr, jr = _continue_both(st, epochs=1, compact_cap=2048)
    _assert_same_state(pr, jr)
    assert pr.packed_group == 7
    st1 = State.of(16, st.arrays, jr)
    pr, jr = _continue_both(st1, update_mode=mode)
    _assert_same_state(pr, jr)
    assert pr.packed_group == 1 and len(pr.loss_curve) == 2


def test_dedup_result_resumes_in_fused():
    """A dedup result carries its junk rows ([V + pad, 64]); JAX packs all
    of them, the port the vocab's: the vocab's rows agree."""
    st = _start(64)
    pr, jr = _continue_both(st, update_mode="dedup")
    _assert_same_state(pr, jr)
    st1 = State.of(64, st.arrays, jr)
    assert st1.table.shape[0] == VOCAB + table_pad_rows(BATCH, T)
    pr, jr = _continue_both(st1, update_mode="fused")
    _assert_same_state(pr, jr, rows=VOCAB)
    assert tuple(pr.table.shape) == (VOCAB, 64)
    # and back into dedup from the port's own dedup result
    pd, _ = _continue_both(st, update_mode="dedup")
    again = train_sparse_scanned(
        SparseCTR(**_model_cfg(64), device="cpu"), SparseSample(**st.arrays),
        _cfgs(epochs=1)[1], TableOptConfig(lr=0.3, update_mode="dedup"),
        resume_from=pd, device="cpu")
    assert tuple(again.table.shape) == tuple(pd.table.shape)


def test_dedup_checkpoints_cross_packages(tmp_path):
    """A dedup result saved by either package (trimmed to the vocab)
    resumes in dedup in the other, which extends its junk rows again."""
    from goctr_tpu.parallel.scanned import (
        load_scanned_checkpoint as jax_load,
        save_scanned_checkpoint as jax_save,
    )
    st = _start(64)
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs=1, lr=0.3, update_mode="dedup")
    pr, jr = _continue_both(st, update_mode="dedup")
    jax_save(tmp_path / "jax", jr, jcfg)
    save_scanned_checkpoint(tmp_path / "port", pr, pcfg)
    for src in ("jax", "port"):
        loaded = load_scanned_checkpoint(tmp_path / src, device="cpu")
        assert tuple(loaded.table.shape) == (VOCAB, 64)
        j2 = jsc.train_sparse_scanned(st.result.model,
                                      JaxSample(**st.arrays), jcfg, jtopt,
                                      resume_from=jax_load(tmp_path / src))
        p2 = train_sparse_scanned(SparseCTR(**_model_cfg(64), device="cpu"),
                                  SparseSample(**st.arrays), pcfg, ptopt,
                                  resume_from=loaded, device="cpu")
        _assert_same_state(p2, j2)
        assert len(p2.loss_curve) == 2


# ---------------------------------------------------------------- errors --
def test_trainer_errors_match_jax(start64):
    """An unknown mode and the packed modes at emb_dim >= 128 raise the
    JAX trainer's ValueErrors; the port's `fused` takes emb_dim 128 (the
    weights [V, 128] and the accumulator apart) with the split update and
    the "xla" compaction, and refuses it with K5, which needs the
    accumulator's lane."""
    arrays = _arrays()
    for mode in ("scatter", "fused3"):
        jcfg, pcfg, _, _ = _cfgs(epochs=1)
        with pytest.raises(ValueError, match="unknown update_mode"):
            jsc.train_sparse_scanned(JaxSparseCTR(**_model_cfg(64)),
                                     JaxSample(**arrays), jcfg,
                                     JaxTopt(update_mode=mode))
        with pytest.raises(ValueError, match="unknown update_mode"):
            train_sparse_scanned(SparseCTR(**_model_cfg(64), device="cpu"),
                                 SparseSample(**arrays), pcfg,
                                 TableOptConfig(update_mode=mode),
                                 device="cpu")
    for mode in ("fused", "fused2", "runfused"):
        jcfg, pcfg, _, _ = _cfgs(epochs=1)
        with pytest.raises(ValueError, match="emb_dim < 128"):
            jsc.train_sparse_scanned(JaxSparseCTR(**_model_cfg(128)),
                                     JaxSample(**arrays), jcfg,
                                     JaxTopt(update_mode=mode))
        port_topt = TableOptConfig(update_mode=mode)
        if mode == "fused":
            port_topt.rmw_impl = "kernel"
        with pytest.raises(ValueError, match="emb_dim < 128" if mode !=
                           "fused" else "rmw_impl='split'"):
            train_sparse_scanned(SparseCTR(**_model_cfg(128), device="cpu"),
                                 SparseSample(**arrays), pcfg, port_topt,
                                 device="cpu")


def test_scanned_from_jax_takes_dedup_tables():
    """A JAX dedup result's [V + pad, D] table and acc come across as they
    are (rows, not lines), and serve and save as the vocab's rows."""
    st = _start(64)
    _, jr = _continue_both(st, update_mode="dedup")
    rows = VOCAB + table_pad_rows(BATCH, T)
    p = State.of(64, st.arrays, jr).for_port()
    assert p.packed_group == 1
    assert tuple(p.table.shape) == (rows, 64) and tuple(p.acc.shape) == (rows,)
    np.testing.assert_array_equal(p.table.numpy(), np.asarray(jr.table))
    sample = {k: v[:16] for k, v in st.arrays.items()}
    np.testing.assert_allclose(p.predict(SparseSample(**sample)),
                               np.asarray(jr.predict(JaxSample(**sample))),
                               rtol=1e-5, atol=1e-6)
