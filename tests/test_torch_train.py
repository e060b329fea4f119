"""The port's scanned trainer against the JAX trainer on the CPU, the
whole slice: the JAX trainer's initial state (TrainerConfig(epochs=0)) is
carried across with convert.scanned_from_jax and both packages resume
from it with shuffle=False (their random streams differ) and dropout 0,
then train 3 epochs of batch 1024 over 3,000 rows (the last batch has
72 padded rows of weight 0).

Tolerances (those of the JAX package's own kernel-vs-xla trainer parity
test, tests/test_scanned_trainer.py:321-349): loss curves rtol 1e-5;
tables, adagrad accumulators, dense parameters and solver state rtol
1e-4, atol 1e-5. Both run the same f32 arithmetic; sums (matmuls,
cumsums, run sums) add in other orders. Step counts and overflow counts
are exact.
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
from goctr_tpu.parallel.scanned import (
    TableOptConfig as JaxTopt, load_scanned_checkpoint as jax_load,
    save_scanned_checkpoint as jax_save, train_sparse_scanned as jax_train,
)
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu_torch.convert import scanned_from_jax
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, TrainedScanned, load_scanned_checkpoint,
    model_bytes_per_example, model_flops_per_example,
    save_scanned_checkpoint, table_pad_rows, train_sparse_scanned,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

N, T = 3000, 5
LOSS = dict(rtol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-5)


def _model_cfg(vocab):
    return dict(item_vocab=vocab, emb_dim=64, u_profile_dim=4, ctx_dim=2,
                behavior_len=T, hidden=(16,))


def _arrays(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return dict(user_profile=rng.random((N, 4)).astype(np.float32),
                behavior_ids=rng.integers(-1, vocab, (N, T)).astype(np.int32),
                item_ids=rng.integers(0, vocab, N).astype(np.int32),
                ctx=rng.random((N, 2)).astype(np.float32),
                labels=(rng.random(N) > 0.5).astype(np.float32))


@dataclasses.dataclass
class Start:
    """The JAX trainer's initial state as numpy, and fresh copies of it
    for either package (the JAX trainer consumes what it resumes from)."""
    vocab: int
    arrays: dict
    flat: dict
    table: np.ndarray
    acc: np.ndarray
    opt_leaves: list
    treedef: object
    jax_model: JaxSparseCTR

    def jax(self):
        return jax_train(self.jax_model, JaxSample(**self.arrays),
                         JaxConfig(batch_size=1024, epochs=0))

    def for_jax(self):
        r = self.jax()
        return dataclasses.replace(
            r, dense_params=jax_unflatten({k: v.copy()
                                           for k, v in self.flat.items()}),
            table=jnp.asarray(self.table), acc=jnp.asarray(self.acc),
            opt_state=jax.tree.unflatten(
                self.treedef, [jnp.asarray(x) for x in self.opt_leaves]))

    def for_port(self):
        return scanned_from_jax(
            SparseCTR(**_model_cfg(self.vocab), device="cpu"), self.flat,
            self.table, self.acc, self.opt_leaves, [], device="cpu")


def _start(vocab):
    jm = JaxSparseCTR(**_model_cfg(vocab))
    arrays = _arrays(vocab)
    r0 = jax_train(jm, JaxSample(**arrays),
                   JaxConfig(batch_size=1024, epochs=0, seed=1))
    return Start(vocab, arrays, jax_flatten(r0.dense_params),
                 np.array(r0.table), np.array(r0.acc),
                 [np.array(x) for x in jax.tree.leaves(r0.opt_state)],
                 jax.tree.structure(r0.opt_state), jm)


@pytest.fixture(scope="module")
def start():
    return _start(400)


def _cfgs(epochs=3, **topt):
    kw = dict(batch_size=1024, epochs=epochs, early_stop=0, shuffle=False,
              seed=0)
    return (JaxConfig(**kw), TrainerConfig(**kw), JaxTopt(**topt),
            TableOptConfig(**topt))


def _assert_same_state(pr, jr):
    np.testing.assert_allclose(pr.loss_curve, jr.loss_curve, **LOSS)
    np.testing.assert_allclose(pr.table.numpy(), np.asarray(jr.table),
                               **STATE)
    np.testing.assert_allclose(pr.acc.numpy(), np.asarray(jr.acc), **STATE)
    flat = jax_flatten(jr.dense_params)
    for k, v in pr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), flat[k], **STATE)
    jleaves = jax.tree.leaves(jr.opt_state)
    assert len(pr.opt_state) == len(jleaves)
    for got, want in zip(pr.opt_state, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE)
    assert pr.update_overflow_max == jr.update_overflow_max


@pytest.mark.parametrize("kind,cap,impl,sorted_gather", [
    ("adagrad", 0, "xla", False),
    ("adagrad", 2048, "xla", False),
    ("adagrad", 2048, "kernel", False),
    ("sgd", 0, "xla", False),
    ("sgd", 2048, "xla", False),
    ("sgd", 2048, "kernel", False),
    ("adagrad", 2048, "kernel", True),
])
def test_trainer_matches_jax(start, kind, cap, impl, sorted_gather):
    jcfg, pcfg, jtopt, ptopt = _cfgs(
        kind=kind, lr=0.3 if kind == "adagrad" else 5.0, compact_cap=cap,
        compact_impl=impl, sorted_gather=sorted_gather)
    jr = jax_train(start.jax_model, JaxSample(**start.arrays), jcfg, jtopt,
                   resume_from=start.for_jax())
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(start.vocab),
                                        device="cpu"),
                              SparseSample(**start.arrays), pcfg, ptopt,
                              resume_from=start.for_port(), device="cpu")
    _assert_same_state(pr, jr)
    assert pr.loss_curve[-1] < pr.loss_curve[0]
    assert pr.table.is_contiguous() and tuple(pr.table.shape) == (400, 64)
    assert len(pr.epoch_times) == 3


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_overflow_is_detected_like_jax(impl):
    """~1,900 unique ids per batch against a cap of 1,024: both trainers
    drop the same updates and report the same overflow."""
    st = _start(2000)
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs=1, lr=0.3, compact_cap=1024,
                                     compact_impl=impl)
    jr = jax_train(st.jax_model, JaxSample(**st.arrays), jcfg, jtopt,
                   resume_from=st.for_jax())
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(2000), device="cpu"),
                              SparseSample(**st.arrays), pcfg, ptopt,
                              resume_from=st.for_port(), device="cpu")
    assert pr.update_overflow_max > 0
    _assert_same_state(pr, jr)


def test_jax_checkpoint_resumes_in_port_and_back(start, tmp_path):
    """JAX trains 2 epochs and saves (opt_state.npz included); the port
    loads it and trains a 3rd epoch, as JAX does from its own checkpoint.
    Then the port's checkpoint of that result resumes in JAX, and in the
    port, to the same 4th epoch."""
    jcfg, pcfg, jtopt, ptopt = _cfgs(epochs=2, lr=0.3, compact_cap=2048)
    j2 = jax_train(start.jax_model, JaxSample(**start.arrays), jcfg, jtopt,
                   resume_from=start.for_jax())
    jax_save(tmp_path / "jax", j2, jcfg)
    jcfg1, pcfg1, _, _ = _cfgs(epochs=1)
    j3 = jax_train(start.jax_model, JaxSample(**start.arrays), jcfg1, jtopt,
                   resume_from=jax_load(tmp_path / "jax"))
    p2 = load_scanned_checkpoint(tmp_path / "jax", device="cpu")
    assert p2.opt_state is not None and len(p2.opt_state) == len(
        jax.tree.leaves(j3.opt_state))
    p3 = train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                              SparseSample(**start.arrays), pcfg1, ptopt,
                              resume_from=p2, device="cpu")
    assert len(p3.loss_curve) == 3
    _assert_same_state(p3, j3)

    save_scanned_checkpoint(tmp_path / "port", p3, pcfg1)
    j4 = jax_train(start.jax_model, JaxSample(**start.arrays), jcfg1, jtopt,
                   resume_from=jax_load(tmp_path / "port"))
    p4 = train_sparse_scanned(
        SparseCTR(**_model_cfg(400), device="cpu"),
        SparseSample(**start.arrays), pcfg1, ptopt,
        resume_from=load_scanned_checkpoint(tmp_path / "port", device="cpu"),
        device="cpu")
    assert len(p4.loss_curve) == len(j4.loss_curve) == 4
    _assert_same_state(p4, j4)


def test_port_checkpoint_round_trip_and_resume(start, tmp_path):
    """A port result saved and loaded resumes to the same state as the
    result itself; resume_from is left as it was."""
    _, pcfg, _, ptopt = _cfgs(epochs=1, lr=0.3)
    sample = SparseSample(**start.arrays)
    p1 = train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                              sample, pcfg, ptopt,
                              resume_from=start.for_port(), device="cpu")
    save_scanned_checkpoint(tmp_path, p1, pcfg)
    loaded = load_scanned_checkpoint(tmp_path, device="cpu")
    table_before = p1.table.clone()
    a = train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                             sample, pcfg, ptopt, resume_from=p1,
                             device="cpu")
    b = train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                             sample, pcfg, ptopt, resume_from=loaded,
                             device="cpu")
    assert torch.equal(p1.table, table_before)
    assert a.loss_curve == b.loss_curve and len(a.loss_curve) == 2
    assert torch.equal(a.table, b.table) and torch.equal(a.acc, b.acc)


def test_fresh_run_learns_and_is_repeatable():
    """Without resume_from the port draws its own start from the seed;
    shuffled epochs repeat bit for bit from the same seed."""
    arrays = _arrays(400, seed=3)
    cfg = TrainerConfig(batch_size=1024, epochs=3, early_stop=0, seed=5)
    runs = [train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                                 SparseSample(**arrays), cfg,
                                 TableOptConfig(lr=0.3), device="cpu")
            for _ in range(2)]
    assert runs[0].loss_curve == runs[1].loss_curve
    assert torch.equal(runs[0].table, runs[1].table)
    assert runs[0].loss_curve[-1] < runs[0].loss_curve[0]


@pytest.mark.parametrize("change,what", [
    (dict(update_mode="dedup"), "A4"),
    (dict(update_mode="runfused"), "A4"),
    (dict(update_mode="fused2", emb_dim=16), "A4"),
])
def test_unported_modes_raise(change, what):
    mc = _model_cfg(400)
    topt = dict(change)
    if "emb_dim" in topt:
        mc["emb_dim"] = topt.pop("emb_dim")
    with pytest.raises(NotImplementedError, match=what):
        train_sparse_scanned(SparseCTR(**mc, device="cpu"),
                             SparseSample(**_arrays(400)),
                             TrainerConfig(epochs=1), TableOptConfig(**topt),
                             device="cpu")


def test_trainer_defaults_to_the_card(start):
    with pytest.raises(RuntimeError, match="cuda"):
        train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                             SparseSample(**_arrays(400)),
                             TrainerConfig(epochs=1))
    with pytest.raises(RuntimeError, match="cuda"):
        scanned_from_jax(SparseCTR(**_model_cfg(400), device="cpu"),
                         start.flat, start.table)


def test_analytic_counts_match_jax():
    from goctr_tpu.parallel import scanned as jsc
    jm = JaxSparseCTR(**_model_cfg(400))
    pm = SparseCTR(**_model_cfg(400), device="cpu")
    assert table_pad_rows(1024, T) == jsc.table_pad_rows(1024, T)
    assert model_flops_per_example(pm, T) == jsc.model_flops_per_example(
        jm, T)
    for mode in ("fused", "dedup", "sorted", "runfused", "fused2", "plain"):
        for cf in (0.0, 0.2):
            assert model_bytes_per_example(
                pm, T, mode, 0.17, cf) == jsc.model_bytes_per_example(
                    jm, T, mode, 0.17, cf)


def test_trained_result_serves(start):
    """The trained result's table is a contiguous [V, D] tensor that the
    serving path takes as it is."""
    from goctr_tpu_torch.serve.scorer import DeviceScorer
    pr = train_sparse_scanned(SparseCTR(**_model_cfg(400), device="cpu"),
                              SparseSample(**start.arrays), _cfgs(1)[1],
                              TableOptConfig(lr=0.3),
                              resume_from=start.for_port(), device="cpu")
    assert isinstance(pr, TrainedScanned)
    scores = DeviceScorer.from_scanned(pr, device="cpu").score(
        start.arrays["user_profile"][0], start.arrays["behavior_ids"][0],
        start.arrays["ctx"][0], np.arange(20, dtype=np.int32))
    assert scores.shape == (20,) and np.isfinite(scores).all()
    assert pr.predict(SparseSample(**{k: v[:8] for k, v in
                                      start.arrays.items()})).shape == (8,)
