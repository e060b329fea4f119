"""The port's mesh trainer (train_sparse on the 1×1 mesh; meshes above
it in tests/test_torch_mesh.py), its lookups,
SparseCTR.apply, predict and sparse checkpoints against the JAX package
on the CPU. The JAX side runs on make_mesh(MeshSpec(1, 1),
devices=jax.devices()[:1]); its fresh state (TrainerConfig(epochs=0))
is carried across with convert.sparse_ranker_from_jax and both packages
resume from it. The shuffle is the same host numpy permutation in both,
so these runs shuffle; dropout is 0 (its streams differ).

Tolerances are those the JAX package holds its mesh step to against the
scanned trainer's math (tests/test_sparse_trainer.py:158-163): loss
curves rtol 2e-5, tables atol 2e-5, adagrad accumulators rtol 2e-4.
Both packages run the same f32 arithmetic and sum in other orders
(matmuls, cumsums, run sums, the K3 pool); after 3 epochs the readings
are ~1e-7 (loss) and ~3e-6 (tables). Dense parameters and solver state:
rtol 1e-4, atol 1e-5 (tests/test_torch_train.py). Overflow counts are
exact; resumes within the port are bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.core.meshes import MeshSpec as JaxMeshSpec
from goctr_tpu.core.meshes import make_mesh as jax_make_mesh
from goctr_tpu.models.io import _flatten_params as jax_flatten
from goctr_tpu.models.io import load_sparse_checkpoint as jax_load
from goctr_tpu.models.trainer import TrainerConfig as JaxConfig
from goctr_tpu.ops.pallas.row_optimizer import pack_table as jax_pack
from goctr_tpu.ops.pallas.row_optimizer import (
    pack_table_grouped as jax_pack_grouped)
from goctr_tpu.parallel.embedding import sharded_lookup as jax_lookup
from goctr_tpu.parallel.embedding import (
    sharded_pooled_lookup as jax_pooled_lookup)
from goctr_tpu.parallel.sparse_ctr import SparseBatch as JaxBatch
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu.parallel.sparse_trainer import train_sparse as jax_train
from goctr_tpu.parallel.table_opt import TableOptConfig as JaxTopt
from goctr_tpu_torch.convert import sparse_ranker_from_jax
from goctr_tpu_torch.core.meshes import (
    Mesh, MeshSpec, make_mesh, single_device_mesh)
from goctr_tpu_torch.models.io import load_sparse_checkpoint
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels.row_optimizer import group_size
from goctr_tpu_torch.parallel import scanned
from goctr_tpu_torch.parallel.embedding import (
    sharded_lookup, sharded_pooled_lookup)
from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch, SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import (
    SparseSample, train_sparse)
from goctr_tpu_torch.parallel.table_opt import TableOptConfig
from goctr_tpu_torch.parallel.train import make_sharded_sparse_train_step

N, T, V = 3000, 5, 400
LOSS = dict(rtol=2e-5)
TABLE = dict(atol=2e-5)
ACC = dict(rtol=2e-4)
STATE = dict(rtol=1e-4, atol=1e-5)
PMESH = single_device_mesh("cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(JaxMeshSpec(data=1, model=1),
                         devices=jax.devices()[:1])


def _mc(d=64, pooling="din_attention", vocab=V, t=T, **kw):
    return dict(item_vocab=vocab, emb_dim=d, u_profile_dim=4, ctx_dim=2,
                behavior_len=t, hidden=(16,), pooling=pooling, **kw)


def _arrays(n=N, vocab=V, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return dict(user_profile=rng.random((n, 4)).astype(np.float32),
                behavior_ids=rng.integers(-1, vocab, (n, t)).astype(np.int32),
                item_ids=rng.integers(0, vocab, n).astype(np.int32),
                ctx=rng.random((n, 2)).astype(np.float32),
                labels=(rng.random(n) > 0.5).astype(np.float32))


def _cfgs(epochs, **kw):
    kw = dict(dict(batch_size=1024, early_stop=0, seed=1), **kw)
    return JaxConfig(epochs=epochs, **kw), TrainerConfig(epochs=epochs, **kw)


def _topts(**topt):
    if not topt:
        return None, None
    return JaxTopt(**topt), TableOptConfig(**topt)


def _jax_start(jmesh, mc, arrays, topt=None):
    """JAX's fresh state (0 epochs) as a JAX ranker and as the port's."""
    jcfg, _ = _cfgs(0)
    j0 = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   table_opt=_topts(**topt)[0] if topt else None)
    return j0, _to_port(j0, mc)


def _to_port(jr, mc):
    layout = ("grouped" if jr.packed_group > 1
              else "packed" if jr.table_packed else "plain")
    dense = {k: v for k, v in jr.params.items() if k != "item_table"}
    return sparse_ranker_from_jax(
        SparseCTR(**mc, device="cpu"), jax_flatten(dense),
        np.array(jr.params["item_table"]),
        None if jr.acc is None else np.array(jr.acc),
        [np.array(x) for x in jax.tree.leaves(jr.opt_state)],
        list(jr.loss_curve), layout=layout, device="cpu")


def _assert_same(pr, jr):
    np.testing.assert_allclose(pr.loss_curve, jr.loss_curve, **LOSS)
    jt = np.asarray(jr.params["item_table"])
    assert tuple(pr.table.shape) == jt.shape
    assert pr.packed_group == jr.packed_group
    np.testing.assert_allclose(pr.table.detach().numpy(), jt, **TABLE)
    assert (pr.acc is None) == (jr.acc is None)
    if pr.acc is not None:
        np.testing.assert_allclose(pr.acc.numpy(), np.asarray(jr.acc), **ACC)
    flat = jax_flatten({k: v for k, v in jr.params.items()
                        if k != "item_table"})
    for k, v in pr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), flat[k], **STATE)
    jleaves = jax.tree.leaves(jr.opt_state)
    assert len(pr.opt_state) == len(jleaves)
    for got, want in zip(pr.opt_state, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE)
    assert pr.lookup_overflow_max == jr.lookup_overflow_max


# ------------------------------------------------------------- lookups --
@pytest.mark.parametrize("layout", ["plain", "packed", "grouped"])
def test_lookups_match_jax(jmesh, layout):
    rng = np.random.default_rng(0)
    d = 8
    w = rng.normal(0, 1, (V, d)).astype(np.float32)
    table = {"plain": w, "packed": np.asarray(jax_pack(jnp.asarray(w))),
             "grouped": np.asarray(jax_pack_grouped(jnp.asarray(w)))}[layout]
    group = group_size(d) if layout == "grouped" else 1
    width = d if layout != "plain" else 0
    ids = rng.integers(-1, V, (16, 7)).astype(np.int32)
    ids[1] = -1
    ids[2, 3] = table.shape[0] * group + 3          # past the table: NaN
    want, over = jax_lookup(jnp.asarray(table), jnp.asarray(ids), jmesh,
                            with_overflow=True, width=width, group=group)
    got, p_over = sharded_lookup(torch.from_numpy(table),
                                 torch.from_numpy(ids), PMESH,
                                 with_overflow=True, width=width, group=group)
    assert int(p_over) == int(over) == 0 and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if layout == "plain":
        ids[2, 3] = 5
        for combiner in ("sum", "mean"):
            want = jax_pooled_lookup(jnp.asarray(w), jnp.asarray(ids), jmesh,
                                     combiner=combiner)
            got = sharded_pooled_lookup(torch.from_numpy(w),
                                        torch.from_numpy(ids), PMESH,
                                        combiner=combiner)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="width"):
        sharded_lookup(torch.from_numpy(table), torch.from_numpy(ids), PMESH,
                       group=3)


@pytest.mark.parametrize("layout", ["plain", "packed", "grouped"])
@pytest.mark.parametrize("pooling", ["din_attention", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax(jmesh, dtype, pooling, layout):
    """Logits of SparseCTR.apply on each table layout. bf16: the JAX pools
    round intermediates the port keeps in f32, which can flip a bf16
    rounding of the tower (tests/test_torch_sparse_ctr.py) — atol 3e-2;
    f32 rtol 2e-5, atol 1e-6."""
    mc = _mc(d=8, pooling=pooling)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JaxSparseCTR(**mc, compute_dtype=jdt)
    params = jm.init_params(jax.random.key(3), jmesh)
    params["att0"] = jnp.linspace(0.5, 1.5, T, dtype=jnp.float32)
    w = params["item_table"]
    g = group_size(8)
    table = {"plain": w, "packed": jax_pack(w),
             "grouped": jax_pack_grouped(w)}[layout]
    kw = dict(table_group=g if layout == "grouped" else 1,
              table_packed=layout == "packed")
    a = _arrays(n=24, seed=4)
    a["behavior_ids"][1] = -1
    want = jm.apply(dict(params, item_table=table),
                    JaxBatch(**{k: jnp.asarray(v) for k, v in a.items()}),
                    jmesh, **kw)
    dense = jax_flatten({k: v for k, v in params.items()
                         if k != "item_table"})
    pr = sparse_ranker_from_jax(SparseCTR(**mc, device="cpu"), dense,
                                np.array(table), layout=layout,
                                device="cpu")
    pr.model.compute_dtype = getattr(torch, dtype)
    with torch.no_grad():
        got = pr.model.apply(pr.table, SparseBatch(
            **{k: torch.from_numpy(v) for k, v in a.items()}), PMESH, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24,)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2)


@pytest.mark.parametrize("pooling", ["din_attention", "mean"])
def test_wide_rows_train_and_predict_match_jax(jmesh, pooling):
    """emb_dim 264, wider than the 256 the port's pools once refused:
    SparseCTR.apply's logits (f32, the weights carried across), one epoch
    of the dense path from JAX's start and predict of the trained ranker,
    held to JAX with the tolerances above."""
    mc, arrays = _mc(d=264, pooling=pooling), _arrays(n=1100)
    j0, p0 = _jax_start(jmesh, mc, arrays)
    a = _arrays(n=24, seed=4)
    a["behavior_ids"][1] = -1
    want = JaxSparseCTR(**mc).apply(
        j0.params, JaxBatch(**{k: jnp.asarray(v) for k, v in a.items()}),
        jmesh)
    with torch.no_grad():
        got = p0.model.apply(p0.table, SparseBatch(
            **{k: torch.from_numpy(v) for k, v in a.items()}), PMESH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)
    jcfg, pcfg = _cfgs(1)
    jr = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   resume_from=j0)
    pr = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, pcfg, resume_from=p0)
    _assert_same(pr, jr)
    test = _arrays(n=50, seed=5)
    np.testing.assert_allclose(
        pr.predict(SparseSample(**test), batch_size=32),
        jr.predict(JaxSample(**test), batch_size=32), rtol=2e-5, atol=1e-6)


# ------------------------------------------------------------ training --
@pytest.mark.parametrize("pooling", ["mean", "din_attention"])
def test_dense_path_matches_jax(jmesh, pooling):
    """table_opt=None: the table trained by adam with the tower (l2 1e-4
    decays it too), shuffled, N = 3000 at batch 1024 (a padded last
    batch); the solver state holds the table's moments in JAX order."""
    mc, arrays = _mc(pooling=pooling), _arrays()
    j0, p0 = _jax_start(jmesh, mc, arrays)
    jcfg, pcfg = _cfgs(3)
    jr = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   resume_from=j0)
    pr = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, pcfg, resume_from=p0)
    # adam's count, mu and nu of att0, bias.0-1, item_table, mlp.0-1,
    # then the schedule's count
    assert len(pr.opt_state) == 2 + 2 * 6
    assert tuple(pr.opt_state[1 + 3].shape) == (V, 64)    # item_table's mu
    assert not pr.table.requires_grad and pr.acc is None
    _assert_same(pr, jr)
    assert pr.loss_curve[-1] < pr.loss_curve[0]


@pytest.mark.parametrize("mode,d,pooling,kind", [
    ("fused", 64, "din_attention", "adagrad"),    # packed rows, G = 1
    ("fused", 8, "din_attention", "adagrad"),     # grouped lines, G = 14
    ("fused2", 8, "din_attention", "adagrad"),    # packed rows at D = 8
    ("runfused", 64, "mean", "adagrad"),
    ("dedup", 8, "din_attention", "sgd"),
    ("plain", 8, "mean", "adagrad"),
])
def test_sparse_path_matches_jax(jmesh, mode, d, pooling, kind):
    """One JAX run (its split and kernel updates are the same math on the
    CPU) against the port under both rmw_impl values."""
    mc, arrays = _mc(d=d, pooling=pooling), _arrays()
    topt = dict(kind=kind, lr=0.3 if kind == "adagrad" else 2.0,
                update_mode=mode)
    j0, p0 = _jax_start(jmesh, mc, arrays, topt)
    jcfg, pcfg = _cfgs(3)
    jtopt, _ = _topts(**topt)
    jr = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   table_opt=jtopt, resume_from=j0)
    for rmw in ("split", "kernel"):
        pr = train_sparse(SparseCTR(**mc, device="cpu"),
                          SparseSample(**arrays), PMESH, pcfg,
                          table_opt=TableOptConfig(**topt, rmw_impl=rmw),
                          resume_from=p0)
        _assert_same(pr, jr)
    assert len(pr.opt_state) == 2 + 2 * 5        # the dense params only


def test_exchange_cap_overflow_matches_jax(jmesh):
    """Every id distinct: 8,192 unique rows a batch against exchange_cap
    1,024 — both drop the same 7,168 updates and count them."""
    n, vocab = 4096, 8192
    rng = np.random.default_rng(0)
    perm = rng.permutation(vocab).astype(np.int32)
    arrays = dict(user_profile=rng.random((n, 4), dtype=np.float32),
                  behavior_ids=perm[:n].reshape(n, 1), item_ids=perm[n:],
                  ctx=rng.random((n, 2), dtype=np.float32),
                  labels=(rng.random(n) > 0.5).astype(np.float32))
    mc = _mc(d=8, vocab=vocab, t=1)
    topt = dict(kind="adagrad", lr=0.1, update_mode="dedup",
                exchange_cap=1024)
    j0, p0 = _jax_start(jmesh, mc, arrays, topt)
    jcfg, pcfg = _cfgs(2, batch_size=n, shuffle=False)
    jr = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   table_opt=_topts(**topt)[0], resume_from=j0)
    pr = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, pcfg, table_opt=TableOptConfig(**topt),
                      resume_from=p0)
    assert pr.lookup_overflow_max == jr.lookup_overflow_max == 2 * n - 1024
    _assert_same(pr, jr)


def test_mesh_step_matches_port_scanned_step():
    """The port's version of JAX's test_sharded_sparse_step_matches_
    scanned_dedup: the mesh step (dedup) and the scanned trainer's math
    (scanned._table_update on [V + junk, D]) from the same start, 4
    batches with pads."""
    vocab, d, t, b = 96, 8, 5, 64
    mc = dict(_mc(d=d, vocab=vocab, t=t), hidden=(16, 8))
    model = SparseCTR(**mc, device="cpu")
    table0 = model.init_params(torch.Generator().manual_seed(0))
    ref = SparseCTR(**mc, device="cpu")
    ref.load_state_dict(model.state_dict())
    topt = TableOptConfig(kind="adagrad", lr=0.05, update_mode="dedup")
    solver = scanned.make_trainer_solver(TrainerConfig(l2=0.0, lr=1e-2))
    step = make_sharded_sparse_train_step(model, solver, PMESH, topt)
    table, acc = table0.clone(), torch.zeros(vocab)
    state = solver.init(model.param_leaves())
    pad = scanned.table_pad_rows(b, t)
    ref_table = torch.cat([table0, torch.zeros(pad, d)])
    ref_acc = torch.zeros(vocab + pad)
    ref_state = solver.init(ref.param_leaves())
    rng = np.random.default_rng(3)
    losses, ref_losses = [], []
    for _ in range(4):
        a = {k: torch.from_numpy(v) for k, v in dict(
            user_profile=rng.random((b, 4)).astype(np.float32),
            behavior_ids=rng.integers(-1, vocab, (b, t)).astype(np.int32),
            item_ids=rng.integers(0, vocab, b).astype(np.int32),
            ctx=rng.random((b, 2)).astype(np.float32),
            labels=(rng.random(b) > 0.5).astype(np.float32)).items()}
        loss, state, over = step(table, state, acc, SparseBatch(**a))
        assert int(over) == 0
        losses.append(float(loss))
        rl, _, ref_state = scanned.train_step(
            ref, ref_table, solver, ref_state, a["user_profile"],
            a["behavior_ids"], a["item_ids"], a["ctx"], a["labels"],
            torch.ones(b), topt, acc=ref_acc)
        ref_losses.append(float(rl))
    np.testing.assert_allclose(losses, ref_losses, **LOSS)
    np.testing.assert_allclose(table.numpy(), ref_table[:vocab].numpy(),
                               **TABLE)
    np.testing.assert_allclose(acc.numpy(), ref_acc[:vocab].numpy(), **ACC)
    assert len(state) == len(ref_state)
    assert all(x.shape[:1] != (vocab,) for x in state)   # no [V, D] leaves


@pytest.mark.parametrize("pooling", ["mean", "din_attention"])
def test_ragged_predict_matches_jax(jmesh, pooling):
    """333 rows at batch 128 (a padded last batch), on JAX's trained
    result and, in the port, on the same table packed and grouped."""
    mc, arrays = _mc(d=8, pooling=pooling), _arrays()
    topt = dict(kind="adagrad", lr=0.3, update_mode="dedup")
    jcfg, _ = _cfgs(1)
    jr = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
                   table_opt=_topts(**topt)[0])
    test = _arrays(n=333, seed=5)
    want = jr.predict(JaxSample(**test), batch_size=128)
    pr = _to_port(jr, mc)
    got = pr.predict(SparseSample(**test), batch_size=128)
    assert got.shape == (333,) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    # the same rows as mid-training snapshots of the packed modes
    for kw, table in (
            (dict(table_packed=True),
             np.asarray(jax_pack(jr.params["item_table"], jr.acc))),
            (dict(packed_group=group_size(8)),
             np.asarray(jax_pack_grouped(jr.params["item_table"],
                                         jr.acc)))):
        snap = dataclasses.replace(pr, table=torch.from_numpy(table), **kw)
        np.testing.assert_allclose(
            snap.predict(SparseSample(**test), batch_size=128), got,
            rtol=1e-5, atol=1e-6)


# ------------------------------------------------ resume, checkpoints --
@pytest.mark.parametrize("mode", [None, "fused", "dedup"])
def test_resume_is_bit_exact(mode, tmp_path):
    """2 epochs + checkpoint + load + 2 epochs == 4 epochs, bit for bit,
    with shuffling and dropout (the replayed streams); epoch_hook sees
    the live loss curve and a snapshot that predicts."""
    mc = _mc(d=8, dropout_rate=0.2)
    arrays = _arrays(n=2000)
    sample = SparseSample(**arrays)
    topt = (None if mode is None else
            TableOptConfig(kind="adagrad", lr=0.3, update_mode=mode))
    kw = dict(batch_size=512, early_stop=0, seed=7, l2=0.0, lr=1e-2)
    full = train_sparse(SparseCTR(**mc, device="cpu"), sample, PMESH,
                        TrainerConfig(epochs=4, **kw), table_opt=topt)
    hook = []
    part = train_sparse(
        SparseCTR(**mc, device="cpu"), sample, PMESH,
        TrainerConfig(epochs=2, **kw), table_opt=topt, checkpoint_every=2,
        checkpoint_path=tmp_path,
        epoch_hook=lambda ep, cost, r: hook.append(
            (ep, cost, float(r.predict(sample, batch_size=2048)[0]))))
    assert [h[0] for h in hook] == [0, 1]
    assert [h[1] for h in hook] == part.loss_curve == full.loss_curve[:2]
    assert all(np.isfinite(h[2]) for h in hook)
    loaded, tc, to = load_sparse_checkpoint(tmp_path, PMESH)
    assert tc == TrainerConfig(epochs=2, **kw) and to == topt
    resumed = train_sparse(SparseCTR(**mc, device="cpu"), sample, PMESH,
                           tc, table_opt=to, resume_from=loaded)
    assert resumed.loss_curve == full.loss_curve
    assert torch.equal(resumed.table, full.table)
    assert (resumed.acc is None and full.acc is None) or torch.equal(
        resumed.acc, full.acc)
    for a, b in zip(resumed.opt_state, full.opt_state):
        assert torch.equal(a, b)
    # the in-memory result resumes the same way, and stays as it was
    before = part.table.clone()
    again = train_sparse(SparseCTR(**mc, device="cpu"), sample, PMESH,
                         tc, table_opt=to, resume_from=part)
    assert again.loss_curve == full.loss_curve
    assert torch.equal(part.table, before)


def test_checkpoints_interchange_with_jax(jmesh, tmp_path):
    """A JAX checkpoint (grouped fused run, 2 epochs) resumes in the port
    as in JAX; the port's checkpoint of that resumes in JAX as in the
    port."""
    mc, arrays = _mc(d=8), _arrays()
    topt = dict(kind="adagrad", lr=0.3, update_mode="fused")
    jtopt, ptopt = _topts(**topt)
    jcfg, pcfg = _cfgs(2)
    jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg,
              table_opt=jtopt, checkpoint_every=2,
              checkpoint_path=tmp_path / "jax")
    jcfg1, pcfg1 = _cfgs(1)
    j3 = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg1,
                   table_opt=jtopt,
                   resume_from=jax_load(tmp_path / "jax", jmesh)[0])
    p2, tc, to = load_sparse_checkpoint(tmp_path / "jax", PMESH)
    assert to == ptopt and tc.epochs == 2 and p2.model.pooling == mc[
        "pooling"]
    p3 = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, pcfg1, table_opt=to, resume_from=p2)
    _assert_same(p3, j3)

    p3.save(tmp_path / "port", trainer_config=pcfg1, table_opt=ptopt)
    j_ck, _, j_to = jax_load(tmp_path / "port", jmesh)
    assert j_to == jtopt
    j4 = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, jcfg1,
                   table_opt=jtopt, resume_from=j_ck)
    p4 = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, pcfg1, table_opt=ptopt,
                      resume_from=load_sparse_checkpoint(tmp_path / "port",
                                                         PMESH)[0])
    assert len(p4.loss_curve) == len(j4.loss_curve) == 4
    _assert_same(p4, j4)


def test_port_loads_jax_dense_path_checkpoint(jmesh, tmp_path):
    """JAX's dense path (table_opt=None) saves a solver state with the
    table's moments, which its own loader cannot read (ROADMAP C); the
    port loads it and its third epoch matches JAX's uninterrupted run."""
    mc, arrays = _mc(pooling="mean"), _arrays()
    j0, _ = _jax_start(jmesh, mc, arrays)
    full = jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh,
                     _cfgs(3)[0], resume_from=j0)
    j0, _ = _jax_start(jmesh, mc, arrays)
    jax_train(JaxSparseCTR(**mc), JaxSample(**arrays), jmesh, _cfgs(2)[0],
              resume_from=j0, checkpoint_every=2, checkpoint_path=tmp_path)
    with pytest.raises(ValueError, match="leaves"):
        jax_load(tmp_path, jmesh)
    loaded, tc, to = load_sparse_checkpoint(tmp_path, PMESH)
    assert to is None and len(loaded.opt_state) == 2 + 2 * 6
    pr = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**arrays),
                      PMESH, dataclasses.replace(tc, epochs=1),
                      resume_from=loaded)
    _assert_same(pr, full)


def test_load_refuses_a_foreign_solver_state(tmp_path):
    mc = _mc(d=8)
    r = train_sparse(SparseCTR(**mc, device="cpu"), SparseSample(**_arrays(
        n=600)), PMESH, TrainerConfig(epochs=1, batch_size=512))
    r.save(tmp_path, trainer_config=TrainerConfig(solver="sgd",
                                                  momentum=0.5))
    with pytest.raises(ValueError, match="solver state"):
        load_sparse_checkpoint(tmp_path, PMESH)


# ------------------------------------------------------------- meshes --
def test_meshes_above_1x1_raise():
    """Without a process group the world is one rank: a mesh of more
    ranks raises ValueError, as a spec that does not resolve does
    (tests/test_torch_mesh.py runs the meshes above 1×1 on gloo ranks)."""
    with pytest.raises(ValueError, match="2x1 != 1 devices"):
        make_mesh(MeshSpec(data=2, model=1), devices=["cpu"])
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(MeshSpec(model=3), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="process group"):
        Mesh(1, 2, torch.device("cpu"))
    m = make_mesh(MeshSpec(data=1, model=1), devices=["cpu"])
    assert m == PMESH and m.shape == {"data": 1, "model": 1}


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        single_device_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        sparse_ranker_from_jax(SparseCTR(**_mc(), device="cpu"), {},
                               np.zeros((V, 64), np.float32))


def test_unsupported_options_raise():
    sample = SparseSample(**_arrays(n=64))
    for topt, what in ((TableOptConfig(update_mode="scatter"),
                        "unknown update_mode"),
                       (TableOptConfig(update_mode="fused2"),
                        "emb_dim < 128")):
        d = 128 if "emb_dim" in what else 8
        with pytest.raises(ValueError, match=what):
            train_sparse(SparseCTR(**_mc(d=d), device="cpu"), sample, PMESH,
                         TrainerConfig(epochs=1), table_opt=topt)
