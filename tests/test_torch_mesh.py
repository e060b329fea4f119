"""The port's (data, model) meshes above 1×1 on the CPU: 4 gloo ranks at
(4, 1), (2, 2) and (1, 4), against the JAX package's sharded code on
jax.devices()[:4] of conftest's virtual mesh at the same (d, m), and
against the port's own 1×1 run of the same start.

The ranks run the programs of goctr_tpu_torch/parallel/mesh_cases.py
(spawned children import torch and the port, never JAX or this module):
one launch, from the module-scoped fixture `runs`, builds each
topology's mesh in turn, runs every case and returns global numpy
results; the 1×1 runs are the same cases in this process on
single_device_mesh("cpu"). Lookups, the lookup gradient and the
exchange-cap overflow meet JAX on every topology; each step case and
train case meets JAX on one topology (JAX_TOPO, TRAIN_JAX_TOPO: a JAX
compile a pair, every topology met) and the port's 1×1 on all three.

Tolerances:
  * lookups and overflow counts equal JAX's exactly (a psum of one row
    and zeros is exact); the pooled lookups add the shards' partial sums
    of up to 7 rows in another order than one sum: rtol 1e-5, atol 1e-6
    (the 1×1 pooled tolerance of test_torch_sparse_trainer.py);
  * steps (one and two) and train_sparse against JAX at the same
    topology: test_torch_sparse_trainer.py's LOSS / TABLE / ACC / STATE
    (step accumulators rtol 2e-4 with atol 1e-10: the acc lanes of
    grouped lines are cumsum differences of values down to ~1e-8);
  * steps against the port's 1×1: atol 1e-6 (JAX reads <= 6e-8 there at
    the dryrun's sizes), on grouped lines atol 1e-5: the line updates are
    run sums by cumsum differences over the shard's whole stream, whose
    rounding the first adagrad step of a fresh row (acc ~1e-7) carries
    into its weights — JAX's own (d, m) against its (1, 1) reads 2.3e-6
    in these cases, the port's 3.7e-6;
  * train_sparse against the port's 1×1: TRAIN_1X1, set just above the
    readings it lists (atol 1e-6 but 2e-6 on the dense leaves and 1e-5
    on row-wise adagrad tables, where JAX's own topologies part by as
    much);
  * resume within the port: bit for bit.
"""
import functools

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
from goctr_tpu.optim.optimizers import make_solver as jax_solver
from goctr_tpu.ops.pallas.row_optimizer import pack_table as jax_pack
from goctr_tpu.ops.pallas.row_optimizer import (
    pack_table_grouped as jax_pack_grouped)
from goctr_tpu.ops.pallas.row_optimizer import (
    unpack_table_grouped_np as jax_unpack_grouped)
from goctr_tpu.parallel.embedding import _dedup_flat as jax_dedup_flat
from goctr_tpu.parallel.embedding import sharded_lookup as jax_lookup
from goctr_tpu.parallel.embedding import (
    sharded_pooled_lookup as jax_pooled_lookup)
from goctr_tpu.parallel.sparse_ctr import SparseBatch as JaxBatch
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu.parallel.sparse_trainer import train_sparse as jax_train
from goctr_tpu.parallel.table_opt import TableOptConfig as JaxTopt
from goctr_tpu.parallel.train import (
    batch_shardings as jax_batch_shardings,
    make_sharded_sparse_train_step as jax_sparse_step,
    make_sharded_train_step as jax_dense_step,
    param_shardings as jax_param_shardings)
from goctr_tpu_torch.core.meshes import launch, single_device_mesh
from goctr_tpu_torch.dryrun import dryrun_multichip
from goctr_tpu_torch.ops.kernels.row_optimizer import group_size
from goctr_tpu_torch.parallel.embedding import _dedup_flat
from goctr_tpu_torch.parallel.mesh_cases import rank_cases, run_case

TOPOLOGIES = [(2, 2), (1, 4), (4, 1)]      # (2, 2) first: it checkpoints
IDS = {f"{d}x{m}": (d, m) for d, m in TOPOLOGIES}
N, T, V = 3000, 5, 400
LOSS = dict(rtol=2e-5)
TABLE = dict(atol=2e-5)
ACC = dict(rtol=2e-4)
STATE = dict(rtol=1e-4, atol=1e-5)
STEP_ATOL = 1e-6
GROUPED_STEP_ATOL = 1e-5
STEP_ACC = dict(rtol=2e-4, atol=1e-10)
# train_sparse (2 epochs, 6 steps) on (d, m) against the port's 1×1, just
# above the readings on this file's cases (loss 5.8e-8, table 9.3e-9 on
# the dense path, dense leaves 9.5e-7, solver state 2.8e-9, acc 2.3e-10,
# predict 3.0e-7); row-wise adagrad tables read 4.3e-6 (grouped lines)
# and 2.0e-6 (packed rows), as JAX's own (d, m) against its (1, 1) does
# (4.0e-6, 1.9e-6): rows whose accumulator is still ~1e-7 carry the
# rounding of the shards' partial sums into their weights
TRAIN_1X1 = dict(loss=dict(atol=1e-6, rtol=0), acc=dict(atol=1e-9, rtol=0),
                 state=dict(atol=2e-6, rtol=0))
TRAIN_1X1_ROWWISE_TABLE_ATOL = 1e-5
STEP_LR, STEP_TABLE_LR = 1e-3, 0.05       # the dryrun's adam and adagrad
POOL = dict(rtol=1e-5, atol=1e-6)
PMESH = single_device_mesh("cpu")
CPUS = ["cpu"] * 4
LAYOUTS = ("plain", "packed", "grouped")
STEP_CASES = {          # name: (emb_dim, pooling, table_opt or None)
    "dense-din": (8, "din_attention", None),
    "dense-mean": (8, "mean", None),
    "fused-g1-split": (64, "mean", dict(update_mode="fused")),
    "fused-g1-kernel": (64, "mean", dict(update_mode="fused",
                                         rmw_impl="kernel")),
    "fused-grouped-split": (8, "din_attention", dict(update_mode="fused")),
    "fused-grouped-kernel": (8, "din_attention", dict(update_mode="fused",
                                                      rmw_impl="kernel")),
    "dedup": (8, "din_attention", dict(update_mode="dedup")),
    "sorted": (8, "din_attention", dict(update_mode="sorted")),
    "plain": (8, "din_attention", dict(update_mode="plain")),
}
# JAX's mesh step runs one code for dedup, sorted and plain (the scatter
# pair) and, on the CPU, for rmw_impl split and kernel: one JAX run (of
# the same start) serves each group
JAX_STEP = {"fused-g1-kernel": "fused-g1-split",
            "fused-grouped-kernel": "fused-grouped-split",
            "sorted": "dedup", "plain": "dedup"}
# the topology each JAX step run and train case is held against JAX at
# (a JAX compile a pair; every pair is held to the port's 1×1): each
# topology meets JAX, grouped lines on both axes
JAX_TOPO = {"dense-din": (4, 1), "dense-mean": (1, 4),
            "fused-g1-split": (1, 4), "fused-grouped-split": (2, 2),
            "dedup": (4, 1)}
TRAIN_JAX_TOPO = {"dense-mean": (4, 1), "fused-grouped": (2, 2),
                  "fused-g1-kernel": (1, 4)}
TRAIN_CASES = {         # name: (emb_dim, pooling, table_opt or None)
    "dense-mean": (8, "mean", None),
    "fused-grouped": (8, "din_attention", dict(kind="adagrad", lr=0.3,
                                               update_mode="fused")),
    "fused-g1-kernel": (64, "din_attention",
                        dict(kind="adagrad", lr=0.3, update_mode="fused",
                             rmw_impl="kernel")),
}


def _mc(d=8, pooling="din_attention", vocab=V, t=T):
    return dict(item_vocab=vocab, emb_dim=d, u_profile_dim=4, ctx_dim=2,
                behavior_len=t, hidden=(16,), pooling=pooling)


def _arrays(n=N, vocab=V, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return dict(user_profile=rng.random((n, 4)).astype(np.float32),
                behavior_ids=rng.integers(-1, vocab, (n, t)).astype(np.int32),
                item_ids=rng.integers(0, vocab, n).astype(np.int32),
                ctx=rng.random((n, 2)).astype(np.float32),
                labels=(rng.random(n) > 0.5).astype(np.float32))


def _jmesh(topo):
    d, m = topo
    return jax_make_mesh(JaxMeshSpec(data=d, model=m),
                         devices=jax.devices()[:d * m])


# the JAX lookups jitted (eager shard_map takes seconds a call)
_STATIC = ("mesh", "dedup_cap", "with_overflow", "width", "group",
           "combiner")
jit_lookup = jax.jit(jax_lookup, static_argnames=_STATIC[:5])
jit_pooled = jax.jit(jax_pooled_lookup, static_argnames=("mesh",
                                                         "combiner"))


# ------------------------------------------------------------- inputs --
def _lookup_inputs():
    """(name, case) of every lookup: three layouts, 2-D and 1-D ids with
    pads; dedup_cap off, overflowing (8) and roomy (128) on the 2-D ids."""
    rng = np.random.default_rng(0)
    d = 8
    w = rng.normal(0, 1, (V, d)).astype(np.float32)
    g = group_size(d)
    lines = np.asarray(jax_pack_grouped(jnp.asarray(np.concatenate(
        [w, np.zeros((448 - V, d), np.float32)]))))        # 4·G rows
    tables = {"plain": (w, 0, 1), "packed": (np.asarray(jax_pack(
        jnp.asarray(w))), d, 1), "grouped": (lines, d, g)}
    ids2 = rng.integers(-1, V, (16, 7)).astype(np.int32)
    ids2[1] = -1
    ids1 = rng.integers(-1, V, 16).astype(np.int32)
    out = {}
    for layout, (table, width, group) in tables.items():
        for shape, ids, cap in (("2d", ids2, 0), ("2d", ids2, 8),
                                ("2d", ids2, 128), ("1d", ids1, 0)):
            out[f"{layout}-{shape}-cap{cap}"] = dict(
                kind="lookup", table=table, ids=ids, width=width,
                group=group, dedup_cap=cap)
    return out


def _pool_inputs():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (V, 8)).astype(np.float32)
    ids = rng.integers(-1, V, (16, 7)).astype(np.int32)
    ids[2] = -1
    return {c: dict(kind="pooled", table=w, ids=ids, combiner=c)
            for c in ("sum", "mean")}


def _grad_input():
    ids = np.random.default_rng(2).integers(-1, 24, (16, 3)).astype(
        np.int32)
    return dict(kind="lookup_grad", table=np.ones((24, 2), np.float32),
                ids=ids)


def _step_start(name):
    """JAX's fresh dense parameters and plain table (seed 3) for a step
    case, and its two global batches (64 rows)."""
    d, pooling, _ = STEP_CASES[name]
    mc = _mc(d=d, pooling=pooling)
    params = JaxSparseCTR(**mc).init_params(jax.random.key(3),
                                            _jmesh((1, 1)))
    dense = {k: v for k, v in params.items() if k != "item_table"}
    return (mc, jax_flatten(dense), np.asarray(params["item_table"]),
            [_arrays(64, seed=s) for s in (11, 12)])


def _step_case(name):
    d, pooling, topt = STEP_CASES[name]
    mc, flat, table, batches = _step_start(name)
    if topt is None:
        return dict(kind="dense_steps", model=mc, dense=flat, table=table,
                    batches=batches, lr=STEP_LR)
    return dict(kind="sparse_steps", model=mc, dense=flat, table=table,
                batches=batches, lr=STEP_LR,
                table_opt=dict(kind="adagrad", lr=STEP_TABLE_LR, **topt))


def _overflow_case():
    """4096 rows of one behavior and an item, ids repeating (behaviors
    from 3000, items from the 8192 of the vocab): against exchange_cap
    1024 every chunk of the update stream drops uniques past the cap."""
    n, vocab = 4096, 8192
    rng = np.random.default_rng(0)
    arrays = dict(user_profile=rng.random((n, 4), dtype=np.float32),
                  behavior_ids=rng.integers(0, 3000, (n, 1)).astype(
                      np.int32),
                  item_ids=rng.integers(0, vocab, n).astype(np.int32),
                  ctx=rng.random((n, 2), dtype=np.float32),
                  labels=(rng.random(n) > 0.5).astype(np.float32))
    mc = _mc(d=8, vocab=vocab, t=1)
    params = JaxSparseCTR(**mc).init_params(jax.random.key(4),
                                            _jmesh((1, 1)))
    dense = {k: v for k, v in params.items() if k != "item_table"}
    return dict(kind="sparse_steps", model=mc, dense=jax_flatten(dense),
                table=np.asarray(params["item_table"]), batches=[arrays],
                lr=STEP_LR,
                table_opt=dict(kind="adagrad", lr=0.1, update_mode="dedup",
                               exchange_cap=1024))


def _cfgs(epochs, **kw):
    kw = dict(dict(batch_size=1024, early_stop=0, seed=1), **kw)
    return JaxConfig(epochs=epochs, **kw), dict(epochs=epochs, **kw)


@functools.lru_cache(maxsize=None)
def _jax_start(topo, name):
    """JAX's fresh state (0 epochs) on the topology, as the port's start
    (the JAX ranker's arrays and layout)."""
    d, pooling, topt = TRAIN_CASES[name]
    mc = _mc(d=d, pooling=pooling)
    jcfg, _ = _cfgs(0)
    j0 = jax_train(JaxSparseCTR(**mc), JaxSample(**_arrays()), _jmesh(topo),
                   jcfg, table_opt=JaxTopt(**topt) if topt else None)
    layout = ("grouped" if j0.packed_group > 1
              else "packed" if j0.table_packed else "plain")
    dense = {k: v for k, v in j0.params.items() if k != "item_table"}
    start = dict(dense=jax_flatten(dense),
                 table=np.array(j0.params["item_table"]),
                 acc=None if j0.acc is None else np.array(j0.acc),
                 opt_state=[np.array(x) for x in
                            jax.tree.leaves(j0.opt_state)],
                 loss_curve=list(j0.loss_curve), layout=layout)
    return j0, start


@functools.lru_cache(maxsize=None)
def _port_1x1_train(name):
    """The port's 1×1 run of a train case."""
    return run_case(_train_case(name), PMESH)


def _train_case(name, ckpt=None):
    """A train case from JAX's (1, 1) start, whose values JAX's start on
    every topology shares (its table padded to the topology with zero
    rows, which no id reaches): each rank keeps its rows of it."""
    d, pooling, topt = TRAIN_CASES[name]
    _, start = _jax_start((1, 1), name)
    case = dict(kind="train", model=_mc(d=d, pooling=pooling),
                cfg=_cfgs(2)[1], table_opt=topt, sample=_arrays(),
                test=_arrays(n=333, seed=5), predict_batch=128,
                start=start)
    if ckpt is not None:
        case["save_to"] = str(ckpt)
    return case


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's 1×1 runs (the ranks set
    theirs): with the suite's parallel workers each holding every core,
    more threads only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at every topology: {topology: {case name: result}},
    from one 4-rank launch that builds the topologies' meshes in turn;
    (2, 2) checkpoints its fused-grouped run, which (1, 4) loads and
    trains one more epoch."""
    tmp = tmp_path_factory.mktemp("mesh")
    work = {}
    for topo in TOPOLOGIES:
        cases = {"mesh": dict(kind="mesh", bad_specs=[
            ((3, 1), CPUS), ((1, 3), CPUS), ((2, 1), CPUS)])}
        cases.update(_lookup_inputs())
        cases.update({f"pool-{k}": v for k, v in _pool_inputs().items()})
        cases["grad"] = _grad_input()
        cases.update({f"step-{k}": _step_case(k) for k in STEP_CASES})
        cases["overflow"] = _overflow_case()
        for name in TRAIN_CASES:
            ckpt = (tmp / "port22" if topo == (2, 2)
                    and name == "fused-grouped" else None)
            cases[f"train-{name}"] = _train_case(name, ckpt)
        if topo == (2, 2):
            cases["resume"] = dict(
                kind="resume", model=dict(_mc(d=8), dropout_rate=0.2),
                cfg=dict(epochs=3, batch_size=512, early_stop=0, seed=7,
                         l2=0.0, lr=1e-2),
                sample=_arrays(n=2000), split=2, path=str(tmp / "resume"),
                table_opt=dict(kind="adagrad", lr=0.3, update_mode="fused"))
        if topo == (1, 4):
            cases["load"] = dict(
                kind="train", model=_mc(d=8), cfg=_cfgs(1)[1],
                table_opt=TRAIN_CASES["fused-grouped"][2],
                sample=_arrays(), load_from=str(tmp / "port22"))
        work[topo] = cases
    got = launch(rank_cases, 4, CPUS, "gloo", timeout=600, args=(
        CPUS, [(topo, list(cases.values())) for topo, cases in work.items()]))
    out = {}
    for i, (topo, cases) in enumerate(work.items()):
        names = list(cases)
        ranks = [r[i] for r in got]
        for r in ranks[1:]:           # every rank returns the global result
            for k, a, b in zip(names, ranks[0], r):
                if k != "mesh":
                    _assert_tree(a, b, k)
        out[topo] = dict(cases=cases, ranks=ranks,
                         results=dict(zip(names, ranks[0])))
    out["ckpt"] = tmp / "port22"
    return out


def _assert_tree(got, want, what=""):
    """got equals want exactly, through dicts and lists."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for a, b in zip(got, want):
            _assert_tree(a, b, what)
    elif want is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


# ---------------------------------------------------------------- mesh --
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_mesh_coordinates_and_groups_match_jax(runs, topo):
    d, m = topo
    grid = np.asarray([dv.id for dv in _jmesh(topo).devices.flat]).reshape(
        d, m)
    for r, res in enumerate(runs[topo]["ranks"]):
        got = res[0]
        i, j = (int(x[0]) for x in np.nonzero(grid == r))
        assert got["rank"] == r and tuple(got["coords"]) == (i, j)
        assert got["model_group"] == (sorted(grid[i].tolist()) if m > 1
                                      else None)
        assert got["data_group"] == (sorted(grid[:, j].tolist()) if d > 1
                                     else None)
        errs = got["errors"]
        assert len(errs) == 3 and "not divisible by model=3" in errs[1]
        assert "3x1 != 4" in errs[0] and "2x1 != 4" in errs[2]


def test_dedup_flat_matches_jax():
    rng = np.random.default_rng(0)
    for flat, cap in ((np.array([5, 3, 5, 5, -1, 3, 9], np.int32), 8),
                      (rng.integers(-1, 50, 200).astype(np.int32), 64),
                      (rng.integers(-1, 50, 200).astype(np.int32), 16)):
        ju, ji, jn = jax_dedup_flat(jnp.asarray(flat), cap)
        pu, pi, pn = _dedup_flat(torch.from_numpy(flat), cap)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        assert int(pn) == int(jn)


# ------------------------------------------------------------- lookups --
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_lookups_match_jax(runs, topo, layout):
    """Exactly JAX's rows and overflow counts at the same topology, and
    the 1×1 rows wherever no id overflowed."""
    res = runs[topo]["results"]
    jm = _jmesh(topo)
    for name, case in runs[topo]["cases"].items():
        if not name.startswith(layout + "-"):
            continue
        want, over = jit_lookup(
            jnp.asarray(case["table"]), jnp.asarray(case["ids"]), mesh=jm,
            dedup_cap=case["dedup_cap"], with_overflow=True,
            width=case["width"], group=case["group"])
        got = res[name]
        np.testing.assert_array_equal(got["out"], np.asarray(want), name)
        assert got["overflow"] == int(over), name
        if got["overflow"] == 0:
            one = run_case(case, PMESH)
            np.testing.assert_array_equal(got["out"], one["out"], name)
    caps = {n: res[n]["overflow"] for n in res
            if n.startswith(layout + "-")}
    assert caps[f"{layout}-2d-cap8"] > 0 and caps[f"{layout}-2d-cap128"] == 0


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_pooled_lookup_matches_jax(runs, topo, combiner):
    case = runs[topo]["cases"][f"pool-{combiner}"]
    got = runs[topo]["results"][f"pool-{combiner}"]["out"]
    want = jit_pooled(jnp.asarray(case["table"]), jnp.asarray(case["ids"]),
                      mesh=_jmesh(topo), combiner=combiner)
    _close(got, want, POOL, combiner)
    _close(got, run_case(case, PMESH)["out"], POOL, combiner)


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_lookup_gradient_counts_rows(runs, topo):
    """d/dtable of sum(lookup(table, ids)): each row's count of ids, in
    both columns, as JAX's grad gives it at the same topology."""
    case = runs[topo]["cases"]["grad"]
    got = runs[topo]["results"]["grad"]["grad"]
    ids = case["ids"]
    counts = np.bincount(ids[ids >= 0], minlength=24).astype(np.float32)
    np.testing.assert_array_equal(got, np.stack([counts, counts], 1))
    jm = _jmesh(topo)
    want = jax.jit(jax.grad(lambda t: jnp.sum(jax_lookup(
        t, jnp.asarray(ids), jm))))(jnp.asarray(case["table"]))
    np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------- steps --
def _jax_steps(topo, case):
    """JAX's two steps (make_sharded_train_step or make_sharded_sparse_
    train_step, adam, table adagrad) from the case's start on the
    topology: per step the loss, overflow, plain [V, D] table and [V]
    acc, dense params and (dense path) the table's adam moments."""
    mesh = _jmesh(topo)
    mc = case["model"]
    model = JaxSparseCTR(**mc)
    solver = jax_solver("adam", case["lr"])
    vocab, d = case["table"].shape
    m = topo[1]
    topt = case.get("table_opt")
    g = group_size(d) if topt and topt["update_mode"] == "fused" else 1
    packed = bool(topt) and topt["update_mode"] in ("fused", "runfused",
                                                    "fused2")
    mult = m * (g if packed else 1)
    v_pad = -(-vocab // mult) * mult
    w = np.concatenate([case["table"], np.zeros((v_pad - vocab, d),
                                                np.float32)])
    dense = _jax_dense(case["dense"])
    bsh = jax_batch_shardings(mesh)
    steps = []
    if topt is None:
        params = dict(dense, item_table=jnp.array(w))
        state = solver.init(params)
        params = jax.device_put(params, jax_param_shardings(params, mesh))
        state = jax.device_put(state, jax_param_shardings(state, mesh))
        step = jax_dense_step(model, solver, mesh)
    else:
        table = (jax_pack_grouped(jnp.array(w)) if packed and g > 1
                 else jax_pack(jnp.array(w)) if packed
                 else jnp.array(w))
        params = dict(dense, item_table=table)
        params = jax.device_put(params, jax_param_shardings(params, mesh))
        state = solver.init(dense)
        acc = jnp.zeros((table.shape[0],), jnp.float32)
        step = jax_sparse_step(model, solver, mesh, JaxTopt(**topt))
    for i, arrays in enumerate(case["batches"]):
        batch = JaxBatch(**{k: jax.device_put(v, getattr(bsh, k))
                            for k, v in arrays.items()})
        key = jax.random.key(100 + i)
        if topt is None:
            params, state, loss = step(params, state, batch, key)
            over = 0
            tbl = np.array(params["item_table"])[:vocab]
            a = None
            moments = [np.array(x)[:vocab] for x in jax.tree.leaves(state)
                       if np.shape(x) == (v_pad, d)]
        else:
            params, state, acc, loss, over = step(params, state, acc, batch,
                                                  key)
            arr = np.array(params["item_table"])
            if packed and g > 1:
                tbl, a = jax_unpack_grouped(arr, vocab, d)
            elif packed:
                tbl, a = arr[:vocab, :d], arr[:vocab, d]
            else:
                tbl, a = arr[:vocab], np.array(acc)[:vocab]
            moments = []
        flat = jax_flatten({k: v for k, v in params.items()
                            if k != "item_table"})
        steps.append(dict(loss=float(loss), overflow=int(over), table=tbl,
                          acc=a, dense=flat, moments=moments))
    return steps


@functools.lru_cache(maxsize=None)
def _jax_step_run(topo, name):
    return _jax_steps(topo, _step_case(name))


@functools.lru_cache(maxsize=None)
def _port_1x1_steps(name):
    """The port's 1×1 steps of a step case (the same at every topology)."""
    return run_case(_step_case(name), PMESH)["steps"]


def _jax_dense(flat):
    """The JAX params dict of flattened dense params (att0, bias.i,
    mlp.i)."""
    n = len([k for k in flat if k.startswith("mlp.")])

    def arr(k):      # a copy: the steps donate their inputs
        return jnp.array(np.array(flat[k]))
    return {"att0": arr("att0"),
            "bias": [arr(f"bias.{i}") for i in range(n)],
            "mlp": [arr(f"mlp.{i}") for i in range(n)]}


def _assert_step(got, want, tol, what):
    _close(got["loss"], want["loss"], tol.get("loss", LOSS), what + " loss")
    _close(got["table"], want["table"], tol.get("table", TABLE),
           what + " table")
    if want.get("acc") is not None:
        _close(got["acc"], want["acc"], tol.get("acc", STEP_ACC),
               what + " acc")
    for k, v in want["dense"].items():
        _close(got["dense"][k], v, tol.get("state", STATE), f"{what} {k}")


@pytest.mark.parametrize("name", list(STEP_CASES))
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_steps_match_1x1(runs, topo, name):
    """One and two steps against the port's 1×1 steps from the same start
    (atol 1e-6, every array of the state, the adam moments included)."""
    got = runs[topo]["results"][f"step-{name}"]["steps"]
    one = _port_1x1_steps(name)
    atol = GROUPED_STEP_ATOL if "grouped" in name else STEP_ATOL
    tight = dict(loss=dict(atol=STEP_ATOL, rtol=0),
                 table=dict(atol=atol, rtol=0),
                 acc=dict(atol=STEP_ATOL, rtol=0),
                 state=dict(atol=STEP_ATOL, rtol=0))
    for i in range(2):
        assert got[i].get("overflow", 0) == 0
        assert len(got[i]["opt_state"]) == len(one[i]["opt_state"])
        for a, b in zip(got[i]["opt_state"], one[i]["opt_state"]):
            _close(a, b, tight["state"], f"{name} step {i + 1} opt state")
        one_i = dict(one[i], dense={k: np.asarray(v) for k, v in
                                    one[i]["dense"].items()})
        _assert_step(got[i], one_i, tight, f"{name} step {i + 1} vs 1x1")


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_steps_match_jax(runs, name):
    """One and two steps against JAX's step at the same topology (LOSS /
    TABLE / ACC / STATE), at the topology JAX_TOPO gives the case's JAX
    run; on the dense path the table's adam moments too."""
    jname = JAX_STEP.get(name, name)
    topo = JAX_TOPO[jname]
    got = runs[topo]["results"][f"step-{name}"]["steps"]
    want = _jax_step_run(topo, jname)
    for i in range(2):
        _assert_step(got[i], want[i], {}, f"{name} step {i + 1} vs JAX")
        assert got[i].get("overflow", 0) == want[i]["overflow"] == 0
    if STEP_CASES[name][2] is None:
        mom = [x for x in got[1]["opt_state"]
               if np.shape(x) == np.shape(got[1]["table"])]
        assert len(mom) == len(want[1]["moments"]) == 2
        for a, b in zip(mom, want[1]["moments"]):
            _close(a, b, STATE, f"{name} table moments vs JAX")


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_exchange_cap_overflow_matches_jax(runs, topo):
    """A full exchange_cap on any (d, m): the dropped uniques are counted
    once (summed over `data` only) and the same ids are dropped as in
    JAX, which cuts the flattened global stream [behaviors; items] into d
    chunks and compacts each: the count is the chunks' uniques past the
    cap, and the tables after the step agree."""
    case = runs[topo]["cases"]["overflow"]
    got = runs[topo]["results"]["overflow"]["steps"][0]
    want = _jax_steps(topo, dict(case, batches=case["batches"] * 2))[0]
    arrays = case["batches"][0]
    stream = np.concatenate([arrays["behavior_ids"].ravel(),
                             arrays["item_ids"]])
    chunks = np.split(stream, topo[0])
    dropped = sum(max(len(np.unique(c)) - 1024, 0) for c in chunks)
    assert dropped > 0
    assert got["overflow"] == want["overflow"] == dropped
    _assert_step(got, want, {}, "overflow step vs JAX")
    moved = [int(np.sum(np.any(x["table"] != case["table"], axis=1)))
             for x in (got, want)]
    assert moved[0] == moved[1] == len(np.unique(np.concatenate(
        [np.sort(np.unique(c))[:1024] for c in chunks])))


# ---------------------------------------------------------- train_sparse --
def _assert_ranker(got, want_curve, want_table, want_acc, want_dense,
                   want_state, what, tol=None):
    tol = tol or dict(loss=LOSS, table=TABLE, acc=ACC, state=STATE)
    _close(got["loss_curve"], want_curve, tol["loss"], what + " loss curve")
    _close(got["table"], want_table, tol["table"], what + " table")
    if want_acc is not None:
        _close(got["acc"], want_acc, tol["acc"], what + " acc")
    for k, v in want_dense.items():
        _close(got["dense"][k], v, tol["state"], f"{what} {k}")
    assert len(got["opt_state"]) == len(want_state)
    for a, b in zip(got["opt_state"], want_state):
        _close(a, b, tol["state"], what + " opt state")


@pytest.mark.parametrize("name", list(TRAIN_CASES))
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=list(IDS))
def test_train_sparse_matches_1x1(runs, topo, name):
    """2 shuffled epochs from JAX's fresh state (N = 3000 at batch 1024:
    a padded last batch) and predict of 333 rows at batch 128 (ragged),
    against the port's 1×1 run of that start (TRAIN_1X1)."""
    got = runs[topo]["results"][f"train-{name}"]
    one = _port_1x1_train(name)
    sparse = TRAIN_CASES[name][2] is not None
    tol = dict(TRAIN_1X1, table=dict(
        atol=TRAIN_1X1_ROWWISE_TABLE_ATOL if sparse else STEP_ATOL, rtol=0))
    _assert_ranker(got, one["loss_curve"], one["table"], one["acc"],
                   one["dense"], one["opt_state"], f"{name} vs 1x1", tol)
    assert got["overflow"] == 0
    assert got["predict"].shape == (333,)
    _close(got["predict"], one["predict"], dict(atol=STEP_ATOL, rtol=0),
           f"{name} predict vs 1x1")


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_sparse_matches_jax(runs, name):
    """The same run against JAX's from its start on the same topology
    (TRAIN_JAX_TOPO), predict included."""
    topo = TRAIN_JAX_TOPO[name]
    case = runs[topo]["cases"][f"train-{name}"]
    got = runs[topo]["results"][f"train-{name}"]
    j0, _ = _jax_start(topo, name)
    jcfg, _ = _cfgs(2)
    topt = TRAIN_CASES[name][2]
    jr = jax_train(JaxSparseCTR(**case["model"]), JaxSample(**_arrays()),
                   _jmesh(topo), jcfg,
                   table_opt=JaxTopt(**{k: v for k, v in topt.items()
                                        if k != "rmw_impl"}) if topt
                   else None, resume_from=j0)
    d = case["model"]["emb_dim"]
    arr = np.asarray(jr.params["item_table"])
    if jr.packed_group > 1:
        w, a = jax_unpack_grouped(arr, V, d)
    else:
        w, a = arr[:V], None if jr.acc is None else np.asarray(jr.acc)[:V]
    vp = arr.shape[0]
    state = [np.asarray(x)[:V] if np.shape(x) == (vp, d) else np.asarray(x)
             for x in jax.tree.leaves(jr.opt_state)]
    _assert_ranker(got, jr.loss_curve, w, a,
                   jax_flatten({k: v for k, v in jr.params.items()
                                if k != "item_table"}), state,
                   f"{name} vs JAX")
    assert got["overflow"] == jr.lookup_overflow_max == 0
    test = JaxSample(**case["test"])
    _close(got["predict"], jr.predict(test, batch_size=128),
           dict(rtol=2e-5, atol=1e-6), f"{name} predict vs JAX")


def test_checkpoints_interchange_across_topologies(runs):
    """The (2, 2) grouped fused run's checkpoint, one more epoch: loaded
    by the port on (1, 4) and on 1×1 and by JAX on (1, 4) and on 1×1 —
    all four agree."""
    got = runs[(1, 4)]["results"]["load"]
    case = runs[(1, 4)]["cases"]["load"]
    one = run_case(case, PMESH)
    jcfg, _ = _cfgs(1)
    topt = JaxTopt(**TRAIN_CASES["fused-grouped"][2])
    for topo in ((1, 4), (1, 1)):
        jm = _jmesh(topo)
        start, _, jto = jax_load(runs["ckpt"], jm)
        assert jto == topt
        jr = jax_train(JaxSparseCTR(**case["model"]), JaxSample(**_arrays()),
                       jm, jcfg, table_opt=topt, resume_from=start)
        w, a = jax_unpack_grouped(np.asarray(jr.params["item_table"]), V, 8) \
            if jr.packed_group > 1 else (
                np.asarray(jr.params["item_table"])[:V],
                np.asarray(jr.acc)[:V])
        dense = jax_flatten({k: v for k, v in jr.params.items()
                             if k != "item_table"})
        state = [np.asarray(x) for x in jax.tree.leaves(jr.opt_state)]
        assert len(jr.loss_curve) == 3
        for res, what in ((got, "port (1, 4)"), (one, "port 1x1")):
            _assert_ranker(res, jr.loss_curve, w, a, dense, state,
                           f"{what} vs JAX {topo}")


def test_resume_is_bit_exact_on_a_mesh(runs):
    """(2, 2), dropout 0.2: 2 epochs + checkpoint + load + 1 epoch == 3
    epochs, bit for bit (table, solver state, loss curve)."""
    res = runs[(2, 2)]["results"]["resume"]
    assert res["same_table"] and res["same_state"]
    assert res["resumed"]["loss_curve"] == res["full"]["loss_curve"]
    assert len(res["full"]["loss_curve"]) == 3
    np.testing.assert_array_equal(res["resumed"]["table"],
                                  res["full"]["table"])


def test_dryrun_multichip_on_gloo_ranks():
    found = dryrun_multichip(4, device="cpu")
    assert set(found) == {"1x1", "4x1", "2x2", "1x4"}
    for topo, losses in found.items():
        assert all(np.isfinite(losses[k]) for k in ("dense", "grouped",
                                                     "packed")), topo


def test_a_failing_rank_fails_the_launch():
    """A rank that raises kills the others (blocked in a collective) and
    the error carries its traceback."""
    with pytest.raises(RuntimeError, match=r"(?s)rank \d:.*does not split"):
        launch(rank_cases, 2, ["cpu"] * 2, "gloo",
               args=(["cpu"] * 2, [((1, 2), [dict(
                   kind="lookup", table=np.zeros((3, 2), np.float32),
                   ids=np.zeros((2,), np.int32))])]), timeout=120)


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="cuda:0"):
        launch(rank_cases, 2, ["cuda:0", "cuda:0"], "nccl",
               args=(["cuda:0"] * 2, []))
