"""DLRMDCNv2 (parallel/dlrm.py) against the plain reference of the
benchmark's dlrm_dcnv2 family (benchmark/families/dlrm_dcnv2_reference.py,
plain PyTorch in float32 that imports nothing of the port), at small
widths on the CPU: 4 features of hotness 1, 3, 5 and 2, D 16 and 128, a
cross net of 2 layers at rank 4, small MLPs. The port runs its kernels'
plain versions here (K3's with column offsets, the "xla" compaction's,
K1's and K4's). No JAX.

Tolerances, and why:
  * float32 configuration (FP32): the port and the reference add the same
    float32 terms in other orders (matrix products, the bag sums, the
    compaction's run sums as cumsum differences), a few float32 ulps on a
    logit and on each gradient (read: up to 1.1e-6): relative 1e-5 on
    logits (over their spread) and loss, 1e-4 on a leaf's gradient (‖Δ‖
    over ‖g‖) and on the state after three steps. A reference computing
    in bfloat16 (relative rounding 2^-9 on every product's operands)
    misses them by 30-3000×;
  * bfloat16 configuration (BF16): both round to bfloat16 at the same
    points (on this CPU they agree bit for bit), but a float32 sum that
    lands on the other side of a rounding boundary moves that value by
    one bfloat16 step (2^-8): logits within 1e-3 of their spread, a loss
    within relative 1e-4, each gradient within 1e-2 of its norm. The
    float8 (e4m3, per-tensor scale) reference misses them by 50× or
    more on the logits;
  * a reference that drops a feature's pooled rows (a planted fault)
    misses the float32 ones by orders of magnitude.
"""
import numpy as np
import pytest
import torch

from benchmark.families import dlrm_dcnv2_reference as ref
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels.embedding_lookup import (
    fused_gather_pool, fused_gather_pool_plain,
)
from goctr_tpu_torch.parallel import scanned as sc
from goctr_tpu_torch.parallel.dlrm import DLRMDCNv2, DLRMSample
from goctr_tpu_torch.parallel.table_opt import TableOptConfig

HOT = (1, 3, 5, 2)
ROWS = (50, 7, 300, 20)
BATCH = 256
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (logits, loss, gradient) relative tolerances by the configuration's
# compute dtype (module docstring), and the precision below it
FP32 = (1e-5, 1e-5, 1e-4)
BF16 = (1e-3, 1e-4, 1e-2)
TOLS = {"float32": FP32, "bfloat16": BF16}
BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3"}
STATE = 1e-4      # relative, the state after three float32 steps


def config(dim: int, dtype: str, solver: str = "sgd",
           mode: str = "fused") -> dict:
    """A configuration in the benchmark's keys (MLPerf's argument
    names)."""
    return {"dense_in_features": 13, "embedding_dim": dim,
            "num_embeddings_per_feature": list(ROWS),
            "multi_hot_sizes": list(HOT),
            "dense_arch_layer_sizes": [8, dim],
            "over_arch_layer_sizes": [8, 4, 1], "dcn_num_layers": 2,
            "dcn_low_rank_dim": 4, "compute_dtype": dtype,
            "trainer": {"solver": solver, "lr": 0.05, "l2": 0.0,
                        "epsilon": 1e-8},
            "table_opt": {"kind": "adagrad", "lr": 0.05, "eps": 1e-8,
                          "update_mode": mode}}


def model(cfg: dict) -> DLRMDCNv2:
    lay = ref.layers(cfg)
    return DLRMDCNv2(lay["hotness"], lay["rows"], emb_dim=lay["dim"],
                     dense_dim=lay["dense"], bottom=lay["bottom"],
                     cross_layers=lay["cross_layers"],
                     cross_rank=lay["cross_rank"], top=lay["top"],
                     compute_dtype=DTYPES[lay["compute_dtype"]],
                     device="cpu")


def sample(n: int, seed: int) -> DLRMSample:
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, r, (n, h))
                          for h, r in zip(HOT, ROWS)], 1).astype(np.int32)
    return DLRMSample(np.log1p(rng.exponential(4.0, (n, 13))).astype(
        np.float32), ids, (rng.random(n) < 0.3).astype(np.float32))


def weights(m: DLRMDCNv2, seed: int):
    """(dense leaves by name, table): the port's own init, drawn from a
    seed; the table widened so that no row is near 0."""
    gen = torch.Generator().manual_seed(seed)
    table = m.init_params(gen) * 20.0
    return ({n: p.detach().clone() for n, p in
             zip(m.leaf_names(), m.param_leaves())}, table)


def batch(s: DLRMSample, rows=slice(None)) -> dict:
    return {"dense": torch.from_numpy(s.dense[rows]),
            "ids": torch.from_numpy(s.ids[rows]),
            "labels": torch.from_numpy(s.labels[rows])}


def port_forward(m: DLRMDCNv2, table, b: dict):
    """(logits, mean loss, {leaf: gradient}) of the port."""
    pooled = m.pool(table, b["ids"])
    z = m.apply_pooled(b["dense"], pooled)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        z, b["labels"])
    g = torch.autograd.grad(loss, m.param_leaves())
    return z.detach(), float(loss.detach()), dict(zip(m.leaf_names(), g))


def ref_forward(cfg: dict, dense0: dict, table, b: dict, precision=None,
                drop: int = -1):
    """(logits, mean loss, {leaf: gradient}) of the reference; `drop`, a
    feature whose pooled rows it leaves out (a planted fault)."""
    lay = ref.layers(cfg)
    q = ref.rounding(precision or lay["compute_dtype"])
    leaves = {k: v.clone().requires_grad_() for k, v in dense0.items()}
    first = np.concatenate([[0], np.cumsum(ROWS)[:-1]])
    gids = b["ids"].long() + torch.from_numpy(np.repeat(first, HOT))
    pooled = ref.pool(table, gids, HOT)
    if drop >= 0:
        pooled[:, drop] = 0.0
    z = ref.logits(leaves, b["dense"], pooled, q, lay)
    loss = ref.bce(z, b["labels"]) / z.shape[0]
    g = torch.autograd.grad(loss, list(leaves.values()))
    return z.detach(), float(loss.detach()), dict(zip(leaves, g))


def gaps(a, b) -> tuple:
    """(logits' largest gap over their spread, the loss's relative gap,
    the worst leaf's gradient gap over its norm)."""
    za, la, ga = a
    zb, lb, gb = b
    z = float((za - zb).abs().max() / zb.std().clamp_min(1e-30))
    g = max(float((ga[k] - gb[k]).norm() / gb[k].norm().clamp_min(1e-30))
            for k in gb)
    return z, abs(la - lb) / abs(lb), g


def within(gap: tuple, tol: tuple) -> bool:
    return all(x <= t for x, t in zip(gap, tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [16, 128])
def test_logits_loss_and_grads_match_reference(dim, dtype):
    cfg = config(dim, dtype)
    m = model(cfg)
    dense0, table = weights(m, seed=dim)
    b = batch(sample(BATCH, seed=dim))
    want = ref_forward(cfg, dense0, table, b)
    got = gaps(port_forward(m, table, b), want)
    assert within(got, TOLS[dtype]), got
    below = gaps(ref_forward(cfg, dense0, table, b, BELOW[dtype]), want)
    assert not within(below, TOLS[dtype]), below


@pytest.mark.parametrize("dim", [16, 128])
def test_a_dropped_feature_fails(dim):
    cfg = config(dim, "float32")
    m = model(cfg)
    dense0, table = weights(m, seed=dim)
    b = batch(sample(BATCH, seed=dim))
    want = ref_forward(cfg, dense0, table, b)
    for f in range(len(HOT)):
        dropped = gaps(ref_forward(cfg, dense0, table, b, drop=f), want)
        assert not within(dropped, FP32), (f, dropped)


@pytest.mark.parametrize("solver", ["sgd", "adagrad"])
@pytest.mark.parametrize("dim,mode", [(16, "dedup"), (128, "fused")])
def test_three_trainer_steps_match_reference(dim, mode, solver):
    """Three steps of train_sparse_scanned (fused at D = 128: K3, the
    "xla" compaction's unpacked run sums, the split update; dedup at D =
    16) against the reference's: the losses, every dense leaf, and the
    touched rows' weights and accumulators (the untouched ones unmoved).
    Adagrad's first step moves every element by lr·sign(g), so its dense
    leaves are held by the norm of their change."""
    cfg = config(dim, "float32", solver, mode)
    m = model(cfg)
    dense0, table0 = weights(m, seed=3 * dim)
    s = sample(3 * BATCH, seed=dim + 1)
    st = ref.steps(cfg, (dense0, table0),
                   [batch(s, slice(i * BATCH, (i + 1) * BATCH))
                    for i in range(3)])
    start = sc.TrainedScanned(model=m, table=table0.clone(), loss_curve=[],
                              acc=torch.zeros(m.item_vocab))
    tcfg = TrainerConfig(batch_size=BATCH, epochs=1, solver=solver,
                         lr=0.05, l2=0.0, momentum=0.0, shuffle=False,
                         early_stop=0)
    topt = TableOptConfig(kind="adagrad", lr=0.05, update_mode=mode,
                          compact_cap=2048 if mode == "fused" else 0)
    out = sc.train_sparse_scanned(model(cfg), s, tcfg, topt,
                                  resume_from=start, device="cpu")
    assert abs(out.loss_curve[0] - np.mean(st.losses)) <= 1e-5 * abs(
        out.loss_curve[0])
    for name, p in zip(out.model.leaf_names(), out.model.param_leaves()):
        want = st.params[name]
        if solver == "sgd":
            err = (p.detach() - want).norm() / want.norm()
        else:
            err = abs((p.detach() - dense0[name]).norm()
                      - (want - dense0[name]).norm()) / (
                          want - dense0[name]).norm()
        assert err <= STATE, (name, float(err))
    v = m.item_vocab          # dedup's table carries junk rows past v
    table, acc = out.table[:v], out.acc[:v]
    assert table.shape[1] == dim and out.table.shape[0] >= v
    rows = table.index_select(0, st.touched)
    assert float((rows - st.rows).norm() / st.rows.norm()) <= STATE
    torch.testing.assert_close(acc.index_select(0, st.touched), st.acc,
                               rtol=STATE, atol=0.0)
    untouched = torch.ones(v, dtype=torch.bool)
    untouched[st.touched] = False
    assert torch.equal(table[untouched], table0[untouched])
    assert not acc[untouched].any()


@pytest.mark.parametrize("dim", [16, 128])
def test_bag_pool_plain_matches_embedding_bag(dim):
    """K3's plain version with column offsets against one embedding_bag a
    feature (sum), and its bags' count and layout; F = 1 keeps [B, D]."""
    gen = torch.Generator().manual_seed(dim)
    table = torch.randn(400, dim, generator=gen)
    ids = torch.randint(0, 400, (BATCH, sum(HOT)), generator=gen,
                        dtype=torch.int32)
    off = torch.tensor(np.concatenate([[0], np.cumsum(HOT)]),
                       dtype=torch.int32)
    got = fused_gather_pool(table, ids, "sum", off)
    assert tuple(got.shape) == (BATCH, len(HOT), dim)
    for f in range(len(HOT)):
        cols = ids[:, off[f]:off[f + 1]].long()
        want = torch.nn.functional.embedding_bag(cols, table, mode="sum")
        torch.testing.assert_close(got[:, f], want, rtol=1e-6, atol=1e-6)
    one = fused_gather_pool_plain(table, ids, "sum")
    assert tuple(one.shape) == (BATCH, dim)
    torch.testing.assert_close(one, got.sum(1), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rise from 0"):
        fused_gather_pool_plain(table, ids, "sum", off.flip(0))


def test_wide_fused_update_matches_dedup():
    """The D = 128 fused split update (the "xla" compaction's unpacked
    [capr, 128] run sums, K1 read, adagrad, K4 write, the accumulator by
    index) against the dedup mode on the same stream of bf16 gradients,
    pads and repeats included: the two sum each id's rows in other
    orders (float32)."""
    gen = torch.Generator().manual_seed(5)
    v, n = 3000, 5000
    ids = torch.randint(0, 300, (n,), generator=gen, dtype=torch.int32)
    ids[::7] = -1
    g = torch.randn(n, 128, generator=gen).to(torch.bfloat16)
    table = torch.randn(v, 128, generator=gen)
    acc = torch.rand(v, generator=gen)
    fused_t, fused_a = sc._layout_table("fused", table, acc, v, v)
    assert fused_a.shape == (v + 1,)
    over = sc._table_update(fused_t, ids, g, TableOptConfig(
        lr=0.3, compact_cap=2048), v, fused_a)
    pad = sc.table_pad_rows(n, 0)
    dedup_t, dedup_a = sc._layout_table("dedup", table, acc, v, v + pad)
    sc._table_update(dedup_t, ids, g, TableOptConfig(
        lr=0.3, update_mode="dedup"), v, dedup_a)
    assert int(over) == 0
    torch.testing.assert_close(fused_t, dedup_t[:v], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fused_a[:v], dedup_a[:v], rtol=1e-5,
                               atol=1e-6)
    assert not torch.equal(fused_t, table)
    # a cap below the distinct ids (its 1,024 slots of ~2,300) drops rows
    # and says so
    wide = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
    small_t, small_a = sc._layout_table("fused", table, acc, v, v)
    assert int(sc._table_update(small_t, wide, g, TableOptConfig(
        lr=0.3, compact_cap=64), v, small_a)) > 0


def test_wide_fused_refuses_k5_and_k9():
    m = model(config(128, "float32"))
    s = sample(BATCH, seed=0)
    for kw in ({"rmw_impl": "kernel"}, {"compact_impl": "kernel"}):
        with pytest.raises(ValueError, match="emb_dim 128"):
            sc.train_sparse_scanned(m, s, TrainerConfig(batch_size=BATCH,
                                                        epochs=1),
                                    TableOptConfig(**kw), device="cpu")


def test_packed_tables_are_refused_by_the_bag_pool():
    m = model(config(16, "float32"))
    s = sample(BATCH, seed=0)
    with pytest.raises(ValueError, match="pools a"):
        sc.train_sparse_scanned(m, s, TrainerConfig(batch_size=BATCH,
                                                    epochs=1),
                                TableOptConfig(update_mode="fused2"),
                                device="cpu")
