"""The port's dense rankers (MLPTower, YoutubeDNN, DIN), their trainer,
checkpoints and streaming trainer against the JAX package's, on the CPU.

Both packages resume from the JAX trainer's epochs=0 state
(`convert.ranker_from_jax`): JAX's threefry streams and torch's
generators never draw the same numbers, so the parameters are carried
across and the runs use shuffle=False and dropout 0. The rows are
tests/test_models.py's planted samples (U = 5, T = 3, D = 7, item 7,
ctx 5) with 1,100 rows at batch 200, so the last batch is ragged (100 pad
rows, masked). The port's DIN "pallas" (K2 forward, K2b backward; their
plain versions here) is held to the JAX DIN's "xla" path, which computes
the same function: the JAX package cannot differentiate its Pallas pool.

Tolerances. f32: both packages do the same f32 arithmetic in other orders
(XLA's fused reductions and dots vs PyTorch's CPU kernels) over 12 steps;
loss curves within rtol 1e-5, parameters and predictions within atol
1e-6 + rtol 1e-5 (observed ≤ 2e-7). bf16 (DIN "xla", f16 storage, bf16
compute): each package rounds the same bf16 intermediates, but a product
or sum that lands between two bf16 values in one order can round to the
other neighbour in the other, one bf16 ulp (2^-8 relative) of an
activation; over 12 steps: loss curves within rtol 2e-3, parameters
within atol 2e-3, predictions within atol 2e-3.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from goctr_tpu.models import (
    DIN as JDIN, MLPTower as JMLP, YoutubeDNN as JYT, train_ranker as jtrain,
)
from goctr_tpu.models import io as jio
from goctr_tpu.models.base import split_blocks as jsplit
from goctr_tpu.models.streaming import train_ranker_streaming as jstream
from goctr_tpu.models.trainer import TrainerConfig as JCfg
from goctr_tpu.ops import losses as jlosses

from goctr_tpu_torch.convert import ranker_from_jax
from goctr_tpu_torch.models import (
    DIN, MLPTower, SampleInfo, TrainSample, YoutubeDNN, train_ranker,
)
from goctr_tpu_torch.models import io as tio
from goctr_tpu_torch.models.base import param_leaves, split_blocks
from goctr_tpu_torch.models.streaming import train_ranker_streaming
from goctr_tpu_torch.models.trainer import TrainedRanker, TrainerConfig
from goctr_tpu_torch.ops import losses as tlosses
from test_models import CTX, D, INFO, ITEM, T, U_PROFILE, make_planted

CPU = "cpu"
W = U_PROFILE + T * D + ITEM + CTX
PINFO = SampleInfo(*(tuple(r) for r in (
    INFO.user_profile_range, INFO.user_behavior_range,
    INFO.item_feature_range, INFO.ctx_feature_range)))
F32 = dict(loss_rtol=1e-5, atol=1e-6, rtol=1e-5)
BF16 = dict(loss_rtol=2e-3, atol=2e-3, rtol=0.0)
NO_DROP = dict(dropout_rates=(0.0, 0.0))
DENSE_KW = dict(hidden=(16, 8), **NO_DROP)


def _models(kind, cd_jax=jax.numpy.float32, cd=torch.float32):
    """(JAX model, port model) of one kind at the test widths."""
    widths = (U_PROFILE, T, D, ITEM, CTX)
    if kind == "mlp":
        return (JMLP(in_dim=W, hidden=(16,), compute_dtype=cd_jax),
                MLPTower(in_dim=W, hidden=(16,), compute_dtype=cd))
    if kind == "youtube":
        return (JYT(*widths, **DENSE_KW, compute_dtype=cd_jax),
                YoutubeDNN(*widths, **DENSE_KW, compute_dtype=cd))
    impl = "pallas" if kind == "din pallas" else "xla"
    return (JDIN(*widths, **DENSE_KW, compute_dtype=cd_jax),
            DIN(*widths, **DENSE_KW, compute_dtype=cd, attention_impl=impl))


@pytest.fixture(scope="module")
def planted():
    s = make_planted(1100, seed=1)
    return s, TrainSample(x=s.x, y=s.y, info=PINFO)


def _cfgs(**kw):
    kw = dict(dict(batch_size=200, epochs=2, early_stop=0, shuffle=False,
                   lr=3e-3), **kw)
    return JCfg(**kw), TrainerConfig(**kw)


def _port_params(jparams, pm):
    """JAX parameters as the port's, for model pm."""
    return _carry(SimpleNamespace(params=jparams, opt_state=None,
                                  loss_curve=[]), pm).params


def _carry(jr, pm, device=CPU):
    """The port's TrainedRanker from a JAX TrainedRanker."""
    flat = {k: np.asarray(v) for k, v in jio._flatten_params(
        jr.params).items()}
    leaves = (None if jr.opt_state is None else
              [np.asarray(x) for x in jax.tree.leaves(jr.opt_state)])
    return ranker_from_jax(pm, flat, leaves, PINFO, pm.behavior_len,
                           jr.loss_curve, device=device)


def _assert_params(jparams, tparams, atol, rtol):
    jf = jio._flatten_params(jparams)
    tf = tio._flatten_params(tparams)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_allclose(tf[k], np.asarray(jf[k]), atol=atol,
                                   rtol=rtol, err_msg=k)


def _both(kind, planted, cd_jax=jax.numpy.float32, cd=torch.float32,
          **cfg_kw):
    s, ps = planted
    jm, pm = _models(kind, cd_jax, cd)
    jc0, _ = _cfgs(epochs=0, **cfg_kw)
    jc, tc = _cfgs(**cfg_kw)
    j0 = jtrain(jm, s, jc0)
    start = _carry(j0, pm)          # before JAX donates j0's arrays
    jr = jtrain(jm, s, jc, resume_from=j0)
    tr = train_ranker(pm, ps, tc, resume_from=start, device=CPU)
    return jr, tr


@pytest.mark.parametrize("kind", ["mlp", "youtube", "din xla",
                                  "din pallas"])
def test_trainer_matches_jax_f32(kind, planted):
    """2 epochs from JAX's start, ragged last batch: loss curve, every
    parameter and the predictions (DIN "pallas" against JAX's "xla")."""
    jr, tr = _both(kind, planted)
    np.testing.assert_allclose(tr.loss_curve, jr.loss_curve,
                               rtol=F32["loss_rtol"])
    _assert_params(jr.params, tr.params, F32["atol"], F32["rtol"])
    x = planted[0].x[:300]
    np.testing.assert_allclose(tr.predict(x), jr.predict(x),
                               atol=F32["atol"], rtol=F32["rtol"])
    assert len(tr.opt_state) == len(jax.tree.leaves(jr.opt_state))
    for a, b in zip(tr.opt_state, jax.tree.leaves(jr.opt_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-4)


def test_trainer_matches_jax_bf16_f16_storage(planted):
    """DIN "xla" at bf16 compute and f16 storage, the ML-20M protocol's
    dtypes, under the bf16 limits."""
    jr, tr = _both("din xla", planted, jax.numpy.bfloat16, torch.bfloat16,
                   store_dtype="float16")
    np.testing.assert_allclose(tr.loss_curve, jr.loss_curve,
                               rtol=BF16["loss_rtol"])
    _assert_params(jr.params, tr.params, BF16["atol"], BF16["rtol"])
    x = planted[0].x[:300]
    np.testing.assert_allclose(tr.predict(x), jr.predict(x),
                               atol=BF16["atol"])


def test_pad_rows_are_masked(planted):
    """The ragged last batch's pad rows carry weight 0: at lr 0 the first
    epoch's loss is the mean over batches of each batch's mean loss over
    its real rows only (the last batch: 100 real rows of 200)."""
    s, ps = planted
    _, pm = _models("mlp")
    p0 = pm.init_params(torch.Generator().manual_seed(0))
    start = TrainedRanker(model=pm, params=p0, info=PINFO, behavior_len=0,
                          loss_curve=[])
    _, tc = _cfgs(epochs=1, lr=0.0, l2=0.0)
    r = train_ranker(pm, ps, tc, resume_from=start, device=CPU)
    x, y = torch.from_numpy(s.x), torch.from_numpy(s.y)
    logits = pm.apply(p0, (x,))
    per_batch = [tlosses.bce_with_logits(logits[i:i + 200], y[i:i + 200])
                 for i in range(0, 1100, 200)]
    np.testing.assert_allclose(r.loss_curve[0],
                               float(torch.stack(per_batch).mean()),
                               rtol=1e-6)


def test_predict_all_matches_predict(planted):
    """One upload and device-side batches == the bucketed predict: f32
    storage to f32 rounding; f16 storage within the JAX package's own
    limit for it (tests/test_models.py: rtol 5e-3, atol 5e-4)."""
    s, ps = planted
    _, pm = _models("din pallas")
    _, tc = _cfgs(epochs=1)
    r = train_ranker(pm, ps, tc, device=CPU)
    a = r.predict(s.x[:1050], batch_size=256)
    np.testing.assert_allclose(
        r.predict_all(s.x[:1050], batch_size=512, store_dtype="float32"), a,
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(r.predict_all(s.x[:1050], batch_size=512), a,
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(r.predict_logits(s.x[:8]),
                               np.log(a[:8] / (1 - a[:8])), rtol=1e-4)


def test_early_stop_and_resumed_curve_match_jax(planted):
    """A run that stops early (tol so large that epoch 2 counts as no
    improvement) and a resumed run whose loss curve continues the carried
    one, in both packages."""
    s, ps = planted
    jm, pm = _models("youtube")
    jc0, _ = _cfgs(epochs=1)
    j1 = jtrain(jm, s, jc0)          # one epoch: the curve to continue
    start = _carry(j1, pm)
    jc, tc = _cfgs(epochs=5, early_stop=1, tol=1.0)
    jr = jtrain(jm, s, jc, resume_from=j1)
    tr = train_ranker(pm, ps, tc, resume_from=start, device=CPU)
    assert len(jr.loss_curve) == len(tr.loss_curve) == 3
    np.testing.assert_allclose(tr.loss_curve, jr.loss_curve, rtol=1e-5)
    assert tr.loss_curve[0] == start.loss_curve[0]


def test_din_pallas_forward_matches_jax_interpret():
    """The port's DIN "pallas" forward (K2's plain version) against the
    JAX DIN "pallas" (its Pallas kernel in interpret mode) at T = 256,
    f32, from the same parameters (tests/test_models.py:159-178)."""
    U2, T2, D2 = 4, 256, 8
    W2 = U2 + T2 * D2 + D2 + 2
    ranges = ((0, U2), (U2, U2 + T2 * D2), (U2 + T2 * D2, U2 + T2 * D2 + D2),
              (U2 + T2 * D2 + D2, W2))
    jm = JDIN(U2, T2, D2, D2, 2, attention_impl="pallas")
    pm = DIN(U2, T2, D2, D2, 2, attention_impl="pallas")
    params = jm.init_params(jax.random.key(0))
    params["att0"] = jax.numpy.linspace(0.5, 1.5, T2)
    x = np.random.default_rng(0).random((8, W2)).astype(np.float32)
    jinfo = type(INFO)(*ranges)
    want = np.asarray(jm.apply(params, jsplit(jax.numpy.asarray(x), jinfo,
                                              T2)))
    tp = _port_params(params, pm)
    got = pm.apply(tp, split_blocks(torch.from_numpy(x), SampleInfo(*ranges),
                                    T2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_port_checkpoint_loads_in_jax(planted, tmp_path):
    """The port writes, JAX loads: same predictions, and JAX resumes from
    the carried solver state as from its own."""
    s, ps = planted
    jm, pm = _models("din pallas")
    _, tc = _cfgs(epochs=1)
    tr = train_ranker(pm, ps, tc, device=CPU)
    tio.save_checkpoint(tmp_path / "ck", tr, trainer_config=tc)
    jr = jio.load_checkpoint(tmp_path / "ck")
    assert type(jr.model).__name__ == "DIN"
    assert jr.model.attention_impl == "pallas"
    np.testing.assert_allclose(jr.predict(s.x[:200]), tr.predict(s.x[:200]),
                               atol=1e-6)
    assert jr.loss_curve == tr.loss_curve
    jx = dataclasses.replace(jr.model, attention_impl="xla")
    jc, tc2 = _cfgs(epochs=1)
    j2 = jtrain(jx, s, jc, resume_from=jr)
    t2 = train_ranker(pm, ps, tc2, resume_from=tr, device=CPU)
    np.testing.assert_allclose(t2.loss_curve, j2.loss_curve, rtol=1e-5)


@pytest.mark.parametrize("kind", ["mlp", "youtube", "din xla"])
def test_jax_checkpoint_loads_in_port_and_resumes(kind, planted, tmp_path):
    """JAX writes, the port loads (model, SampleInfo, solver state) and
    resumes: one more epoch in each package from the checkpoint."""
    s, ps = planted
    jm, _ = _models(kind)
    jc, tc = _cfgs(epochs=1)
    j1 = jtrain(jm, s, jc)
    jio.save_checkpoint(tmp_path / "ck", j1, trainer_config=jc)
    t1 = tio.load_checkpoint(tmp_path / "ck", device=CPU)
    assert type(t1.model).__name__ == type(jm).__name__
    assert t1.info == PINFO and t1.behavior_len == j1.behavior_len
    assert t1.model.compute_dtype == torch.float32
    np.testing.assert_allclose(t1.predict(s.x[:200]), j1.predict(s.x[:200]),
                               atol=1e-6)
    j2 = jtrain(jm, s, jc, resume_from=j1)
    t2 = train_ranker(t1.model, ps, tc, resume_from=t1, device=CPU)
    np.testing.assert_allclose(t2.loss_curve, j2.loss_curve, rtol=1e-5)
    _assert_params(j2.params, t2.params, F32["atol"], F32["rtol"])


def test_periodic_checkpoints_resume(planted, tmp_path):
    """checkpoint_every writes a checkpoint the trainer resumes from; its
    loss curve holds every epoch so far."""
    _, ps = planted
    _, pm = _models("mlp")
    _, tc = _cfgs(epochs=3, checkpoint_every=2,
                  checkpoint_dir=str(tmp_path / "p"))
    full = train_ranker(pm, ps, tc, device=CPU)
    mid = tio.load_checkpoint(tmp_path / "p", device=CPU)
    assert mid.loss_curve == full.loss_curve[:2]
    rest = train_ranker(pm, ps, dataclasses.replace(tc, epochs=1,
                                                    checkpoint_every=0),
                        resume_from=mid, device=CPU)
    np.testing.assert_allclose(rest.loss_curve, full.loss_curve, rtol=1e-6)


@pytest.mark.parametrize("kind", ["din", "youtube"])
@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_reference_json_round_trips(kind, direction):
    """The reference-JSON tier across packages: the same fields, and the
    same weights on the other side."""
    to_name, from_name = f"{kind}_to_json", f"{kind}_from_json"
    if kind == "youtube":
        to_name, from_name = "youtube_dnn_to_json", "youtube_dnn_from_json"
    widths = (U_PROFILE, T, D, ITEM, CTX)
    if direction == "port to jax":
        m = (DIN if kind == "din" else YoutubeDNN)(*widths, use_bias=False)
        p = m.init_params(torch.Generator().manual_seed(3))
        m2, p2 = getattr(jio, from_name)(getattr(tio, to_name)(m, p))
    else:
        m = (JDIN if kind == "din" else JYT)(*widths, use_bias=False)
        p = m.init_params(jax.random.key(3))
        m2, p2 = getattr(tio, from_name)(getattr(jio, to_name)(m, p),
                                         device=CPU)
    for f in ("u_profile_dim", "behavior_len", "behavior_dim",
              "i_feature_dim", "c_feature_dim", "use_bias"):
        assert getattr(m2, f) == getattr(m, f)
    a, b = tio._flatten_params(p), tio._flatten_params(p2)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _stream_sample(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 10)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.2 * rng.standard_normal(n) > 0).astype(
        np.float32)
    info = SampleInfo((0, 10), (10, 10), (10, 10), (10, 10))
    return TrainSample(x=x, y=y, info=info)


def test_streaming_single_chunk_matches_resident():
    """One chunk: the same data order and start as the resident trainer
    (tests/test_streaming.py), so the same trajectory."""
    sample = _stream_sample(2048, 0)
    tc = TrainerConfig(batch_size=256, epochs=4, early_stop=0,
                       shuffle=False, lr=5e-3)
    a = train_ranker(MLPTower(in_dim=10, hidden=(8,)), sample, tc,
                     device=CPU)
    b = train_ranker_streaming(MLPTower(in_dim=10, hidden=(8,)), sample, tc,
                               chunk_rows=2048, device=CPU)
    np.testing.assert_allclose(b.loss_curve, a.loss_curve, rtol=1e-6)
    for x, y in zip(param_leaves(a.params), param_leaves(b.params)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_streaming_ragged_chunks_match_jax():
    """Two chunks, the last ragged (2048 + 452 rows, padded): the JAX
    streaming trainer and the port's from the same parameters (it has no
    resume, so both models draw their start from a fixed init), shuffle
    off, chunk order and pad rows as JAX's."""
    sample = _stream_sample(2500, 3)
    jm0 = JMLP(in_dim=10, hidden=(8,))
    p0 = jm0.init_params(jax.random.key(5))

    class JFixed(JMLP):
        def init_params(self, key):
            return p0

    carried = _port_params(p0, MLPTower(in_dim=10, hidden=(8,)))

    class TFixed(MLPTower):
        def init_params(self, generator):
            return {k: [t.clone() for t in v] for k, v in carried.items()}

    kw = dict(batch_size=128, epochs=3, early_stop=0, shuffle=False,
              lr=5e-3)
    jr = jstream(JFixed(in_dim=10, hidden=(8,)), sample, JCfg(**kw),
                 chunk_rows=2048)
    tr = train_ranker_streaming(TFixed(in_dim=10, hidden=(8,)), sample,
                                TrainerConfig(**kw), chunk_rows=2048,
                                device=CPU)
    np.testing.assert_allclose(tr.loss_curve, jr.loss_curve, rtol=1e-5)
    _assert_params(jr.params, tr.params, F32["atol"], F32["rtol"])


def test_streaming_shuffled_chunks_learn():
    """Shuffled chunk order (np.random.default_rng(seed), as JAX) and
    rows: five chunks train to the JAX test's AUC bar."""
    from goctr_tpu_torch.core.metrics import roc_auc_score

    train, test = _stream_sample(10000, 1), _stream_sample(1000, 2)
    tc = TrainerConfig(batch_size=256, epochs=6, early_stop=0, lr=5e-3)
    r = train_ranker_streaming(MLPTower(in_dim=10, hidden=(16,)), train, tc,
                               chunk_rows=2048, device=CPU)
    assert roc_auc_score(test.y, r.predict(test.x)) > 0.9
    assert r.loss_curve[-1] < r.loss_curve[0]


@pytest.mark.parametrize("name", ["binary_cross_entropy", "bce_with_logits",
                                  "mse", "rms"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(9)
    a = rng.normal(0, 2, 300).astype(np.float32)
    y = (rng.random(300) < 0.4).astype(np.float32)
    if name == "binary_cross_entropy":
        a = 1 / (1 + np.exp(-a))
    want = float(getattr(jlosses, name)(jax.numpy.asarray(a),
                                        jax.numpy.asarray(y)))
    got = getattr(tlosses, name)(torch.from_numpy(a), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_blocks_and_leaves_follow_jax():
    """split_blocks gives views of the row, SampleInfo the same dims, and
    param_leaves the order of jax.tree.leaves."""
    x = torch.arange(3 * W, dtype=torch.float32).reshape(3, W)
    blocks = split_blocks(x, PINFO, T)
    jblocks = jsplit(jax.numpy.asarray(x.numpy()), INFO, T)
    for a, b in zip(blocks, jblocks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.data_ptr() >= x.data_ptr()          # a view, not a copy
    assert PINFO.dims(T) == INFO.dims(T) and PINFO.width == INFO.width
    jm, pm = _models("din xla")
    jp = jm.init_params(jax.random.key(1))
    tp = _port_params(jp, pm)
    for a, b in zip(param_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_din_checks_and_cuda_without_card(planted):
    """The JAX model's __post_init__ checks; device="cuda" without a card
    raises instead of running on the CPU."""
    with pytest.raises(ValueError, match="behavior_dim"):
        DIN(U_PROFILE, T, D, ITEM + 1, CTX)
    with pytest.raises(ValueError, match="attention_impl"):
        DIN(U_PROFILE, T, D, ITEM, CTX, attention_impl="triton")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_ranker(MLPTower(in_dim=W), planted[1], TrainerConfig(epochs=1))


def test_dense_pool_returns_only_att0_gradient():
    """DinAttentionPool on data behaviors and item (no grad) returns K2b's
    d_att0 alone, equal to the plain backward's."""
    from goctr_tpu_torch.ops.kernels import din_attention as k2

    rng = np.random.default_rng(2)
    beh = torch.from_numpy(rng.normal(0, 1, (32, 5, 8)).astype(np.float32))
    item = torch.from_numpy(rng.normal(0, 1, (32, 8)).astype(np.float32))
    att0 = torch.linspace(0.5, 1.5, 5).requires_grad_()
    mask = torch.ones(32, 5)
    dout = torch.from_numpy(rng.normal(0, 1, (32, 8)).astype(np.float32))
    k2.DinAttentionPool.apply(beh, item, att0, mask).backward(dout)
    want = k2.din_attention_pool_bwd_plain(dout, beh, item, att0.detach(),
                                           mask)[2]
    torch.testing.assert_close(att0.grad, want, atol=0, rtol=0)
    assert beh.grad is None and item.grad is None
