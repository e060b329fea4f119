"""The port's recommend/ orchestrator (Train, get_sample, BatchPredict,
Rank, RankerFitter) against the JAX package's, on the CPU, with the fake
providers of tests/test_recommend.py; and the Rank path of the port's
HTTP API.

Both packages assemble from one embedding map: JAX's `train_embedding`
builds it and it is carried across as numpy rows (the two packages'
item2vec draws differ). Assembly is host NumPy on both sides (the same
float32 copies), so the matrices and their SampleInfo must be equal
exactly. Scores and fits start from JAX's parameters
(`convert.ranker_from_jax`) with shuffle off and dropout 0; tolerances
are the dense rankers' f32 parity (tests/test_torch_dense_rankers.py
F32): both packages do the same f32 arithmetic in other orders, so loss
curves agree within rtol 1e-5, parameters and scores within atol 1e-6 +
rtol 1e-5.
"""
import json
import logging
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from goctr_tpu.embedding.store import train_embedding as jtrain_embedding
from goctr_tpu.models import DIN as JDIN, MLPTower as JMLP
from goctr_tpu.models import io as jio
from goctr_tpu.models.trainer import TrainerConfig as JCfg
from goctr_tpu.models.trainer import train_ranker as jtrain_ranker
from goctr_tpu.recommend import rcmd as jr

from goctr_tpu_torch.convert import ranker_from_jax
from goctr_tpu_torch.embedding.store import EmbeddingMap
from goctr_tpu_torch.models import DIN, MLPTower, YoutubeDNN, train_ranker
from goctr_tpu_torch.models import io as tio
from goctr_tpu_torch.models.base import SampleInfo, TrainSample
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.recommend import rcmd as tr
from goctr_tpu_torch.serve.api import RecApiServer
from test_recommend import N_ITEMS, N_USERS, FakeRec

CPU = "cpu"
F32 = dict(loss_rtol=1e-5, atol=1e-6, rtol=1e-5)
BAD_USER = 13                  # its features fail in every provider below
NO_DROP = dict(dropout_rates=(0.0, 0.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training: its batches
    are small (256 rows), and with the suite's parallel workers each
    holding every core, more threads only wait on one another (a DIN
    Train here took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Rec(FakeRec):
    """FakeRec whose user BAD_USER has no features (its samples are
    dropped in training, its rows zero-filled in BatchPredict)."""

    def get_user_feature(self, ctx, user_id):
        if user_id == BAD_USER:
            raise KeyError(user_id)
        return super().get_user_feature(ctx, user_id)


class BatchRec(Rec):
    """Rec with the batch feature methods: get_sample's vectorized path."""

    def get_user_features_batch(self, ctx, ids):
        return {i: self.get_user_feature(ctx, i) for i in ids
                if i < N_USERS and i != BAD_USER}

    def get_item_features_batch(self, ctx, ids):
        return {i: self.get_item_feature(ctx, i) for i in ids
                if i < N_ITEMS}


class BulkRec(BatchRec):
    """BatchRec that also answers behaviors for n rows in one call."""

    def get_user_behaviors_bulk(self, ctx, uid, ts, max_len):
        out = np.full((len(uid), max_len), -1, np.int64)
        for r, u in enumerate(np.asarray(uid).tolist()):
            seq = self.history.get(u, [])[:max_len]
            out[r, :len(seq)] = seq
        return out


def _maps():
    """(JAX EmbeddingMap, the port's) of the same vectors: JAX's
    train_embedding over FakeRec's item sequences, as its Train runs it."""
    jmap = jtrain_embedding(FakeRec().item_seq_generator(None), window=5,
                            dim=16, iters=1)
    return jmap, EmbeddingMap({w: np.array(v, np.float32)
                               for w, v in jmap.items()})


@pytest.fixture(scope="module")
def maps():
    return _maps()


def _samples(cls, maps, use_map=True):
    """(JAX TrainSample, the port's) assembled by get_sample from two
    providers of the same seed (sample_generator draws as it goes)."""
    out = []
    for mod, emb in ((jr, maps[0]), (tr, maps[1])):
        state = mod._State()
        state.item_embedding_map = emb if use_map else None
        out.append(mod.get_sample(cls(n_samples=700, seed=4),
                                  mod.Context(), state))
    return out


def _info(info):
    return tuple(tuple(r) for r in (
        info.user_profile_range, info.user_behavior_range,
        info.item_feature_range, info.ctx_feature_range))


@pytest.mark.parametrize("variant", ["vectorized", "threaded", "bulk",
                                     "no map"])
def test_assembled_sample_equals_jax(variant, maps):
    """get_sample's matrix, labels and SampleInfo equal JAX's exactly on
    each path: vectorized (batch feature methods), threaded (per-sample
    fetch), behaviors from get_user_behaviors_bulk, and with no map (the
    behavior and item-embedding blocks zero). Samples of the user whose
    features fail are dropped on every path."""
    cls = {"vectorized": BatchRec, "threaded": Rec, "bulk": BulkRec,
           "no map": BatchRec}[variant]
    js, ps = _samples(cls, maps, use_map=variant != "no map")
    np.testing.assert_array_equal(ps.x, js.x)
    np.testing.assert_array_equal(ps.y, js.y)
    assert _info(ps.info) == _info(js.info) == (
        (0, 11), (11, 171), (171, 187), (187, 198))
    assert 0 < ps.rows < 700              # BAD_USER's samples dropped
    assert ps.x.dtype == np.float32
    beh = ps.x[:, 11:187]
    assert (beh == 0).all() if variant == "no map" else beh.any()


def test_bulk_behaviors_equal_the_per_row_loop(maps):
    """The bulk call and the per-row get_user_behavior loop fill the same
    behavior blocks (port vs port)."""
    bulk = _samples(BulkRec, maps)[1]
    loop = _samples(BatchRec, maps)[1]
    np.testing.assert_array_equal(bulk.x, loop.x)


def _j_fitter(name):
    kw = dict(hidden=(16,)) if name == "mlp" else dict(
        hidden=(16, 8), activation="relu", **NO_DROP)
    return jr.RankerFitter(name, JCfg(batch_size=256, epochs=2,
                                      early_stop=0, shuffle=False), **kw)


def _port_model(name, info):
    up, t, d, it, cx = info.dims(tr.USER_BEHAVIOR_LEN)
    if name == "mlp":
        return MLPTower(in_dim=info.width, hidden=(16,))
    return DIN(up, t, d, it, cx, hidden=(16, 8), activation="relu",
               attention_impl="pallas", **NO_DROP)


def _carry(jranker, pm, info):
    flat = {k: np.asarray(v) for k, v in jio._flatten_params(
        jranker.params).items()}
    leaves = (None if jranker.opt_state is None else
              [np.asarray(x) for x in jax.tree.leaves(jranker.opt_state)])
    return ranker_from_jax(pm, flat, leaves, SampleInfo(*_info(info)),
                           pm.behavior_len, jranker.loss_curve, device=CPU)


@pytest.fixture(scope="module")
def jax_trained():
    """JAX's Train of an f32 MLP and DIN on BatchRec (JAX item2vec,
    assembly, 2 epochs)."""
    return {name: jr.Train(jr.Context(), BatchRec(seed=2), _j_fitter(name))
            for name in ("mlp", "din")}


def _port_predictor(jpred, name):
    info = jpred.model.info
    emb = EmbeddingMap({w: np.array(v, np.float32)
                        for w, v in jpred.item_embedding_map.items()})
    return tr.Predictor(rec_sys=BatchRec(seed=2),
                        model=_carry(jpred.model, _port_model(name, info),
                                     info),
                        item_embedding_map=emb)


KEYS = [(u, i) for u in (1, 7, BAD_USER, 30, 77) for i in (0, 3, 17, 99,
                                                            N_ITEMS + 5)]


@pytest.mark.parametrize("name", ["mlp", "din"])
def test_batch_predict_equals_jax(name, jax_trained):
    """BatchPredict with JAX's trained ranker and map carried across, on
    the same keys at fixed timestamps (a user and an item without
    features among them: zero-filled rows), within the f32 tolerance;
    the port's DIN runs "pallas" (K2's plain version here), JAX's "xla"."""
    jpred = jax_trained[name]
    ppred = _port_predictor(jpred, name)
    keys = [(1, 0)] + KEYS
    js = jr.BatchPredict(jr.Context(), jpred, [
        jr.Sample(user_id=u, item_id=i, timestamp=5000 + k)
        for k, (u, i) in enumerate(keys)])
    ps = tr.BatchPredict(tr.Context(), ppred, [
        tr.Sample(user_id=u, item_id=i, timestamp=5000 + k)
        for k, (u, i) in enumerate(keys)])
    assert ps.shape == (len(keys),)
    np.testing.assert_allclose(ps, js, atol=F32["atol"], rtol=F32["rtol"])


@pytest.mark.parametrize("name", ["mlp", "din"])
def test_fit_on_the_assembled_sample_equals_jax(name, maps):
    """train_ranker from JAX's start on each package's assembled sample
    (equal matrices), 3 epochs, shuffle off, dropout 0: loss curves,
    every parameter and the predictions within the f32 tolerance."""
    js, ps = _samples(BulkRec, maps)
    up, t, d, it, cx = js.info.dims(jr.USER_BEHAVIOR_LEN)
    jm = (JMLP(in_dim=js.x_cols, hidden=(16,)) if name == "mlp" else
          JDIN(up, t, d, it, cx, hidden=(16, 8), activation="relu",
               **NO_DROP))
    kw = dict(batch_size=256, early_stop=0, shuffle=False, lr=3e-3)
    j0 = jtrain_ranker(jm, js, JCfg(epochs=0, **kw))
    start = _carry(j0, _port_model(name, ps.info), js.info)
    jfin = jtrain_ranker(jm, js, JCfg(epochs=3, **kw), resume_from=j0)
    pfin = train_ranker(start.model, ps, TrainerConfig(epochs=3, **kw),
                        resume_from=start, device=CPU)
    np.testing.assert_allclose(pfin.loss_curve, jfin.loss_curve,
                               rtol=F32["loss_rtol"])
    jf, pf = jio._flatten_params(jfin.params), tio._flatten_params(
        pfin.params)
    assert sorted(jf) == sorted(pf)
    for k in jf:
        np.testing.assert_allclose(pf[k], np.asarray(jf[k]), err_msg=k,
                                   atol=F32["atol"], rtol=F32["rtol"])
    np.testing.assert_allclose(pfin.predict(ps.x[:200]),
                               jfin.predict(js.x[:200]),
                               atol=F32["atol"], rtol=F32["rtol"])


# ------------------------------------------------------------- behaviour --

@pytest.fixture(scope="module")
def trained():
    """The port's own Train on the CPU (its item2vec, assembly and a
    4-epoch MLP) on a FakeRec."""
    rec = FakeRec()
    fitter = tr.RankerFitter(
        "mlp", TrainerConfig(batch_size=256, epochs=4, early_stop=0,
                             lr=5e-3), device=CPU)
    return rec, tr.Train(tr.Context(), rec, fitter, device=CPU)


def test_train_calls_the_hooks(trained):
    rec, predictor = trained
    assert rec.pre_train_called == 1
    assert predictor.item_embedding_map is not None
    assert len(predictor.item_embedding_map) > 0
    assert predictor.state is not None
    assert len(predictor.state.user_cache) > 0
    before = rec.pre_rank_called
    scores = tr.Rank(tr.Context(), predictor, 7, list(range(20)))
    assert rec.pre_rank_called == before + 1
    assert [s.item_id for s in scores] == list(range(20))
    assert all(0 <= s.score <= 1 for s in scores)


def test_batch_predict_zero_fills_bad_rows(trained):
    _, predictor = trained
    keys = [tr.Sample(user_id=1, item_id=1),
            tr.Sample(user_id=9999, item_id=1),
            tr.Sample(user_id=1, item_id=9999)]
    scores = tr.BatchPredict(tr.Context(), predictor, keys)
    assert scores.shape == (3,) and np.isfinite(scores).all()


@pytest.mark.parametrize("key,kind", [((9999, 1), "userId"),
                                      ((1, 9999), "itemId")])
def test_batch_predict_first_row_failure_raises(trained, key, kind):
    _, predictor = trained
    with pytest.raises(KeyError) as ei:
        tr.BatchPredict(tr.Context(), predictor,
                        [tr.Sample(user_id=key[0], item_id=key[1])])
    assert isinstance(ei.value, tr.UnknownIdError)
    assert ei.value.kind == kind and ei.value.id == 9999
    assert str(ei.value) == f"{kind} 9999 not found"


def test_debug_hooks_log_feature_and_score(trained, caplog, monkeypatch):
    """DEBUG_USER_ID/DEBUG_ITEM_ID log the assembled feature vector and
    score of the chosen pair (rcmd.go:43-44,319-323,334)."""
    _, predictor = trained
    monkeypatch.setattr(tr, "DEBUG_USER_ID", 3)
    monkeypatch.setattr(tr, "DEBUG_ITEM_ID", 13)
    with caplog.at_level(logging.INFO,
                         logger="goctr_tpu_torch.recommend.rcmd"):
        tr.BatchPredict(tr.Context(), predictor,
                        [tr.Sample(user_id=3, item_id=13),
                         tr.Sample(user_id=4, item_id=13),
                         tr.Sample(user_id=3, item_id=14)])
    msgs = [r.message for r in caplog.records
            if "user 3: item 13" in r.message]
    assert any("feature" in m for m in msgs)
    assert any("score" in m for m in msgs)
    assert not any("user 4" in r.message or "item 14" in r.message
                   for r in caplog.records)


def test_stage_routing():
    ctx = tr.Context()
    assert ctx.stage == tr.Stage.TRAIN
    pctx = ctx.with_stage(tr.Stage.PREDICT)
    assert pctx.stage == tr.Stage.PREDICT and ctx.stage == tr.Stage.TRAIN
    assert pctx.values is ctx.values


class _StageRec(FakeRec):
    def get_user_feature(self, ctx, user_id):
        self.stages.append(ctx.stage)
        return super().get_user_feature(ctx, user_id)


def test_train_and_predict_source_features_by_stage(trained):
    _, predictor = trained
    rec = _StageRec(n_samples=50)
    rec.stages = []
    fitter = tr.RankerFitter("mlp", TrainerConfig(batch_size=64, epochs=1),
                             device=CPU, hidden=(4,))
    pred = tr.Train(tr.Context(), rec, fitter, device=CPU)
    assert set(rec.stages) == {tr.Stage.TRAIN}
    rec.stages.clear()
    pred.state.user_cache.clear()
    tr.BatchPredict(tr.Context(), pred, [tr.Sample(user_id=2, item_id=2)])
    assert rec.stages == [tr.Stage.PREDICT]


@pytest.mark.parametrize("name,cls", [
    ("din", DIN), ("DIN", DIN), ("youtube_dnn", YoutubeDNN),
    ("youtube", YoutubeDNN), ("ytdnn", YoutubeDNN), ("mlp", MLPTower),
    ("anything", MLPTower)])
def test_ranker_fitter_builds_the_named_model(name, cls):
    rng = np.random.default_rng(0)
    x = rng.random((64, 198), dtype=np.float32)
    info = SampleInfo((0, 11), (11, 171), (171, 187), (187, 198))
    sample = TrainSample(x=x, y=(rng.random(64) < 0.5).astype(np.float32),
                         info=info)
    fitter = tr.RankerFitter(name, TrainerConfig(batch_size=32, epochs=1),
                             device=CPU)
    ranker = fitter.fit(sample)
    assert type(ranker.model) is cls and fitter.ranker is ranker
    assert ranker.model.compute_dtype == torch.float32
    if cls is not MLPTower:
        assert (ranker.model.behavior_len, ranker.model.behavior_dim) == (
            10, 16)


@pytest.mark.parametrize("use_bf16,kw,want", [
    (True, {}, torch.bfloat16), (False, {}, torch.float32),
    (None, {}, None),
    (True, {"compute_dtype": torch.float32}, torch.float32)])
def test_ranker_fitter_maps_use_bf16(use_bf16, kw, want):
    fitter = tr.RankerFitter("din", use_bf16=use_bf16, device=CPU, **kw)
    assert fitter.model_kw.get("compute_dtype") == want
    assert fitter.device == torch.device("cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    cpu_fitter = tr.RankerFitter("mlp", device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tr.RankerFitter("mlp")
    rec = FakeRec(n_samples=10)
    with pytest.raises(RuntimeError, match="is_available"):
        tr.Train(tr.Context(), rec, cpu_fitter)
    assert rec.pre_train_called == 0            # refused before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="fitter trains on cuda"):
        tr.Train(tr.Context(), rec, tr.RankerFitter("mlp"), device=CPU)


def test_lru_cache_evicts_oldest_and_refreshes_hits():
    c = tr.LRUCache(2)
    assert c.fetch(1, lambda: "a") == "a"
    c.fetch(2, lambda: "b")
    assert c.fetch(1, lambda: "x") == "a"        # hit: 1 becomes newest
    c.fetch(3, lambda: "c")                      # evicts 2
    assert c.peek(2) is None and c.peek(1) == "a" and len(c) == 2


def test_lru_cache_survives_concurrent_eviction():
    """Many threads fetching over more keys than the cache holds: with
    JAX's unlocked check-then-move a hit's key can be evicted in between
    (KeyError); the port's lock keeps every fetch right and the size
    bounded."""
    c = tr.LRUCache(4)
    errors, stop = [], threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for k in rng.integers(0, 12, 3000).tolist():
                if c.fetch(k, lambda k=k: k * 10) != k * 10:
                    errors.append(("wrong value", k))
                if stop.is_set():
                    return
        except Exception as e:          # noqa: BLE001 — recorded, asserted
            errors.append(e)
            stop.set()

    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and len(c) <= 4


# ------------------------------------------------------------ HTTP Rank --

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_rank_path(trained):
    """A predictor without rank_direct answers through Rank: the scores
    equal BatchPredict's; an unknown user, or an unknown first item, gets
    400 naming the id; an unknown later item is zero-filled."""
    _, predictor = trained
    srv = RecApiServer(predictor, host="127.0.0.1", port=0).start(
        background=True)
    url = f"http://127.0.0.1:{srv.port}/api/v1/recommend"
    try:
        status, out = _post(url, {"userId": 7, "itemIdList": [7, 17, 3]})
        assert status == 200
        assert [e["itemId"] for e in out["itemScoreList"]] == [7, 17, 3]
        want = tr.BatchPredict(tr.Context(), predictor, [
            tr.Sample(user_id=7, item_id=i) for i in (7, 17, 3)])
        np.testing.assert_allclose([e["score"] for e in out[
            "itemScoreList"]], want, atol=1e-6)
        assert _post(url, {"userId": 9999, "itemIdList": [1, 2]}) == (
            400, {"error": "userId 9999 not found", "userId": 9999})
        assert _post(url, {"userId": 7, "itemIdList": [5000, 2]}) == (
            400, {"error": "itemId 5000 not found", "itemId": 5000})
        status, out = _post(url, {"userId": 7, "itemIdList": [2, 5000]})
        assert status == 200 and len(out["itemScoreList"]) == 2
        assert _post(url, {"userId": 7, "itemIdList": []})[0] == 400
    finally:
        srv.stop()


class _StageOverviewRec:
    """A rec_sys whose dashboard hooks read ctx.stage (a None ctx fails)."""

    def get_dashboard_overview(self, ctx):
        return {"stage": ctx.stage.name}

    def get_users_feature_overview(self, ctx, offset, size, opts=None):
        return {"stage": ctx.stage.name, "offset": offset, "size": size}

    def get_items_feature_overview(self, ctx, offset, size, opts=None):
        return {"stage": ctx.stage.name, "offset": offset, "size": size}

    def get_feature_distributions(self, ctx, kind="items"):
        return {"stage": ctx.stage.name, "kind": kind}


def test_service_endpoints_pass_a_context():
    """/service/* hand rec_sys a Context, as JAX's server does."""
    pred = tr.Predictor(rec_sys=_StageOverviewRec(), model=None)
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(
        background=True)
    base = f"http://127.0.0.1:{srv.port}/service"
    try:
        for path, want in (
                ("/overview", {"stage": "TRAIN"}),
                ("/useritems?page=2&size=5",
                 {"stage": "TRAIN", "offset": 5, "size": 5}),
                ("/items?page=1&size=3",
                 {"stage": "TRAIN", "offset": 0, "size": 3}),
                ("/featuredist?kind=users",
                 {"stage": "TRAIN", "kind": "users"})):
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                assert resp.status == 200
                assert json.loads(resp.read()) == want
    finally:
        srv.stop()
