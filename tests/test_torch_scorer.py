"""The port's serving path on the CPU against the JAX package's: a tiny
SparseCTR trained by the JAX scanned trainer (as tests/test_scorer.py
trains it) is carried into the port, and the port's DeviceScorer,
TrainedScanned.predict, checkpoints, MicroBatcher and HTTP route are held
against the JAX ones.

Tolerances: f32 compute rtol 2e-5, atol 1e-6 (the same f32 math summed
in other orders). bf16 compute atol 1e-2 on probabilities: the JAX pool
rounds each intermediate to bf16 and the port's K2 computes in f32 and
rounds once (tests/test_torch_sparse_ctr.py bounds the logits).
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.models.io import _flatten_params
from goctr_tpu.models.trainer import TrainerConfig
from goctr_tpu.ops.pallas.row_optimizer import pack_table as jax_pack_table
from goctr_tpu.parallel.scanned import (
    TableOptConfig, load_scanned_checkpoint as jax_load,
    save_scanned_checkpoint as jax_save, train_sparse_scanned,
)
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR
from goctr_tpu.parallel.sparse_trainer import SparseSample as JaxSample
from goctr_tpu.serve.scorer import DeviceScorer as JaxScorer
from goctr_tpu_torch.convert import params_from_jax
from goctr_tpu_torch.ops.kernels.row_optimizer import pack_table
from goctr_tpu_torch.parallel.scanned import (
    TrainedScanned, load_scanned_checkpoint, save_scanned_checkpoint,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample
from goctr_tpu_torch.serve.api import RecApiServer
from goctr_tpu_torch.serve.scorer import (
    DeviceScorer, MicroBatcher, SparseRankPredictor,
)

VOCAB = 120
F32 = dict(rtol=2e-5, atol=1e-6)


def _train(grouped_resident: bool):
    rng = np.random.default_rng(0)
    n = 1500
    sample = JaxSample(
        user_profile=rng.random((n, 4)).astype(np.float32),
        behavior_ids=rng.integers(-1, VOCAB, (n, 5)).astype(np.int32),
        item_ids=rng.integers(0, VOCAB, n).astype(np.int32),
        ctx=rng.random((n, 2)).astype(np.float32),
        labels=(rng.random(n) > 0.5).astype(np.float32))
    model = JaxSparseCTR(item_vocab=VOCAB, emb_dim=8, u_profile_dim=4,
                         ctx_dim=2, behavior_len=5, hidden=(16,))
    with pytest.MonkeyPatch.context() as mp:
        if grouped_resident:
            import goctr_tpu.parallel.scanned as sc
            mp.setattr(sc, "GROUPED_RESIDENT_MIN_V", 50)
        r = train_sparse_scanned(
            model, sample,
            TrainerConfig(batch_size=512, epochs=2, early_stop=0, seed=1,
                          shuffle=False),
            TableOptConfig(kind="adagrad", lr=0.3, update_mode="fused"))
    assert (r.packed_group > 1) == grouped_resident
    return r, sample


@pytest.fixture(scope="module")
def trained():
    return _train(False)


@pytest.fixture(scope="module")
def trained_grouped():
    return _train(True)


def _port_ranker(r, compute_dtype=torch.float32):
    """The JAX TrainedScanned carried into the port through convert.py."""
    m = r.model
    layout = "grouped" if r.packed_group > 1 else "plain"
    dense, table = params_from_jax(_flatten_params(r.dense_params),
                                   np.asarray(r.table), layout, device="cpu")
    model = SparseCTR(item_vocab=m.item_vocab, emb_dim=m.emb_dim,
                      u_profile_dim=m.u_profile_dim, ctx_dim=m.ctx_dim,
                      behavior_len=m.behavior_len, hidden=m.hidden,
                      activation=m.activation, compute_dtype=compute_dtype,
                      device="cpu")
    model.load_state_dict(dense)
    return TrainedScanned(model=model, table=table, loss_curve=[],
                          packed_group=r.packed_group)


def _scorers(r, layout, bf16=False):
    """(JAX scorer, port scorer) over the same params in `layout`."""
    jr = r
    if bf16:
        jr = dataclasses.replace(r, model=dataclasses.replace(
            r.model, compute_dtype=jnp.bfloat16))
    pr = _port_ranker(r, torch.bfloat16 if bf16 else torch.float32)
    if layout == "packed":
        return (JaxScorer(model=jr.model, dense_params=jr.dense_params,
                          table=jax_pack_table(jr.table), table_packed=True),
                DeviceScorer(pr.model, pack_table(pr.table),
                             table_packed=True, device="cpu"))
    return (JaxScorer.from_scanned(jr),
            DeviceScorer.from_scanned(pr, device="cpu"))


def _requests(sample, rows, lens, seed):
    rng = np.random.default_rng(seed)
    return (sample.user_profile[rows], sample.behavior_ids[rows],
            sample.ctx[rows],
            [rng.integers(0, VOCAB, k).astype(np.int32) for k in lens])


def _assert_scores(got, want, **tol):
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or F32))


@pytest.mark.parametrize("layout", ["plain", "packed", "grouped"])
def test_scorer_matches_jax_ragged(layout, trained, trained_grouped):
    """Three requests (R bucket 8) whose candidate counts cross both
    candidate buckets (128, 512), one with ids past the vocab."""
    r, sample = trained_grouped if layout == "grouped" else trained
    js, ps = _scorers(r, layout)
    prof, bids, ctx, cands = _requests(sample, [1, 2, 3], (5, 130, 513), 5)
    cands[0][:2] = [VOCAB, VOCAB + 40]       # past the table: NaN in both
    want = js.score_batch(prof, bids, ctx, cands)
    got = ps.score_batch(prof, bids, ctx, cands)
    _assert_scores(got, want)
    assert np.isnan(got[0][:2]).all() == np.isnan(want[0][:2]).all()


@pytest.mark.parametrize("layout", ["plain", "grouped"])
def test_single_request_matches_jax(layout, trained, trained_grouped):
    r, sample = trained_grouped if layout == "grouped" else trained
    js, ps = _scorers(r, layout)
    cands = np.random.default_rng(3).integers(0, VOCAB, 37).astype(np.int32)
    args = (sample.user_profile[7], sample.behavior_ids[7], sample.ctx[7],
            cands)
    np.testing.assert_allclose(ps.score(*args), js.score(*args), **F32)


def test_scorer_bf16_matches_jax_loosely(trained):
    r, sample = trained
    js, ps = _scorers(r, "plain", bf16=True)
    prof, bids, ctx, cands = _requests(sample, [4, 5], (50, 200), 6)
    _assert_scores(ps.score_batch(prof, bids, ctx, cands),
                   js.score_batch(prof, bids, ctx, cands), atol=1e-2)


def test_more_requests_than_the_largest_bucket_are_chunked(trained):
    """40 requests: the JAX scorer fails past 32 (queue C); the port
    scores them in chunks of 32, each equal to JAX's own chunk."""
    r, sample = trained
    js, ps = _scorers(r, "plain")
    rows = list(range(40))
    prof, bids, ctx, cands = _requests(sample, rows, [9] * 40, 7)
    got = ps.score_batch(prof, bids, ctx, cands)
    want = (js.score_batch(prof[:32], bids[:32], ctx[:32], cands[:32])
            + js.score_batch(prof[32:], bids[32:], ctx[32:], cands[32:]))
    _assert_scores(got, want)


def test_more_candidates_than_the_largest_bucket_are_chunked(trained):
    """3000 candidates: the JAX scorer silently truncates to 2048 (queue
    C); the port scores all of them, chunk for chunk equal to JAX."""
    r, sample = trained
    js, ps = _scorers(r, "plain")
    cands = np.random.default_rng(8).integers(0, VOCAB, 3000).astype(np.int32)
    args = (sample.user_profile[9], sample.behavior_ids[9], sample.ctx[9])
    got = ps.score(*args, cands)
    assert got.shape == (3000,)
    want = np.concatenate([js.score(*args, cands[:2048]),
                           js.score(*args, cands[2048:])])
    np.testing.assert_allclose(got, want, **F32)


def test_predict_matches_jax(trained, trained_grouped):
    for r, sample in (trained, trained_grouped):
        pr = _port_ranker(r)
        sub = SparseSample(**{f.name: getattr(sample, f.name)[:300]
                              for f in dataclasses.fields(sample)})
        jsub = JaxSample(**dataclasses.asdict(sub))
        np.testing.assert_allclose(pr.predict(sub, batch_size=128),
                                   r.predict(jsub, batch_size=128), **F32)


def test_jax_checkpoint_loads_in_port_and_back(trained, tmp_path):
    r, sample = trained
    jax_save(tmp_path / "jax", r, TrainerConfig(batch_size=512, epochs=2))
    pr = load_scanned_checkpoint(tmp_path / "jax", device="cpu")
    assert pr.loss_curve == r.loss_curve and pr.acc is not None
    # the solver state comes across leaf for leaf
    leaves = jax.tree.leaves(r.opt_state)
    assert len(pr.opt_state) == len(leaves)
    for got, want in zip(pr.opt_state, leaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prof, bids, ctx, cands = _requests(sample, [1, 2], (30, 140), 9)
    want = JaxScorer.from_scanned(r).score_batch(prof, bids, ctx, cands)
    _assert_scores(DeviceScorer.from_scanned(pr, device="cpu").score_batch(
        prof, bids, ctx, cands), want)
    # and the port's checkpoint loads in the JAX package
    save_scanned_checkpoint(tmp_path / "port", pr)
    jr = jax_load(tmp_path / "port")
    _assert_scores(JaxScorer.from_scanned(jr).score_batch(
        prof, bids, ctx, cands), want)
    np.testing.assert_array_equal(np.asarray(jr.acc), np.asarray(r.acc))


def test_grouped_checkpoint_saves_plain_rows(trained_grouped, tmp_path):
    r, sample = trained_grouped
    save_scanned_checkpoint(tmp_path, _port_ranker(r))
    jr = jax_load(tmp_path)                   # unpacked to [V, D]
    pr = load_scanned_checkpoint(tmp_path, device="cpu")
    assert tuple(pr.table.shape) == (VOCAB, 8) and pr.packed_group == 1
    prof, bids, ctx, cands = _requests(sample, [3], (40,), 10)
    _assert_scores(DeviceScorer.from_scanned(pr, device="cpu").score_batch(
        prof, bids, ctx, cands),
        JaxScorer.from_scanned(r).score_batch(prof, bids, ctx, cands))
    _assert_scores(JaxScorer.from_scanned(jr).score_batch(
        prof, bids, ctx, cands),
        JaxScorer.from_scanned(r).score_batch(prof, bids, ctx, cands))


def _concurrently(fn, n):
    outs, errs = [None] * n, [None] * n

    def work(i):
        try:
            outs[i] = fn(i)
        except Exception as e:            # reported by the assertions below
            errs[i] = e

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return outs, errs


@pytest.mark.parametrize("max_requests", [4, 32])
def test_micro_batcher_concurrent_matches_jax(trained, max_requests):
    r, sample = trained
    js, ps = _scorers(r, "plain")
    mb = MicroBatcher(ps, max_requests=max_requests, max_wait_s=0.05)
    prof, bids, ctx, cands = _requests(sample, list(range(10)), [21] * 10,
                                       11)
    outs, errs = _concurrently(
        lambda i: mb.submit(prof[i], bids[i], ctx[i], cands[i]), 10)
    assert errs == [None] * 10
    _assert_scores(outs, js.score_batch(prof, bids, ctx, cands))


def test_micro_batcher_failure_reaches_every_waiter():
    class Broken:
        def score_batch(self, *a):
            raise ValueError("boom")

    mb = MicroBatcher(Broken(), max_requests=64, max_wait_s=0.05)
    _, errs = _concurrently(lambda i: mb.submit(
        np.zeros(4, np.float32), np.zeros(5, np.int32),
        np.zeros(2, np.float32), [1, 2]), 6)
    assert all(e is not None for e in errs)     # none left waiting


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_rank_direct_matches_jax(trained):
    r, sample = trained
    js, ps = _scorers(r, "plain")
    pred = SparseRankPredictor(scorer=ps,
                               user_profiles=sample.user_profile[:50],
                               user_behaviors=sample.behavior_ids[:50],
                               default_ctx=sample.ctx[0])
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(background=True)
    url = f"http://127.0.0.1:{srv.port}"
    try:
        items = [[1, 2, 3, 4, 5], [7, 8], [100, 3, 9, 11]]
        outs, errs = _concurrently(lambda i: _post(
            f"{url}/api/v1/recommend",
            {"userId": 3 + i, "itemIdList": items[i]}), 3)
        assert errs == [None] * 3
        for i, (status, out) in enumerate(outs):
            assert status == 200
            lst = out["itemScoreList"]
            assert [e["itemId"] for e in lst] == items[i]
            want = js.score(sample.user_profile[3 + i],
                            sample.behavior_ids[3 + i], sample.ctx[0],
                            np.asarray(items[i], np.int32))
            np.testing.assert_allclose([e["score"] for e in lst], want,
                                       **F32)
        assert _post(f"{url}/api/v1/recommend",
                     {"userId": 1, "itemIdList": []})[0] == 400
        assert _post(f"{url}/api/v1/recommend",
                     {"userId": "x", "itemIdList": [1]})[0] == 400
        with urllib.request.urlopen(f"{url}/service/overview",
                                    timeout=30) as resp:
            assert json.loads(resp.read()) == "do not support overview"
        with urllib.request.urlopen(f"{url}/", timeout=30) as resp:
            assert b"dashboard" in resp.read().lower()
    finally:
        srv.stop()


def _reject_constant(name):
    raise ValueError(f"the body holds a bare {name}, which is not JSON")


@pytest.mark.parametrize("bad", [VOCAB, VOCAB + 7, -1])
def test_http_refuses_item_ids_outside_the_table(trained, bad):
    """An id past the table would score NaN (a bare NaN in the body) and a
    negative one 0.0: both get 400 naming them; a good request's body parses
    as strict JSON."""
    r, sample = trained
    _, ps = _scorers(r, "plain")
    pred = SparseRankPredictor(scorer=ps,
                               user_profiles=sample.user_profile[:50],
                               user_behaviors=sample.behavior_ids[:50],
                               default_ctx=sample.ctx[0])
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(background=True)
    url = f"http://127.0.0.1:{srv.port}/api/v1/recommend"
    try:
        status, out = _post(url, {"userId": 3, "itemIdList": [1, bad, 2]})
        assert status == 400 and out["itemIdsOutsideTable"] == [bad]
        assert str(bad) in out["error"]
        req = urllib.request.Request(
            url, data=json.dumps({"userId": 3, "itemIdList": [0, VOCAB - 1]}
                                 ).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            body = json.loads(resp.read(), parse_constant=_reject_constant)
        scores = [e["score"] for e in body["itemScoreList"]]
        assert len(scores) == 2 and all(0.0 < x < 1.0 for x in scores)
    finally:
        srv.stop()


class _ConstRec:
    """A provider whose user and item features are constants."""

    def get_user_feature(self, ctx, user_id):
        return np.full(3, user_id, np.float32)

    def get_item_feature(self, ctx, item_id):
        return np.full(2, item_id, np.float32)


class _SumModel:
    def predict(self, x):
        return x.sum(1) / 100.0


def test_http_without_rank_direct_is_501():
    """A predictor without rank_direct gets no 501: it is ranked by
    recommend's Rank (host assembly, then its model), as the JAX server
    ranks it."""
    from goctr_tpu_torch.recommend.rcmd import Predictor

    pred = Predictor(rec_sys=_ConstRec(), model=_SumModel())
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(
        background=True)
    try:
        status, out = _post(f"http://127.0.0.1:{srv.port}/api/v1/recommend",
                            {"userId": 1, "itemIdList": [1, 2]})
        assert status == 200
        # no embedding map: the row is [user 1 ×3 | zeros | item ×2]
        lst = out["itemScoreList"]
        assert [e["itemId"] for e in lst] == [1, 2]
        np.testing.assert_allclose([e["score"] for e in lst], [0.05, 0.07],
                                   rtol=1e-6)
    finally:
        srv.stop()


def test_scorer_defaults_to_cuda_and_raises_without_it(trained, monkeypatch):
    pr = _port_ranker(trained[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DeviceScorer.from_scanned(pr)
    with pytest.raises(RuntimeError, match="is_available"):
        load_scanned_checkpoint("unused")
    with pytest.raises(ValueError, match="width"):
        DeviceScorer(pr.model, pr.table, table_packed=True, device="cpu")
