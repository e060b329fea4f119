"""The port's ML-20M-statistics protocol against the JAX package's, on the
CPU: the fixture generator (goctr_tpu_torch/data/ml20m.py), the protocol's
assembly, its three fitters and scripts/parity_ml20m_torch.py.

One tiny database per package, at tests/test_ml20m.py's size (scale
0.004, seed 3, oversample 2.0: 554 users, 107 movies). The generators are
host NumPy and sqlite3 in both packages, so their tables and sidecar
arrays must be equal exactly; so must the assembled train and test
matrices, built from one embedding map (JAX's item2vec, carried across as
numpy rows: the two packages' item2vec draws differ).

The fitters start from JAX's parameters (`convert.ranker_from_jax`, JAX's
epochs=0 state) on the protocol's configuration (f16 storage, bf16
compute, the script's TrainerConfig), with shuffle off and dropout 0 so
that nothing random differs, and train 3 epochs of 20,000 rows at batch
2,048 (30 adam steps). JAX's DIN runs its "xla" pool (JAX cannot
differentiate its Pallas pool); the port's runs "pallas", K2 / K2b's
plain versions on the CPU. The two packages round bf16 products in other
orders and the steps carry that into the parameters: the epoch losses
differ by at most 3e-6 relative (held to LOSS_RTOL = 1e-4), the held-out
AUC by at most 5e-5 and the GAUC by at most 2.5e-4 on these runs, so
both are held to JAX's within AUC_ATOL = 2e-3, well below what the
training moves them (JAX's AUC rises from 0.5 to 0.58-0.60 here).
"""
import dataclasses
import importlib.util
import json
import shutil
import sqlite3
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from goctr_tpu.data.ml20m import generate_ml20m_fixture as jgenerate
from goctr_tpu.data.movielens import MovielensRec as JRec
from goctr_tpu.embedding.store import train_embedding as jtrain_embedding
from goctr_tpu.models import io as jio
from goctr_tpu.models.trainer import TrainerConfig as JCfg
from goctr_tpu.recommend import rcmd as jr

import goctr_tpu_torch.data as tdata
from goctr_tpu_torch.convert import ranker_from_jax
from goctr_tpu_torch.core.metrics import gauc, roc_auc_score
from goctr_tpu_torch.data.ml20m import (GENRES_18, SignalKnobs,
                                        generate_ml20m_fixture)
from goctr_tpu_torch.data.movielens import MovielensRec
from goctr_tpu_torch.embedding.store import EmbeddingMap
from goctr_tpu_torch.models.base import SampleInfo
from goctr_tpu_torch.recommend import rcmd as tr

CPU = "cpu"
TINY = dict(scale=0.004, seed=3, oversample=2.0)
SAMPLE_CNT = 20_000
FIT_EPOCHS = 3
FIT_BATCH = 2048
AUC_ATOL = 2e-3
LOSS_RTOL = 1e-4
NO_DROP = (0.0, 0.0)
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "parity_ml20m_torch.py"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training: with the
    suite's parallel workers each holding every core, more threads only
    wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script():
    spec = importlib.util.spec_from_file_location("parity_ml20m_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(JAX's tiny database, the port's) and each generator's stats."""
    d = tmp_path_factory.mktemp("ml20m")
    js = jgenerate(d / "jax.db", **TINY)
    ps = generate_ml20m_fixture(d / "port.db", **TINY)
    return d / "jax.db", d / "port.db", js, ps


def _tables(path):
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT type, name, sql FROM sqlite_master "
                            "ORDER BY name").fetchall()


def test_generator_writes_the_jax_tables_and_sidecar(dbs):
    jdb, pdb, jstats, pstats = dbs
    assert {k: v for k, v in pstats.items() if k != "wall_s"} == {
        k: v for k, v in jstats.items() if k != "wall_s"}
    schema = _tables(pdb)
    assert schema == _tables(jdb)
    names = [name for kind, name, _ in schema if kind == "table"]
    assert {"movies", "ratings", "ratings_train", "ratings_test",
            "user_feature_train", "user_feature_test", "ub_train",
            "ub_test"} <= set(names)
    with sqlite3.connect(jdb) as j, sqlite3.connect(pdb) as p:
        for t in names:
            want = j.execute(f"SELECT * FROM {t}").fetchall()
            assert len(want) > 0, t
            assert p.execute(f"SELECT * FROM {t}").fetchall() == want, t
    with np.load(f"{jdb}.cols.npz") as j, np.load(f"{pdb}.cols.npz") as p:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("knobs", [
    dict(beta_item=2.5, item_thr=0.5, latent_dim=16, chain_w=10),
    dict(noise=1.2, p_chain=0.0, zipf_s=0.8)])
def test_generator_follows_the_knobs_as_jax_does(tmp_path, knobs):
    """Other knobs (the scale-0.1 protocol's signal knobs among them) move
    both generators the same way, to the same ratings."""
    from goctr_tpu.data.ml20m import SignalKnobs as JKnobs

    kw = dict(scale=0.002, seed=5, oversample=1.6)
    js = jgenerate(tmp_path / "j.db", knobs=JKnobs(**knobs), **kw)
    ps = generate_ml20m_fixture(tmp_path / "p.db", knobs=SignalKnobs(**knobs),
                                **kw)
    assert ps["n_ratings"] == js["n_ratings"]
    q = "SELECT * FROM ratings ORDER BY userId, movieId"
    with sqlite3.connect(tmp_path / "j.db") as j, \
            sqlite3.connect(tmp_path / "p.db") as p:
        assert p.execute(q).fetchall() == j.execute(q).fetchall()


def test_exports_and_constants_match_jax():
    from goctr_tpu.data import ml20m as jm
    from goctr_tpu_torch.data import ml20m as pm

    assert GENRES_18 == jm.GENRES_18
    for name in dir(jm):
        if name.startswith("ML20M_"):
            assert getattr(pm, name) == getattr(jm, name), name
    assert dataclasses.asdict(SignalKnobs()) == dataclasses.asdict(
        jm.SignalKnobs())
    assert tdata.generate_ml20m_fixture is generate_ml20m_fixture
    assert tdata.SignalKnobs is SignalKnobs


@pytest.fixture(scope="module")
def assembled(dbs):
    """Both packages' protocol stages on their own database, from JAX's
    item2vec map: (JAX train sample, the port's, JAX test matrix, the
    port's, test labels, test user ids)."""
    jdb, pdb = dbs[0], dbs[1]
    jrec, prec = (JRec(str(jdb), sample_cnt=SAMPLE_CNT),
                  MovielensRec(str(pdb), sample_cnt=SAMPLE_CNT))
    jrec.pre_train(jr.Context())
    prec.pre_train(tr.Context())
    jmap = jtrain_embedding(jrec.item_seq_generator(jr.Context()),
                            window=jr.ITEM_EMB_WINDOW, dim=jr.ITEM_EMB_DIM,
                            iters=1)
    js_, ps_ = jr._State(), tr._State()
    js_.item_embedding_map = jmap
    ps_.item_embedding_map = EmbeddingMap(
        {w: np.array(v, np.float32) for w, v in jmap.items()})
    jsample = jr.get_sample(jrec, jr.Context(), js_)
    psample = tr.get_sample(prec, tr.Context(), ps_)
    test_cnt = int(5_610_000 * TINY["scale"])
    with np.load(f"{jdb}.cols.npz") as z:       # scripts/parity_ml20m.py
        te = [z[k][:test_cnt] for k in ("test_uid", "test_iid",
                                        "test_rating", "test_ts")]
    jctx = jr.Context().with_stage(jr.Stage.PREDICT)
    jrec.pre_rank(jctx)
    jx = jr._assemble_batch(jctx, js_, jrec, te[0], te[1], te[3])
    uid, iid, y, ts = _script().read_test_slice(prec, pdb, test_cnt)
    pctx = tr.Context().with_stage(tr.Stage.PREDICT)
    prec.pre_rank(pctx)
    px = tr._assemble_batch(pctx, ps_, prec, uid, iid, ts)
    np.testing.assert_array_equal(uid, te[0])
    np.testing.assert_array_equal(y, (te[2] > 3.5).astype(np.float32))
    return jsample, psample, jx, px, y, uid


def test_assembly_equals_jax_bit_for_bit(assembled):
    jsample, psample, jx, px, y, uid = assembled
    assert psample.x.shape == (jsample.rows, 281)
    np.testing.assert_array_equal(psample.x, jsample.x)
    np.testing.assert_array_equal(psample.y, jsample.y)
    assert dataclasses.astuple(psample.info) == tuple(
        tuple(r) for r in dataclasses.astuple(jsample.info))
    assert px.dtype == jx.dtype and px.shape == (len(y), 281)
    np.testing.assert_array_equal(px, jx)
    assert 0.3 < y.mean() < 0.7 and len(np.unique(uid)) > 50


def test_test_slice_by_sql_equals_the_sidecar(dbs, tmp_path):
    """Without the sidecar the script reads the slice by SQL, ordered by
    (timestamp, userId): the same rows."""
    script, pdb = _script(), dbs[1]
    shutil.copy(pdb, tmp_path / "bare.db")
    rec = MovielensRec(str(tmp_path / "bare.db"))
    by_sql = script.read_test_slice(rec, tmp_path / "bare.db", 2000)
    by_npz = script.read_test_slice(rec, pdb, 2000)
    for a, b in zip(by_sql, by_npz):
        np.testing.assert_array_equal(a, b)


def _flat(ranker):
    """JAX ranker state as numpy copies (JAX's resume donates buffers)."""
    flat = {k: np.array(v) for k, v in jio._flatten_params(
        ranker.params).items()}
    leaves = [np.array(x) for x in jax.tree.leaves(ranker.opt_state)]
    return flat, leaves


@pytest.mark.parametrize("name", ["mlp", "youtube", "din"])
def test_fitters_reach_jax_auc(name, assembled, monkeypatch):
    """Each protocol fitter (RankerFitter with the script's TrainerConfig,
    f16 storage, bf16) from JAX's start reaches JAX's held-out AUC and
    GAUC within AUC_ATOL."""
    import goctr_tpu.models as jmodels
    import goctr_tpu_torch.models as pmodels

    jsample, psample, jx, px, y, uid = assembled
    script = _script()
    args = script.parse_args([f"--batch={FIT_BATCH}",
                              f"--epochs={FIT_EPOCHS}",
                              "--attention_impl=pallas", "--device=cpu"])
    pcfg = dataclasses.replace(script.trainer_config(name, FIT_EPOCHS, args),
                               shuffle=False)
    jcfg = JCfg(**dataclasses.asdict(pcfg))
    kw = {} if name == "mlp" else dict(dropout_rates=NO_DROP)
    start = {}
    j_train, p_train = jmodels.train_ranker, pmodels.train_ranker

    def jax_from_epoch0(model, sample, cfg):
        j0 = j_train(model, sample, dataclasses.replace(cfg, epochs=0))
        start["flat"], start["leaves"] = _flat(j0)
        start["info"] = tuple(tuple(r) for r in dataclasses.astuple(
            j0.info))
        return j_train(model, sample, cfg, resume_from=j0)

    def port_from_jax(model, sample, cfg, device):
        s = ranker_from_jax(model, start["flat"], start["leaves"],
                            SampleInfo(*start["info"]), model.behavior_len,
                            device=device)
        return p_train(model, sample, cfg, resume_from=s, device=device)

    monkeypatch.setattr(jmodels, "train_ranker", jax_from_epoch0)
    monkeypatch.setattr(pmodels, "train_ranker", port_from_jax)
    jfit = jr.RankerFitter(name, jcfg, use_bf16=True, **kw).fit(jsample)
    pfit = tr.RankerFitter(name, pcfg, use_bf16=True, device=CPU,
                           **script.model_kwargs(name, args), **kw
                           ).fit(psample)
    assert len(pfit.loss_curve) == len(jfit.loss_curve) == FIT_EPOCHS
    np.testing.assert_allclose(pfit.loss_curve, jfit.loss_curve,
                               rtol=LOSS_RTOL)
    js, ps = jfit.predict(jx), pfit.predict(px)
    j_auc, p_auc = roc_auc_score(y, js), roc_auc_score(y, ps)
    j_gauc, p_gauc = gauc(y, js, uid), gauc(y, ps, uid)
    assert j_auc > 0.55, j_auc               # the fixture's signal is learnt
    assert abs(p_auc - j_auc) < AUC_ATOL, (p_auc, j_auc)
    assert abs(p_gauc - j_gauc) < AUC_ATOL, (p_gauc, j_gauc)


def test_parity_script_prints_the_json_line(dbs, tmp_path, capsys):
    """scripts/parity_ml20m_torch.py on the CPU at the tiny scale: one
    JSON line with the JAX script's keys and the port's; a second run
    reads the assembled-matrix cache."""
    script = _script()
    pdb = tmp_path / "tiny.db"
    shutil.copy(dbs[1], pdb)
    shutil.copy(f"{dbs[1]}.cols.npz", f"{pdb}.cols.npz")
    argv = [f"--db={pdb}", f"--cache_dir={tmp_path}", "--device=cpu",
            "--scale=0.004", "--epochs=1", "--batch=4096",
            "--sample_cnt=8000", "--test_cnt=3000", "--quiet",
            "--attention_impl=pallas", "--models=mlp,din"]
    lines = []
    for _ in range(2):
        script.main(argv)
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        lines.append(json.loads(out[0]))
    assert Path(f"{pdb}.torch_x_8000_3000.npz").exists()
    for line in lines:
        assert {"metric", "auc", "gauc", "ref_auc", "train_examples_per_s",
                "scale", "sample_cnt", "test_cnt", "timings_s", "wall_s",
                "knobs", "device", "attention_impl"} <= set(line)
        assert line["metric"] == "ml20m_quality_parity"
        assert sorted(line["auc"]) == sorted(line["gauc"]) == ["din", "mlp"]
        assert all(0.0 < v < 1.0 for v in line["auc"].values())
        assert line["device"]["type"] == "cpu"
        assert line["attention_impl"] == "pallas"
        assert line["sample_cnt"] == 8000 and line["test_cnt"] == 3000
        assert line["knobs"] == dataclasses.asdict(SignalKnobs())
    assert "assembly_s" in lines[0]["timings_s"]
    assert "assembly_s" not in lines[1]["timings_s"]     # from the cache
    for k in ("mlp", "din"):
        assert abs(lines[1]["auc"][k] - lines[0]["auc"][k]) < 0.01


def test_parity_script_flags(monkeypatch):
    script = _script()
    a = script.parse_args(["--scale=0.1", "--set", "beta=0.45",
                           "--set", "latent_dim=16"])
    assert (a.sample_cnt, a.test_cnt, a.oversample) == (1_440_000, 561_000,
                                                        1.6)
    assert a.mlp_epochs == a.epochs and a.device == "cuda"
    assert a.attention_impl == "xla"
    knobs, kw = script.knobs_of(a.set)
    assert kw == {"beta": 0.45, "latent_dim": 16}
    assert knobs.latent_dim == 16 and isinstance(knobs.latent_dim, int)
    with pytest.raises(SystemExit):
        script.knobs_of(["nope=1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        script.main(["--scale=0.004", "--device=cuda"])
