"""goctr_tpu_torch.profile_assembly against the JAX repository's
scripts/profile_assembly.py, on the CPU, on a small fixture made by the
port's ML-20M-statistics generator (277 users).

Assembly is host NumPy in both packages, so with the same random item
vectors (`--fake-emb`) the port's matrix must equal, bit for bit, the one
the JAX package's functions build through the script's stages. The JAX
script's own `main` runs in this process (it imports JAX's modules, no
subprocess): the port prints its stage labels in its order and the same
rows and width.
"""
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from goctr_tpu_torch import profile_assembly as pa
from goctr_tpu_torch.data.ml20m import generate_ml20m_fixture

ROOT = Path(__file__).resolve().parents[1]
SCALE = 0.002                           # 277 users × 100 movies
CNTS = [1_440_000, 5_000]               # every training row; a cut


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    path = tmp_path_factory.mktemp("assembly") / "ml20m.db"
    stats = generate_ml20m_fixture(path, scale=SCALE, oversample=1.6)
    assert 200 <= stats["n_users"] <= 400
    return str(path)


def jax_matrix(db, cnt):
    """The JAX script's stages (scripts/profile_assembly.py main, with
    --fake-emb) through the JAX package's functions: the [n, W] matrix."""
    from goctr_tpu.data.movielens import MovielensRec
    from goctr_tpu.embedding.store import EmbeddingMap
    from goctr_tpu.native.hashing import gather_emb_rows_into, gather_rows_into
    from goctr_tpu.recommend import rcmd

    rec = MovielensRec(db, sample_cnt=cnt)
    ctx = rcmd.Context(stage=rcmd.Stage.TRAIN)
    state = rcmd._State()
    rec.pre_train(ctx)
    mids = [r[0] for r in rec.db.execute("SELECT movieId FROM movies")]
    rngf = np.random.default_rng(0)
    state.item_embedding_map = EmbeddingMap(
        {str(m): rngf.standard_normal(rcmd.ITEM_EMB_DIM).astype(np.float32)
         for m in mids})
    uid, iid, _, ts = rec.sample_generator_arrays(ctx)
    uid = np.asarray(uid, np.int64)
    iid = np.asarray(iid, np.int64)
    ts = np.asarray(ts, np.int64)
    users = rcmd._fetch_features_unique(ctx, state, rec,
                                        np.unique(uid).tolist(), "user")
    items = rcmd._fetch_features_unique(ctx, state, rec,
                                        np.unique(iid).tolist(), "item")
    u_mat, u_rows = rcmd._feature_matrix(users)
    i_mat, i_rows = rcmd._feature_matrix(items)
    words, emb_mat = state.item_embedding_map.as_arrays()
    emb_mat = np.concatenate(
        [np.zeros((1, emb_mat.shape[1]), np.float32), emb_mat])
    int_words = np.asarray([int(w) for w in words], np.int64)
    order = np.argsort(int_words)
    iw_sorted = int_words[order]

    def emb_rows_of(q):
        q = np.asarray(q, np.int64)
        pos = np.searchsorted(iw_sorted, q).clip(0, iw_sorted.size - 1)
        return np.where(iw_sorted[pos] == q, order[pos] + 1, 0)

    beh_items = rec.get_user_behaviors_bulk(ctx, uid, ts,
                                            rcmd.USER_BEHAVIOR_LEN)
    beh_idx = np.where(beh_items >= 0, emb_rows_of(beh_items.clip(0)), 0)
    ub0 = u_mat.shape[1]
    ub1 = ub0 + rcmd.ITEM_EMB_DIM * rcmd.USER_BEHAVIOR_LEN
    it1 = ub1 + rcmd.ITEM_EMB_DIM
    x = np.empty((uid.size, it1 + i_mat.shape[1]), np.float32)
    gather_rows_into(x, 0, u_mat, u_rows(uid))
    gather_rows_into(x, it1, i_mat, i_rows(iid))
    gather_rows_into(x, ub1, emb_mat, emb_rows_of(iid))
    gather_emb_rows_into(x, ub0, emb_mat, beh_idx)
    return x


def jax_script_output(db, cnt, monkeypatch):
    """stdout of the JAX script's main, run in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_profile_assembly", ROOT / "scripts" / "profile_assembly.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["profile_assembly.py", f"--db={db}",
                                      f"--cnt={cnt}", "--fake-emb"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _labels(out):
    return [line[2:26].rstrip() for line in out.splitlines()
            if line.startswith("  ") and line.endswith("s")]


def _rows_width(out):
    last = out.splitlines()[-1].split()
    assert last[0] == "rows" and last[2] == "width" and last[4] == "total"
    return int(last[1]), int(last[3])


@pytest.mark.parametrize("cnt", CNTS)
def test_matrix_equals_the_jax_packages(db, cnt):
    x, stages = pa.profile(db, cnt, fake_emb=True, device="cpu",
                           say=lambda m: None)
    want = jax_matrix(db, cnt)
    assert x.dtype == np.float32 and x.shape == want.shape
    assert x.shape[1] == 281 and (cnt > x.shape[0] or x.shape[0] == cnt)
    np.testing.assert_array_equal(x, want)
    assert "fake emb map" in stages and "item2vec (1 iter)" not in stages


@pytest.mark.parametrize("cnt", CNTS)
def test_prints_the_jax_scripts_stages(db, cnt, capsys, monkeypatch):
    want = jax_script_output(db, cnt, monkeypatch)
    capsys.readouterr()
    assert pa.main([f"--db={db}", f"--cnt={cnt}", "--fake-emb", "--cpu"]) \
        == 0
    out = capsys.readouterr().out
    assert _labels(out) == _labels(want) and len(_labels(want)) == 11
    assert _rows_width(out) == _rows_width(want)


def test_item2vec_stage_trains_on_the_given_device(db, capsys):
    assert pa.main([f"--db={db}", "--cnt=2000", "--cpu"]) == 0
    out = capsys.readouterr().out
    labels = _labels(out)
    assert labels[1] == "item2vec (1 iter)" and "fake emb map" not in labels
    assert _rows_width(out) == (2000, 281)
    x, _ = pa.profile(db, 2000, device="cpu", say=lambda m: None)
    assert np.isfinite(x).all()
    assert np.abs(x[:, 52:52 + 160]).sum() > 0     # behavior embeddings


def test_main_without_a_card_prints_no_result(db, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pa.main([f"--db={db}", "--fake-emb"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--cpu" in cap.err


@pytest.mark.parametrize("argv,match", [
    (["--cpu"], "--db=<fixture.db> required"),
    (["--db=x.db", "--cnt=many", "--cpu"], "invalid literal"),
    (["--db=x.db", "--fake", "--cpu"], "unknown argument '--fake'")])
def test_main_refuses_bad_arguments(capsys, argv, match):
    assert pa.main(argv) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and match in cap.err
