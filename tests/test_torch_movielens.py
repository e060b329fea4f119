"""The port's product path on a MovieLens-shaped SQLite database, against
the JAX package's, on the CPU: the fixture generator, the schema scanners,
MovielensRec's features, the whole Train (SQL → features → item2vec →
assembly → fit → BatchPredict) against JAX's regression bars, the HTTP
round trip through the Rank path, sample files and the CLI.

The database is JAX's standard test fixture (200 users, 300 movies, 12,000
ratings, seed 7), written by each package. MovielensRec compares
`ctx.stage` with its own package's Stage, so each package's features are
read with its own Context; feature vectors are host NumPy on both sides
and must be equal exactly. The port's Train draws its own item2vec and
parameters (no JAX draw can be reproduced), so it is held to JAX's
recorded AUC/GAUC bars at JAX's own ±0.02 (tests/test_movielens.py).
"""
import dataclasses
import json
import sqlite3
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from goctr_tpu.data import pipeline as jpipe
from goctr_tpu.data import schema as jschema
from goctr_tpu.data.fixture import generate_movielens_fixture as jfixture
from goctr_tpu.data.movielens import MovielensRec as JRec
from goctr_tpu.recommend import rcmd as jr

from goctr_tpu_torch import main as tmain
from goctr_tpu_torch.core.metrics import gauc, roc_auc_score
from goctr_tpu_torch.data import pipeline as tpipe
from goctr_tpu_torch.data import schema as tschema
from goctr_tpu_torch.data.fixture import generate_movielens_fixture
from goctr_tpu_torch.data.movielens import MovielensRec
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.recommend import rcmd as tr
from goctr_tpu_torch.serve import api as tapi
from test_movielens import EXPECTED, TOL

CPU = "cpu"
FIXTURE = dict(n_users=200, n_movies=300, n_ratings=12000, seed=7)
TABLES = ("movies", "ratings", "ratings_train", "ratings_test", "user",
          "user_feature_train", "user_feature_test", "ub_train", "ub_test")


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


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(JAX's database, the port's) at the standard fixture."""
    d = tmp_path_factory.mktemp("ml")
    jfixture(d / "jax.db", **FIXTURE)
    generate_movielens_fixture(d / "port.db", **FIXTURE)
    return str(d / "jax.db"), str(d / "port.db")


def _rows(path, table):
    with sqlite3.connect(path) as conn:
        return conn.execute(f"SELECT * FROM {table}").fetchall()


def _schema(path):
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT type, name, sql FROM sqlite_master "
                            "ORDER BY name").fetchall()


def test_fixture_equals_jax_table_for_table(dbs):
    jdb, tdb = dbs
    assert _schema(tdb) == _schema(jdb)
    for table in TABLES:
        want = _rows(jdb, table)
        assert len(want) > 0, table
        assert _rows(tdb, table) == want, table


def test_schema_scanner_equals_jax(dbs):
    jdb, tdb = dbs
    j, t = jschema.SqliteScanner(jdb), tschema.SqliteScanner(tdb)
    assert sorted(t.tables()) == sorted(j.tables())
    assert set(TABLES) <= set(t.tables())
    for table in TABLES:
        assert ([dataclasses.asdict(c) for c in t.get_schema(table)]
                == [dataclasses.asdict(c) for c in j.get_schema(table)])
    q = "SELECT * FROM ratings ORDER BY timestamp LIMIT 5000"
    assert list(t.scan_rows(q)) == list(j.scan_rows(q))
    assert sum(1 for _ in t.scan_rows(
        "SELECT * FROM ratings WHERE userId = ?", (3,))) == sum(
        1 for _ in j.scan_rows("SELECT * FROM ratings WHERE userId = ?",
                               (3,)))
    with pytest.raises(ValueError):
        t.get_schema("nope")
    t.close()
    j.close()


DDLS = [
    """CREATE TABLE `sales` (
      `id` bigint(20) NOT NULL AUTO_INCREMENT,
      `shop_id` int(11) NOT NULL COMMENT 'the shop''s id',
      `price` decimal(10,2) DEFAULT NULL,
      `name` varchar(255) DEFAULT '',
      `sold_at` datetime,
      PRIMARY KEY (`id`),
      KEY `idx_shop` (`shop_id`)
    ) ENGINE=InnoDB DEFAULT CHARSET=utf8mb4""",
    """CREATE TABLE `t` (
      `pair` varchar(64) NOT NULL COMMENT 'shop, item pair',
      `esc` varchar(8) DEFAULT 'a\\'b' COMMENT 'say \\'hi\\', ok (really)',
      `trick` int DEFAULT 1 COMMENT 'NOT NULL PRIMARY KEY, KEY',
      key_id int NOT NULL,
      checksum int,
      PRIMARY KEY (`pair`(10),`key_id`)
    ) ENGINE=InnoDB""",
    "CREATE TEMPORARY TABLE IF NOT EXISTS x (a int PRIMARY KEY, b text)",
]


@pytest.mark.parametrize("ddl", DDLS + ["DROP TABLE sales",
                                        "CREATE TABLE t (a int",
                                        "CREATE TABLE t (PRIMARY KEY (a))"])
def test_parse_mysql_ddl_equals_jax(ddl):
    try:
        want = jschema.parse_mysql_ddl(ddl)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tschema.parse_mysql_ddl(ddl)
        return
    table, cols = tschema.parse_mysql_ddl(ddl)
    assert table == want[0]
    assert ([dataclasses.asdict(c) for c in cols]
            == [dataclasses.asdict(c) for c in want[1]])


@pytest.mark.parametrize("dsn", ["root:secret@db.host:3307/shop",
                                 "alice@localhost/app", "@/", "u:p:q@h/db"])
def test_parse_mysql_dsn_equals_jax(dsn):
    assert tschema._parse_mysql_dsn(dsn) == jschema._parse_mysql_dsn(dsn)


def test_mysql_scanner_raises_without_pymysql(monkeypatch):
    monkeypatch.setitem(sys.modules, "pymysql", None)   # import fails
    with pytest.raises(ImportError, match="pymysql"):
        tschema.MysqlScanner("root:x@localhost/db")


@pytest.fixture(scope="module")
def recs(dbs):
    """(JAX MovielensRec, the port's) after pre_train and pre_rank."""
    j, t = JRec(dbs[0]), MovielensRec(dbs[1])
    j.pre_train(jr.Context())
    t.pre_train(tr.Context())
    j.pre_rank(jr.Context(jr.Stage.PREDICT))
    t.pre_rank(tr.Context(tr.Stage.PREDICT))
    return j, t


@pytest.mark.parametrize("stage", ["TRAIN", "PREDICT"])
def test_features_equal_jax(recs, stage):
    """Item and user features one by one and in batches, the bulk
    behaviors and the sample columns, each with its package's Context."""
    j, t = recs
    jc, tc = jr.Context(jr.Stage[stage]), tr.Context(tr.Stage[stage])
    table = "user_feature_train" if stage == "TRAIN" else "user_feature_test"
    with sqlite3.connect(t.data_path) as conn:
        users = [int(u) for (u,) in conn.execute(
            f"SELECT userId FROM {table}")]
    items = list(range(1, 301))
    for i in items[:40]:
        np.testing.assert_array_equal(t.get_item_feature(tc, i),
                                      j.get_item_feature(jc, i))
    for u in users[:40]:
        np.testing.assert_array_equal(t.get_user_feature(tc, u),
                                      j.get_user_feature(jc, u))
    with pytest.raises(KeyError):
        t.get_item_feature(tc, 99999)
    with pytest.raises(KeyError):
        t.get_user_feature(tc, 99999)
    for kind, ids in (("item", items + [99999]), ("user", users + [99999])):
        got = getattr(t, f"get_{kind}_features_batch")(tc, ids)
        want = getattr(j, f"get_{kind}_features_batch")(jc, ids)
        assert sorted(got) == sorted(want) and 99999 not in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert t.get_item_feature(tc, 1).shape == (53,)
    assert t.get_user_feature(tc, users[0]).shape == (52,)
    cols_t = t.sample_generator_arrays(tc)
    cols_j = j.sample_generator_arrays(jc)
    for a, b in zip(cols_t, cols_j):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    uid = np.asarray(users[:60] + [99999])
    ts = np.linspace(800_000_000, 812_000_000, uid.size).astype(np.int64)
    ts[::7] = 0                             # no time filter
    got = t.get_user_behaviors_bulk(tc, uid, ts, 10)
    np.testing.assert_array_equal(got, j.get_user_behaviors_bulk(
        jc, uid, ts, 10))
    assert (got[-1] == -1).all() and (got >= 0).any()
    for r in range(0, uid.size - 1, 4):
        np.testing.assert_array_equal(
            t.get_user_behavior(tc, int(uid[r]), 10, -1, int(ts[r])),
            j.get_user_behavior(jc, int(uid[r]), 10, -1, int(ts[r])))


def test_sample_generators_and_item_seqs_equal_jax(recs):
    j, t = recs
    jc, tc = jr.Context(), tr.Context()
    assert [dataclasses.astuple(s) for s in t.sample_generator(tc)] == [
        dataclasses.astuple(s) for s in j.sample_generator(jc)]
    assert list(t.item_seq_generator(tc)) == list(j.item_seq_generator(jc))
    assert [dataclasses.astuple(s) for s in t.test_samples(500)] == [
        dataclasses.astuple(s) for s in j.test_samples(500)]
    assert t.get_dashboard_overview(tc) == j.get_dashboard_overview(jc)
    for kind in ("items", "users"):
        assert (t.get_feature_distributions(tc, kind)
                == j.get_feature_distributions(jc, kind))
    assert (t.get_users_feature_overview(tc, 5, 10)
            == j.get_users_feature_overview(jc, 5, 10))
    assert (t.get_items_feature_overview(tc, 0, 0)
            == j.get_items_feature_overview(jc, 0, 0))


def test_assembled_training_sample_equals_jax(recs):
    """get_sample on MovielensRec (vectorized path, SQL batches, bulk
    behaviors) from one embedding map carried across: equal exactly."""
    from goctr_tpu.embedding.store import train_embedding as jemb
    from goctr_tpu_torch.embedding.store import EmbeddingMap

    j, t = recs
    jmap = jemb(j.item_seq_generator(jr.Context()), window=5, dim=16,
                iters=1)
    states = (jr._State(), tr._State())
    states[0].item_embedding_map = jmap
    states[1].item_embedding_map = EmbeddingMap(
        {w: np.array(v, np.float32) for w, v in jmap.items()})
    js = jr.get_sample(j, jr.Context(), states[0])
    ps = tr.get_sample(t, tr.Context(), states[1])
    np.testing.assert_array_equal(ps.x, js.x)
    np.testing.assert_array_equal(ps.y, js.y)
    assert ps.x.shape == (js.rows, 281)
    assert dataclasses.astuple(ps.info) == tuple(
        tuple(r) for r in dataclasses.astuple(js.info))


# ----------------------------------------------------- the whole pipeline --

def _train(db, name, **kw):
    rec = MovielensRec(db, sample_cnt=80000)
    fitter = tr.RankerFitter(
        name, TrainerConfig(batch_size=256, epochs=15, early_stop=0,
                            lr=3e-3, l2=1e-5), device=CPU, **kw)
    return tr.Train(tr.Context(), rec, fitter, device=CPU)


def _eval(predictor):
    rec = predictor.rec_sys
    test = rec.test_samples(limit=4000)
    assert len(test) > 500
    scores = tr.BatchPredict(tr.Context(), predictor, test)
    y = np.asarray([s.label for s in test])
    users = np.asarray([s.user_id for s in test])
    return roc_auc_score(y, scores), gauc(y, scores, users)


@pytest.fixture(scope="module")
def predictor(dbs):
    return _train(dbs[1], "mlp", hidden=(100,), activation="relu")


def test_end_to_end_mlp_regression_bar(predictor):
    auc, g = _eval(predictor)
    e_auc, e_gauc = EXPECTED["mlp"]
    assert abs(auc - e_auc) < TOL, f"MLP AUC {auc} vs expected {e_auc}"
    assert abs(g - e_gauc) < TOL, f"MLP GAUC {g} vs expected {e_gauc}"


@pytest.mark.parametrize("name", ["din", "youtube_dnn"])
def test_end_to_end_ranker_regression_bar(name, dbs):
    """DIN and YouTube-DNN through the port's whole pipeline, each held
    to JAX's recorded bar."""
    auc, g = _eval(_train(dbs[1], name, activation="relu"))
    e_auc, e_gauc = EXPECTED[name]
    assert abs(auc - e_auc) < TOL, f"{name} AUC {auc} vs expected {e_auc}"
    assert abs(g - e_gauc) < TOL, f"{name} GAUC {g} vs expected {e_gauc}"


def test_http_serving_roundtrip(predictor):
    """tests/test_movielens.py's round trip, on the port's Rank path (the
    predictor has no rank_direct) and its copy of the dashboard."""
    server = tapi.RecApiServer(predictor, port=0).start(background=True)
    try:
        base = f"http://127.0.0.1:{server.port}"
        req = urllib.request.Request(
            base + "/api/v1/recommend",
            data=json.dumps({"userId": 1, "itemIdList": [1, 2, 3]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
        assert len(body["itemScoreList"]) == 3
        assert all(0 <= s["score"] <= 1 for s in body["itemScoreList"])

        with urllib.request.urlopen(base + "/service/overview") as r:
            ov = json.loads(r.read())
        assert ov["users"] == 200 and ov["items"] == 300
        assert ov["total_positive"] > 0
        assert ov["valid_positive"] + ov["valid_negative"] > 0
        assert sum(h["count"] for h in ov["rating_hist"]) > 0

        with urllib.request.urlopen(
                base + "/service/items?page=1&size=5") as r:
            items = json.loads(r.read())
        assert len(items["items"]) == 5

        for kind in ("items", "users"):
            with urllib.request.urlopen(
                    base + f"/service/featuredist?kind={kind}") as r:
                fd = json.loads(r.read())
            assert fd["kind"] == kind and fd["sampled"] > 0
            names = {f["feature"] for f in fd["features"]}
            assert {"avg_rating", "cnt_rating", "genre_active_dims"} <= names
            for f in fd["features"]:
                assert sum(b["count"] for b in f["buckets"]) == fd["sampled"]

        req = urllib.request.Request(
            base + "/api/v1/recommend",
            data=json.dumps({"userId": 1, "itemIdList": []}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400

        with urllib.request.urlopen(base + "/") as r:
            html = r.read().decode()
        assert "dashboard" in html.lower()
        for view in ("#/overview", "#/users", "#/items", "#/features",
                     "#/login"):
            assert view in html
        assert html == (tapi._DASHBOARD_HTML.read_text())
    finally:
        server.stop()


def test_dashboard_is_the_jax_page():
    """The port's own copy of JAX's page: the same bytes but one path in
    its opening comment, which names the reference's frontend/ without a
    machine's directory."""
    from pathlib import Path

    import goctr_tpu.serve.api as japi
    ours = tapi._DASHBOARD_HTML.read_text().splitlines()
    theirs = Path(japi._DASHBOARD_HTML).read_text().splitlines()
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert differ == [2] and ours[2].strip().startswith(
        "(the reference's frontend/")
    assert "goctr_tpu_torch/serve" in str(tapi._DASHBOARD_HTML)


def test_sample_files_cross_the_packages(tmp_path, predictor):
    """save_sample in either package, load_sample in the other."""
    rng = np.random.default_rng(3)
    info = tr._sample_info(52, 53)
    sample = tr.TrainSample(x=rng.random((50, 281), dtype=np.float32),
                            y=(rng.random(50) < 0.3).astype(np.float32),
                            info=info)
    tpipe.save_sample(tmp_path / "t.npz", sample)
    got = jpipe.load_sample(tmp_path / "t.npz")
    np.testing.assert_array_equal(got.x, sample.x)
    np.testing.assert_array_equal(got.y, sample.y)
    assert dataclasses.astuple(got.info) == dataclasses.astuple(info)
    jpipe.save_sample(tmp_path / "j.npz", got)
    back = tpipe.load_sample(tmp_path / "j.npz")
    np.testing.assert_array_equal(back.x, sample.x)
    assert back.info == info and isinstance(back, tr.TrainSample)


def test_materialize_caches_the_assembled_sample(tmp_path, dbs):
    rec = MovielensRec(dbs[1])
    rec.pre_train(tr.Context())
    first = tpipe.materialize(rec, tr.Context(), tmp_path, tag="a")
    files = list(tmp_path.glob("sample-*.npz"))
    assert len(files) == 1
    again = tpipe.materialize(rec, tr.Context(), tmp_path, tag="a")
    np.testing.assert_array_equal(again.x, first.x)
    assert first.x.shape[1] == 281
    assert (first.x[:, 52:228] == 0).all()      # no embedding map: zeros


def test_main_fixture_writes_the_jax_database(tmp_path):
    """`--fixture` alone writes main.py's default database (JAX's
    generator at its defaults) and returns before any training."""
    db = tmp_path / "m.db"
    assert tmain.main(["--fixture", f"--data.dsn={db}"]) == 0
    jfixture(tmp_path / "j.db")
    for table in TABLES:
        assert _rows(str(db), table) == _rows(str(tmp_path / "j.db"), table)


def test_main_trains_and_serves(tmp_path, dbs, monkeypatch):
    """The CLI's whole path on the CPU, with the blocking serve replaced:
    Config overrides → MovielensRec → RankerFitter → Train → RecApiServer
    at the configured path and port."""
    started = []
    monkeypatch.setattr(tapi.RecApiServer, "start",
                        lambda self, background=False: started.append(self))
    rc = tmain.main([f"--data.dsn={dbs[1]}", "--optim.max_iter=2",
                     "--serve.port=0", "--serve.api_path=/rank",
                     "--model.use_bf16=false"], device=CPU)
    assert rc == 0 and len(started) == 1
    srv = started[0]
    assert (srv.api_path, srv.port) == ("/rank", 0)
    pred = srv.predictor
    assert len(pred.model.loss_curve) == 2
    assert type(pred.model.model).__name__ == "MLPTower"
    assert pred.model.model.hidden == (100,)
    scores = tr.Rank(tr.Context(), pred, 1, [1, 2, 3])
    assert len(scores) == 3


@pytest.mark.parametrize("argv", [
    [], ["--model.name=din", "--optim.max_iter=3", "--serve.port=0"],
    ["--model.hidden=(64,32)", "--model.use_bf16=false", "--seed=7",
     "--optim.lr=0.01", "--fixture", "--nope.x=1", "positional"]])
def test_config_and_overrides_equal_jax(argv):
    """Config is JAX's field for field, and dotted overrides set the same
    values and leave the same arguments."""
    from goctr_tpu.core.config import Config as JConfig
    from goctr_tpu_torch.core.config import Config

    t, j = Config(), JConfig()
    assert t.apply_overrides(argv) == j.apply_overrides(argv)
    assert t.to_dict() == j.to_dict()
    assert Config.from_dict(j.to_dict()).to_json() == t.to_json()
