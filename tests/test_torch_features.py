"""The port's host feature layer against the JAX package's, on the CPU:
features/ (encoders, scalers, discretization, normalizers, text, struct
transformer and the package's exports), core/prng.py, core/profiling.py,
the activations prelu and euclidean_distance, the packages' exports and
the futuresales example (goctr_tpu_torch/examples/futuresales.py).

The feature modules are host NumPy in both packages, so each case runs
the same calls on the same numpy inputs through both and their results
must be equal exactly (tests/test_features.py's golden cases among them).
The normalizers also take torch tensors in the port where JAX's take
jax.numpy arrays: those agree within f32 rounding (1e-6). Torch's random
streams are not JAX's, so PRNGPool is held to its hash (bit for bit) and
to its behaviour; the futuresales regressors draw their own parameters,
so they are held to tests/test_futuresales.py's R² bars.
"""
import dataclasses
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goctr_tpu.features as JF
import goctr_tpu_torch.features as PF
from test_torch_preprocessing import _same

CPU = "cpu"
RNG_SEED = 11


def _values(n=200):
    rng = np.random.default_rng(RNG_SEED)
    return (rng.lognormal(1.0, 1.5, n) * rng.choice([-1, 1], n)).tolist()


def _words(n=300):
    rng = np.random.default_rng(RNG_SEED)
    vocab = ["drama", "comedy", "", "sci-fi", "action", "noir", "war"]
    return [vocab[i] for i in rng.integers(0, len(vocab), n)]


def _docs(n=40):
    rng = np.random.default_rng(RNG_SEED)
    vocab = ["a", "b", "c", "hello", "world", "peace", "x y"]
    return [" ".join(vocab[i] for i in rng.integers(0, 7, rng.integers(
        0, 6))) for _ in range(n)]


# each case: F (a features package) -> a structure of results -----------
def case_onehot(F):
    enc = F.OneHotEncoder().fit(["b", "a", "", "b", "c"] + _words())
    probe = ["a", "zzz", "", "noir", "b"]
    return dict(mapping=enc.mapping, n=enc.num_features,
                names=enc.feature_names(),
                one=[enc.transform(v) for v in probe],
                idx=[enc.transform_index(v) for v in probe],
                batch=enc.transform_batch(probe),
                indices=enc.transform_indices(probe),
                given=F.OneHotEncoder({"x": 1, "y": 0}).transform_batch(
                    ["y", "x", "q"]))


def case_ordinal(F):
    enc = F.OrdinalEncoder().fit(["x", "y", "x"] + _words())
    probe = ["x", "y", "unk", "", "war"]
    return dict(mapping=enc.mapping, one=[enc.transform(v) for v in probe],
                batch=enc.transform_batch(probe))


def _scaler_case(make):
    def case(F):
        vals = _values()
        probe = [-1e9, -3.0, 0.0, 2.5, 7.0, 1e9] + vals[:20]
        s = make(F).fit(vals)
        flat = make(F).fit([2.0, 2.0])
        state = {k: v for k, v in vars(s).items()}
        return dict(state=state, one=[s.transform(v) for v in probe],
                    batch=s.transform_batch(np.asarray(probe)),
                    flat=[flat.transform(v) for v in (1.0, 2.0, 3.0)])
    return case


SCALERS = {
    "identity": lambda F: F.Identity(),
    "minmax": lambda F: F.MinMaxScaler(),
    "maxabs": lambda F: F.MaxAbsScaler(),
    "standard": lambda F: F.StandardScaler(),
    "quantile4": lambda F: F.QuantileScaler(n_quantiles=4),
    "quantile100": lambda F: F.QuantileScaler(),
    "kbins4": lambda F: F.KBinsDiscretizer(n_quantiles=4),
    "kbins20": lambda F: F.KBinsDiscretizer(n_quantiles=20),
}


def case_normalizers(F):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(0, 2, (12, 5))
    x[3] = 0.0
    return dict(l1=F.normalize_l1(x), l2=F.normalize_l2(x),
                l1_axis0=F.normalize_l1(x, axis=0),
                l2_f32=F.normalize_l2(np.asarray([[3, -4], [0, 0]],
                                                 np.float32)),
                c1=F.SampleNormalizerL1().fit(None).transform([3.0, -4.0]),
                c2=F.SampleNormalizerL2().fit(None).transform([3.0, -4.0]),
                c0=F.SampleNormalizerL2().transform([0.0, 0.0]))


def case_count_vectorizer(F):
    cv = F.CountVectorizer().fit(["hello world", "world peace"] + _docs())
    probe = ["world world hello", "world", "unknown", "", "x y a"]
    return dict(mapping=cv.mapping, n=cv.num_features,
                names=cv.feature_names(),
                one=[cv.transform(d) for d in probe],
                batch=cv.transform_batch(probe),
                sep=F.CountVectorizer("|").fit(["a|b", "b|c"]).transform(
                    "b|b|a"))


def case_tfidf(F):
    tv = F.TFIDFVectorizer().fit(["a b", "a c", "a d"] + _docs())
    probe = ["a b", "hello world world", "", "zz"]
    return dict(mapping=tv.mapping, one=[tv.transform(d) for d in probe],
                batch=tv.transform_batch(probe),
                state={k: v for k, v in vars(tv).items()})


def case_struct(F):
    @dataclasses.dataclass
    class Rec:
        age: float
        genre: str
        ignored: str

    recs = [{"age": float(a), "genre": g, "ignored": "x"}
            for a, g in zip(_values(30), _words(30))]
    st = F.StructTransformer([F.MinMaxScaler(), F.OneHotEncoder(), None],
                             fields=["age", "genre", "ignored"]).fit(recs)
    by_pos = F.StructTransformer([F.StandardScaler(), F.OrdinalEncoder()])
    rows = [(r["age"], r["genre"]) for r in recs]
    by_pos.fit(rows)
    objs = [Rec(**r) for r in recs[:5]]
    by_attr = F.StructTransformer(
        [F.MaxAbsScaler(), F.OneHotEncoder(), None],
        fields=["age", "genre", "ignored"]).fit(objs)
    return dict(n=st.num_features, one=[st.transform(r) for r in recs[:6]],
                batch=st.transform_batch(recs), pos=by_pos.transform_batch(
                    rows), attr=by_attr.transform_batch(objs))


CASES = dict({"onehot": case_onehot, "ordinal": case_ordinal,
              "normalizers": case_normalizers,
              "count_vectorizer": case_count_vectorizer,
              "tfidf": case_tfidf, "struct": case_struct},
             **{name: _scaler_case(make) for name, make in SCALERS.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_module_equals_jax(case):
    _same(CASES[case](PF), CASES[case](JF))


def test_golden_values_as_jax_tests_them():
    """tests/test_features.py's golden values, on the port."""
    enc = PF.OneHotEncoder().fit(["b", "a", "", "b", "c"])
    assert enc.mapping == {"b": 0, "a": 1, "c": 2}
    assert PF.OrdinalEncoder().fit(["x", "y", "x"]).transform("y") == 2
    s = PF.MinMaxScaler().fit([1.0, 5.0, 3.0])
    assert s.transform(3.0) == pytest.approx(0.5)
    vals = [2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0]
    assert PF.StandardScaler().fit(vals).std == pytest.approx(
        np.std(vals, ddof=1))
    q = PF.QuantileScaler(n_quantiles=4).fit(list(range(100)))
    assert q.transform(-5) == pytest.approx(0.25)
    d = PF.KBinsDiscretizer(n_quantiles=4).fit(list(range(100)))
    assert (d.transform(-5), d.transform(1000)) == (1.0, 5.0)
    tv = PF.TFIDFVectorizer().fit(["a b", "a c", "a d"])
    raw = np.array([1.0, np.log(3) + 1, 0, 0])
    np.testing.assert_allclose(tv.transform("a b"), raw / np.linalg.norm(
        raw), rtol=1e-12)
    np.testing.assert_allclose(PF.SampleNormalizerL2().transform(
        [3.0, -4.0]), [0.6, -0.8])


@pytest.mark.parametrize("fn", ["normalize_l1", "normalize_l2"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_normalizers_on_tensors_match_jax_arrays(fn, axis):
    """A torch tensor stays a tensor on its device (JAX: a jax.numpy
    array), zero rows stay zero; f32 within 1e-6 of JAX's."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(0, 3, (16, 8)).astype(np.float32)
    x[5] = 0.0
    x[:, 2] = 0.0
    got = getattr(PF, fn)(torch.from_numpy(x), axis=axis)
    want = np.asarray(getattr(JF, fn)(jnp.asarray(x), axis=axis))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    zero = (x == 0).all(axis=axis, keepdims=True)
    assert zero.any() and not (got.numpy() * zero).any()


@pytest.mark.parametrize("name", [n for n in dir(JF) if not n.startswith(
    "_") and n not in ("encoders", "scalers", "discretization",
                       "normalizers", "text", "struct_transformer",
                       "hashing", "ubcache", "preprocessing")])
def test_features_package_exports_the_jax_names(name):
    assert hasattr(PF, name), name
    assert getattr(PF, name).__module__.startswith("goctr_tpu_torch.")


@pytest.mark.parametrize("pkg,names", [
    ("core", ["MeshSpec", "make_mesh", "PRNGPool"]),
    ("ops", ["ACTIVATIONS", "cosine_similarity", "euclidean_distance",
             "prelu", "binary_cross_entropy", "bce_with_logits", "mse",
             "rms"]),
    ("optim", ["FULLBATCH_SOLVERS", "SOLVERS", "fullbatch_minimize",
               "make_solver", "make_schedule"]),
    ("parallel", ["EmbeddingSpec", "init_table", "sharded_lookup",
                  "sharded_pooled_lookup", "SparseCTR", "SparseBatch",
                  "make_sharded_train_step", "TableOptConfig",
                  "TrainedScanned", "train_sparse_scanned"]),
    ("data", ["SignalKnobs", "build_derived_tables",
              "generate_ml20m_fixture", "MovielensRec"])])
def test_package_exports_mirror_jax(pkg, names):
    """Each package's __init__ exports the JAX package's names that the
    port has (the port has no DTypePolicy and no axis helpers)."""
    import importlib

    port = importlib.import_module(f"goctr_tpu_torch.{pkg}")
    jaxp = importlib.import_module(f"goctr_tpu.{pkg}")
    for n in names:
        assert hasattr(port, n), (pkg, n)
        if n not in ("SignalKnobs", "build_derived_tables",
                     "generate_ml20m_fixture"):
            assert hasattr(jaxp, n), (pkg, n)


# ------------------------------------------------------------ core/prng --
@pytest.mark.parametrize("s", ["", "a", "init", "dropout", "foobar",
                               "ünïcode", "x" * 300])
def test_prng_stable_hash_is_jax_bit_for_bit(s):
    from goctr_tpu.core.prng import _stable_hash as jhash
    from goctr_tpu_torch.core.prng import _stable_hash

    assert _stable_hash(s) == jhash(s)
    assert 0 <= _stable_hash(s) < 2 ** 32


def test_prng_pool_streams():
    """tests/test_core.py's behaviour: next() gives a fresh stream every
    call, named() the same stream for a name in every pool of the seed;
    other names and other seeds give other streams."""
    from goctr_tpu_torch.core.prng import PRNGPool

    def draw(g):
        return torch.rand(8, generator=g, device=g.device).tolist()

    pool, pool2 = PRNGPool(7, device=CPU), PRNGPool(7, device=CPU)
    a, b = draw(pool.next("drop")), draw(pool.next("drop"))
    assert a != b
    assert draw(pool2.next("drop")) == a          # counted per pool
    assert draw(pool.named("init")) == draw(pool2.named("init"))
    assert draw(pool.named("init")) == draw(pool.named("init"))
    assert draw(pool.named("init")) != draw(pool.named("drop"))
    assert draw(PRNGPool(8, device=CPU).named("init")) != draw(
        pool.named("init"))
    assert draw(pool.named("drop")) not in (a, b)
    assert pool.named("x").device.type == "cpu"


def test_prng_pool_defaults_to_cuda(monkeypatch):
    from goctr_tpu_torch.core.prng import PRNGPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PRNGPool(0)


# ------------------------------------------------------- core/profiling --
def test_step_timer_equals_jax():
    from goctr_tpu.core.profiling import StepTimer as JTimer
    from goctr_tpu_torch.core.profiling import StepTimer

    t, j = StepTimer(), JTimer()
    assert t.summary() == j.summary() == {} and t.median == 0.0
    for dt in (0.3, 0.1, 0.2, 0.5):
        t.times.append(dt)
        j.times.append(dt)
    assert t.summary() == j.summary()
    assert t.median == j.median == 0.3
    with t:
        pass
    assert len(t.times) == 5 and t.times[-1] >= 0.0


def test_trace_and_annotate_record_the_block(tmp_path):
    """trace() writes a Chrome trace of the block into log_dir, and an
    annotate() region inside it shows by name."""
    from goctr_tpu_torch.core import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("goctr_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = [e.key for e in prof.key_averages()]
    assert "goctr_step" in names
    files = list(tmp_path.rglob("*.json"))
    assert files and "goctr_step" in files[0].read_text()


# ------------------------------------------------------ ops/activations --
def test_prelu_and_euclidean_distance_equal_jax():
    from goctr_tpu.ops import euclidean_distance as jeuc, prelu as jprelu
    from goctr_tpu_torch.ops import euclidean_distance, prelu

    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(0, 2, (4, 3, 8)).astype(np.float32)
    y = rng.normal(0, 2, (4, 1, 8)).astype(np.float32)
    np.testing.assert_allclose(
        euclidean_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jeuc(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(
        euclidean_distance(torch.from_numpy(x[:, 0]),
                           torch.from_numpy(y[:, 0])).numpy(),
        np.linalg.norm(x[:, 0] - y[:, 0], axis=-1), rtol=1e-5)
    for slope in (0.1, 0.0, -0.5):
        np.testing.assert_array_equal(
            prelu(torch.from_numpy(x), slope).numpy(),
            np.asarray(jprelu(jnp.asarray(x), slope)))
    np.testing.assert_allclose(
        prelu(torch.tensor([-2.0, 0.0, 3.0]), 0.1).numpy(), [-0.2, 0, 3],
        atol=1e-7)
    slope = torch.full((8,), 0.25)
    np.testing.assert_array_equal(
        prelu(torch.from_numpy(x), slope).numpy(),
        np.asarray(jprelu(jnp.asarray(x), jnp.full((8,), 0.25))))


# ------------------------------------------------- examples/futuresales --
@pytest.fixture(scope="module")
def sales_db(tmp_path_factory):
    """The futuresales database written by each package's example."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] /
                           "examples"))
    import futuresales as jfs

    from goctr_tpu_torch.examples import futuresales as pfs

    d = tmp_path_factory.mktemp("sales")
    jfs.generate_db(str(d / "j.db"), n_items=100, n_rows=3000, seed=0)
    pfs.generate_db(str(d / "p.db"), n_items=100, n_rows=3000, seed=0)
    return jfs, pfs, str(d / "j.db"), str(d / "p.db")


def test_futuresales_data_and_features_equal_jax(sales_db):
    jfs, pfs, jdb, pdb = sales_db
    for t in ("items", "sales_train"):
        with sqlite3.connect(jdb) as j, sqlite3.connect(pdb) as p:
            assert (p.execute(f"SELECT * FROM {t}").fetchall()
                    == j.execute(f"SELECT * FROM {t}").fetchall())
    args = ("15.03.2014", 14, 7, 42, 128.0, 10, "mega widget 42")
    _same(pfs.feature_transform(*args), jfs.feature_transform(*args))
    assert pfs.feature_transform(*args).shape == (
        31 + 12 + 3 + 34 + 60 + 84 + 7 + 10 + 1 + 100,)
    xp, yp = pfs.load_samples(pdb, 500, offset=100)
    xj, yj = jfs.load_samples(jdb, 500, offset=100)
    _same((xp, yp), (xj, yj))
    y = np.asarray([0.0, 20.0, 123.0])
    _same(pfs.output_recovery(pfs.output_transform(y)),
          jfs.output_recovery(jfs.output_transform(y)))


def test_futuresales_learns_on_the_port(sales_db, capsys):
    """tests/test_futuresales.py's bars (both regressors beat the mean)
    through the port's Neural and MLPRegressor on the CPU."""
    _, pfs, _, pdb = sales_db
    n = torch.get_num_threads()
    torch.set_num_threads(1)         # small batches: more threads only wait
    try:
        res = pfs.run(pdb, train_count=2500, test_count=500, epochs=2,
                      device=CPU)
    finally:
        torch.set_num_threads(n)
    assert res["mlp"][1] > 0.15, res
    assert res["neural"][1] > 0.0, res
    out = capsys.readouterr().out
    assert "training data count: 2500" in out and "R2" in out


def test_futuresales_defaults_to_cuda(monkeypatch):
    from goctr_tpu_torch.examples import futuresales as pfs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pfs.main(["--train_count=10", "--test_count=5"])
