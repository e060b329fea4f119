"""The port's bench entry points against the JAX repository's own, on the
CPU: goctr_tpu_torch.bench against the root bench.py,
goctr_tpu_torch.bench_serving against scripts/bench_serving.py and
goctr_tpu_torch.bench_item2vec against scripts/bench_item2vec.py.

The workload and corpora equal the JAX scripts' bit for bit; the port
reads the same flags; `--smoke --cpu` prints bench.py `--smoke`'s keys in
its order with its flops, bytes, workload and ceiling. The two packages'
random streams differ (initial parameters, shuffles), so their trained
readings are held to bars, not to each other. The JAX scripts run as
subprocesses (bench_serving.py imports JAX at module level) beside the
port's, in one module fixture that keeps to two CPUs.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from goctr_tpu_torch import bench as port_bench  # noqa: E402
from goctr_tpu_torch import bench_item2vec as port_w2v  # noqa: E402
from goctr_tpu_torch import bench_serving as port_serving  # noqa: E402

FIELDS = ("user_profile", "behavior_ids", "item_ids", "ctx", "labels")
# bench.py's make_workload docstring: "a model can reach ~0.6 on
# popularity alone". One trainer seed of --smoke must clear that: the
# port's seeds 0-4 read 0.690-0.806 (seed 0, the bench's, 0.690) and JAX's
# seed 0 0.796. tests/test_torch_bench_depth.py holds the five-seed means
# to SMOKE_FLOOR (0.70) and to each other.
SMOKE_LEARNED = 0.6
VARIANT = ["--eval=clean", "--zipf=0", "--mode=sorted", "--no-serve-bench"]
SERVING = ["--cpu", "--requests=4", "--items=20", "--threads=2"]
RUN_TIMEOUT_S = 600


def _jax_item2vec():
    """scripts/bench_item2vec.py as a module (it imports numpy only at
    module level; JAX inside main)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_item2vec", ROOT / "scripts" / "bench_item2vec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a command's launcher: pin the process to one CPU before it imports
# anything (torch's and XLA's thread pools then size themselves to it),
# then run a script's path or a module as __main__
LAUNCH = ("import os, runpy, sys\n"
          "os.sched_setaffinity(0, {int(sys.argv[1])})\n"
          "target = sys.argv[2]\n"
          "sys.argv = sys.argv[2:]\n"
          "if target.endswith('.py'):\n"
          "    runpy.run_path(target, run_name='__main__')\n"
          "else:\n"
          "    runpy.run_module(target, run_name='__main__', alter_sys=True)\n")
# two lanes of three commands, each lane on one CPU: the file keeps to
# about two cores beside the other test workers
LANES = (
    {"jax": ["bench.py", "--smoke"],
     "jax serving": ["scripts/bench_serving.py", *SERVING],
     "port serving": ["goctr_tpu_torch.bench_serving", *SERVING]},
    {"jax variant": ["bench.py", "--smoke", *VARIANT],
     "port": ["goctr_tpu_torch.bench", "--smoke", "--cpu"],
     "port variant": ["goctr_tpu_torch.bench", "--smoke", "--cpu",
                      *VARIANT]},
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """stdout of each command of LANES: the root bench.py --smoke (and
    VARIANT), scripts/bench_serving.py and the port's three counterparts,
    each lane's commands one after another on one CPU, the lanes side by
    side. JAX's compilation cache goes under a temporary directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", GOCTR_COMPILE_CACHE=str(
        tmp_path_factory.mktemp("jax_cache")))
    cpus = sorted(os.sched_getaffinity(0))

    def lane(i):
        out = {}
        for name, cmd in LANES[i].items():
            p = subprocess.run(
                [sys.executable, "-c", LAUNCH, str(cpus[-1 - i % len(cpus)]),
                 *cmd], cwd=ROOT, env=env, text=True, capture_output=True,
                timeout=RUN_TIMEOUT_S)
            assert p.returncode == 0, (name, p.stderr[-3000:])
            out[name] = p.stdout
        return out

    with ThreadPoolExecutor(len(LANES)) as pool:
        outs = list(pool.map(lane, range(len(LANES))))
    return {k: v for out in outs for k, v in out.items()}


def _line(stdout: str) -> dict:
    """The JSON line: the last line of the output."""
    return json.loads(stdout.strip().splitlines()[-1])


def _prefix(workload: str) -> str:
    return workload.split("loss_last=")[0]


@pytest.mark.parametrize("zipf,noisy", [(True, True), (True, False),
                                        (False, True), (False, False)])
def test_make_workload_is_bench_py(zipf, noisy):
    want, w_uids, w_oracle = bench.make_workload(2_000, 10_000, 8, 8, 4,
                                                 zipf=zipf, noisy=noisy)
    got, g_uids, g_oracle = port_bench.make_workload(2_000, 10_000, 8, 8, 4,
                                                     zipf=zipf, noisy=noisy)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(g_uids, w_uids)
    assert g_oracle.dtype == w_oracle.dtype
    assert np.array_equal(g_oracle, w_oracle)


def test_split_and_compact_cap_are_bench_py():
    """bench.py's split (:163-174) and compact_cap rule (:186-194): auto
    only in fused mode outside --smoke, --compact=N overrides."""
    full, uids, oracle = bench.make_workload(3_000, 10_000, 8, 8, 4)
    d = port_bench.split_workload(2_000, 10_000, 8, 8, 4, eval_rows=1_000)
    for f in FIELDS:
        assert np.array_equal(getattr(d.sample, f), getattr(full, f)[:2000])
        assert np.array_equal(getattr(d.eval_sample, f),
                              getattr(full, f)[2000:])
    assert np.array_equal(d.eval_uids, uids[2000:])
    assert np.array_equal(d.eval_oracle, oracle[2000:])
    b0 = np.concatenate([full.behavior_ids[:512].ravel(),
                         full.item_ids[:512]])
    uniq0 = len(np.unique(b0[b0 >= 0]))
    auto = -(-int(uniq0 * 1.15) // 1024) * 1024
    assert port_bench.first_batch_ids(d.sample, 512) == (uniq0, len(b0))
    assert port_bench.bench_compact_cap(d.sample, 512) == auto

    def cap(*flags):
        return port_bench.settings(["--batch=512", *flags]).compact_cap(
            d.sample)

    assert cap() == auto
    assert cap("--mode=dedup") == 0
    assert cap("--compact=0") == 0 and cap("--compact=4096") == 4096
    assert port_bench.settings(["--smoke"]).compact_cap(d.sample) == 0


def test_flags_are_bench_py():
    """Every flag the root bench.py reads (`_arg("...")` and "--..." in
    sys.argv), with its defaults, and --cpu besides."""
    src = (ROOT / "bench.py").read_text()
    values = set(re.findall(r'_arg\("(\w+)"', src))
    switches = set(re.findall(r'"--([\w-]+)"\s+(?:not\s+)?in\s+sys\.argv',
                              src))
    assert "gather" in values and "no-eval" in switches
    assert set(port_bench.VALUE_FLAGS) == values
    assert set(port_bench.SWITCHES) == switches | {"cpu"}
    for name, default in re.findall(r'_arg\("(\w+)", "([^"]*)"\)', src):
        assert port_bench.VALUE_FLAGS[name] == default, name
    s = port_bench.settings([])
    assert (s.rows, s.vocab, s.t, s.u, s.c, s.hidden, s.batch, s.epochs,
            s.eval_rows, s.dim) == (5_000_000, 10_000_000, 32, 48, 16,
                                    (1024, 512, 256), 65_536, 4, 250_000, 64)
    assert (s.mode, s.zipf, s.noisy, s.compact, s.tlr, s.rmw,
            s.compact_impl, s.eval, s.serve, s.cpu) == (
        "fused", True, True, "auto", 2.0, "split", "xla", True, True, False)
    smoke = port_bench.settings(["--smoke", "--dim=16", "--rows=9"])
    assert (smoke.rows, smoke.vocab, smoke.dim, smoke.hidden) == (
        20_000, 10_000, 64, (64, 32))


@pytest.mark.parametrize("argv,match", [
    (["--gather=pallas", "--cpu"], "gather_impl is a deliberate gap"),
    (["--gather=ring"], "gather_impl is a deliberate gap"),
    (["--smok"], "unknown argument"),
    (["--batch"], "unknown argument"),
    (["--epochs=1", "--cpu"], "2 or more"),
], ids=["pallas", "ring", "typo", "no value", "one epoch"])
def test_bad_flags_exit_nonzero(argv, match):
    with pytest.raises(SystemExit) as e:
        port_bench.main(argv)
    assert isinstance(e.value.code, str) and match in e.value.code


def test_take_is_accepted():
    assert port_bench.settings(["--gather=take"]) == port_bench.settings([])


def test_card_peaks():
    assert port_bench.card_peaks("NVIDIA H100 80GB HBM3") == (989.4e12,
                                                              3.35e12)
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-40GB"):
        port_bench.card_peaks("NVIDIA A100-SXM4-40GB")


@pytest.mark.parametrize("mod", [port_bench, port_serving, port_w2v],
                         ids=["bench", "bench_serving", "bench_item2vec"])
def test_entry_point_needs_a_card(mod, monkeypatch, capsys):
    """Without a card and without --cpu: nonzero, no result printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--cpu" in out.err


def test_bench_line_arithmetic():
    """bench_line's rates against hand arithmetic, with the card's peaks
    and without (null)."""
    from goctr_tpu_torch.parallel.scanned import (
        model_bytes_per_example, model_flops_per_example)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    s = port_bench.settings(["--smoke"])
    model = SparseCTR(**s.model_cfg(), device="cpu")
    ranker = types.SimpleNamespace(model=model, epoch_times=[9.0, 2.0, 2.0],
                                   loss_curve=[0.69, 0.51234])
    draw = port_bench.split_workload(1_000, s.vocab, s.t, s.u, s.c,
                                     eval_rows=200)
    run = port_bench.Run(settings=s, draw=draw, ranker=ranker, seed=0,
                         compact_cap=0, first_batch=(300, 900), launches={},
                         peak_gb=None)
    eps = 2 * 1_000 / 4.0
    flops = model_flops_per_example(model, s.t)
    nbytes = model_bytes_per_example(model, s.t, "fused", real_frac=1 / 3)
    line = port_bench.bench_line(
        run, {"eval_auc": 0.712345, "eval_gauc": 0.7, "metric_err": 0.0},
        None, (1e9, 2e9))
    assert list(line) == ["metric", "value", "unit", "vs_baseline",
                          "model_flops_per_example", "mfu_pct",
                          "model_bytes_per_example", "hbm_util_pct",
                          "workload", "eval_auc", "eval_gauc"]
    assert line["value"] == eps
    assert line["vs_baseline"] == round(eps / (79_948 / 28.0), 2)
    assert line["model_flops_per_example"] == round(flops)
    assert line["mfu_pct"] == round(100 * eps * flops / 1e9, 2)
    assert line["model_bytes_per_example"] == round(nbytes)
    assert line["hbm_util_pct"] == round(100 * eps * nbytes / 2e9, 2)
    assert line["eval_auc"] == 0.7123
    assert line["workload"].endswith("loss_last=0.5123")
    cpu = port_bench.bench_line(run, None, {"serving_scores_per_s": 1.26},
                                None)
    assert cpu["mfu_pct"] is None and cpu["hbm_util_pct"] is None
    assert cpu["serving_scores_per_s"] == 1.3 and "eval_auc" not in cpu


def test_smoke_line_matches_bench_py(runs):
    jax_, port = _line(runs["jax"]), _line(runs["port"])
    assert list(port) == list(jax_) == cs.BENCH_KEYS
    for k in ("metric", "unit", "model_flops_per_example",
              "model_bytes_per_example", "eval_auc_ceiling"):
        assert port[k] == jax_[k], k
    assert _prefix(port["workload"]) == _prefix(jax_["workload"])
    assert SMOKE_LEARNED < port["eval_auc"] < port["eval_auc_ceiling"]
    assert 0.5 < port["eval_gauc"] < 1.0
    assert port["mfu_pct"] is None and port["hbm_util_pct"] is None
    assert port["value"] > 0 and port["vs_baseline"] > 0
    assert port["serving_scores_per_s"] > 0
    assert port["serving_device_scores_per_s"] > 0
    assert len(runs["port"].strip().splitlines()) == 1  # no card line


def test_variant_line_matches_bench_py(runs):
    """--eval=clean --zipf=0 --mode=sorted --no-serve-bench: no ceiling
    and no serving keys in either."""
    jax_, port = _line(runs["jax variant"]), _line(runs["port variant"])
    assert list(port) == list(jax_)
    assert "eval_auc_ceiling" not in port
    assert not any(k.startswith("serving") for k in port)
    for k in ("model_flops_per_example", "model_bytes_per_example"):
        assert port[k] == jax_[k], k
    assert _prefix(port["workload"]) == _prefix(jax_["workload"])
    assert "table_update=sorted ids=uniform" in port["workload"]


def test_bench_serving_matches_jax_script(runs):
    """Both print the same request fields and score all 4 × 20."""
    def parse(stdout):
        head, rate = stdout.strip().splitlines()[-2:]
        fields = dict(f.split("=", 1) for f in head.split())
        return fields, int(re.match(r"HTTP serving: (\d+) scores",
                                    rate).group(1))

    (jf, jn), (pf, pn) = (parse(runs["jax serving"]),
                          parse(runs["port serving"]))
    assert jn == pn == 80
    assert jf == pf == {"backend": "cpu", "threads": "2", "requests": "4",
                        "items/req": "20"}


def test_item2vec_corpora_are_the_jax_script():
    jax_ = _jax_item2vec()
    want = jax_.make_corpus(20_000, 300, 400, seed=3)
    got = port_w2v.make_corpus(20_000, 300, 400, seed=3)
    assert len(got) == len(want) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(got, want))
    want, w_cl = jax_.make_cluster_corpus(20_000, 300, 10, 400, seed=3)
    got, g_cl = port_w2v.make_cluster_corpus(20_000, 300, 10, 400, seed=3)
    assert np.array_equal(g_cl, w_cl)
    assert len(got) == len(want) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(got, want))


def test_neighbor_purity_is_the_jax_script():
    """The numpy oracle on the same vectors and ids (the JAX script reads
    them from its model: a stand-in gives it ours)."""
    jax_ = _jax_item2vec()
    rng = np.random.default_rng(5)
    cluster_of = np.arange(300) // 30
    ids = rng.permutation(300)
    vecs = rng.normal(size=(300, 16)) + 4.0 * np.eye(16)[cluster_of[ids]]

    class Dictionary:
        def __len__(self):
            return len(ids)

        def word(self, i):
            return str(ids[i])

    model = types.SimpleNamespace(vectors=lambda: vecs,
                                  dictionary=Dictionary())
    assert np.array_equal(port_w2v.item_ids(model), ids)
    want = jax_.neighbor_purity(model, cluster_of, n_query=100)
    got = port_w2v.neighbor_purity(vecs, ids, cluster_of, n_query=100)
    assert got == want and got > 0.5


@pytest.fixture
def small_corpora(monkeypatch):
    """The item2vec bench's corpora at 50,000 words."""
    small = dict(n_words=50_000, vocab=1_000, n_docs=1_000)
    for name, extra in (("make_corpus", {}),
                        ("make_cluster_corpus", {"n_clusters": 50})):
        full = getattr(port_w2v, name)
        monkeypatch.setattr(port_w2v, name,
                            lambda full=full, extra=extra: full(**small,
                                                                **extra))


def test_item2vec_bench_lines(small_corpora, capsys):
    assert port_w2v.main(["--cpu", "--quality", "--batch=8192",
                          "--iters=2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend: cpu"
    assert out[1].startswith("corpus: ")
    assert out[2].startswith("warm-up iter")
    assert re.match(r"steady: \d+ pair-updates / [\d.]+s = [\d.]+M pairs/s"
                    r"  \(\d+k words/s\) batch=8192 iters=2 skipgram\+hs$",
                    out[3]), out[3]
    purity = float(re.match(r"at-scale top-5 neighbor cluster purity: "
                            r"([\d.]+)", out[4]).group(1))
    # 50 clusters: random neighbours share the query's 1 time in 50
    assert purity > 10 / 50


def test_item2vec_stagebreak(small_corpora, capsys):
    assert port_w2v.main(["--cpu", "--stagebreak", "--batch=8192",
                          "--iters=1", "--model=cbow",
                          "--optimizer=ns"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split("  ")[1].strip() for line in out[3:]] == [
        label for _, label in port_w2v.STAGES]
    assert all(line.endswith("s/iter") for line in out[3:])
