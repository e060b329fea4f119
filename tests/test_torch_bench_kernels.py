"""goctr_tpu_torch.bench_kernels against the JAX repository's
scripts/bench_kernels.py, on the CPU.

(a) Subcommands, flags, defaults and reps are read from the JAX script's
    AST; (b) each timed function of the port, fed the same numpy inputs
    as its JAX package counterpart at tiny shapes; (c) `main([..., "--cpu"])`
    prints one line a JAX row, with the JAX row's label, in its order; (d)
    a kernel wrapper that raises or disagrees with its plain version fails
    its subcommand and the process; (e) without a card and without --cpu,
    or with an unknown subcommand, main exits nonzero and prints no result.
No JAX subprocess is started: the JAX script is only parsed.

Tolerances:
  * f32 sums of the same terms in another order (the DIN pool, the mean
    pool, the scatter-adds, adagrad's rsqrt): atol 1e-6, rtol 1e-5
    (TOL["float32"], a few f32 ulps).
  * Copies and gathers (row gathers, sorts, permutes, targets): bit exact.
  * Run sums from differences of f32 prefix sums (sorted_run_sums and the
    compaction candidates, against the JAX package's and against K9's
    block-local sums): each entry within RUNSUM_RTOL = 1e-5 of the prefix
    sum of |g| up to its run's end (~168 f32 ulps of it); ‖Σg‖² within
    Σ(2|s|·lim + lim²) + 1e-6·‖Σg‖².
"""
import ast
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goctr_tpu.ops.pallas.compact import compact_runsums_block
from goctr_tpu.ops.pallas.din_attention import din_attention_pool_jnp
from goctr_tpu.ops.pallas.embedding_lookup import fused_gather_pool_jnp
from goctr_tpu.ops.pallas.row_gather import gather_rows_packed
from goctr_tpu.ops.pallas.row_optimizer import (
    apply_row_updates, apply_row_updates_split, pack_grads)
from goctr_tpu.ops.scatter import scatter_add_rows
from goctr_tpu.ops.segsum import (
    _cumsum_rows, segment_rows_dedup, sorted_run_sums)
from goctr_tpu_torch import bench_kernels as bk

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
JAX_SCRIPT = ROOT / "scripts" / "bench_kernels.py"
ATOL, RTOL = bk.TOL["float32"]
RUNSUM_RTOL = 1e-5
# tiny flags a subcommand runs at in (c) and (d)
TINY = {"din": ["--b=8", "--t=16", "--d=8"],
        "gather": ["--v=1000", "--b=16", "--k=8", "--d=16"],
        "scatter": ["--v=5000", "--n=1024", "--d=8"],
        "fused": ["--v=4099", "--n=1024", "--d=8"],
        "segsum": ["--v=4099", "--n=2048", "--d=8"],
        "stages": ["--v=4099", "--bs=64", "--t=31", "--d=8", "--cap=1024"],
        "rowgather": ["--v=5000", "--n=2048", "--d=8"]}


def t_(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ------------------------------------------------- (a) the JAX script's AST --
def _jax_tree():
    return ast.parse(JAX_SCRIPT.read_text())


def _jax_fn(name):
    return next(n for n in _jax_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_flags(fn):
    """(name, default) of each `_arg(name, default)` call, in order."""
    calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "_arg"),
                   key=lambda n: (n.lineno, n.col_offset))
    return [(c.args[0].value, ast.literal_eval(c.args[1])) for c in calls]


def _template(node):
    """A label's text: a string, or an f-string with its fields as {name}."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant)
                   else "{" + v.value.id + "}" for v in node.values)


def _jax_labels(fn, parts=False):
    """The row labels of a JAX bench function, in source order: the third
    argument of each `_timed_scan` call, the first entry of each (label,
    fn) pair of a for loop, and each string formatted `:28s`. For
    `bench_stages`, the rows of the `--parts` branch or of the rest."""
    branch = next((n for n in ast.walk(fn) if isinstance(n, ast.If)
                   and "--parts" in ast.unparse(n.test)), None)
    in_branch = set() if branch is None else {
        id(n) for b in branch.body for n in ast.walk(b)}
    found = []
    for n in ast.walk(fn):
        if (id(n) in in_branch) != parts:
            continue
        if isinstance(n, ast.Call) and getattr(n.func, "id", "") \
                == "_timed_scan":
            found.append((n.lineno, n.col_offset, _template(n.args[2])))
        elif isinstance(n, ast.For) and isinstance(n.iter, ast.List):
            found += [(e.lineno, e.col_offset, e.elts[0].value)
                      for e in n.iter.elts]
        elif isinstance(n, ast.FormattedValue) and isinstance(
                n.value, ast.Constant) and n.format_spec is not None \
                and ast.unparse(n.format_spec) == "f'28s'":
            found.append((n.lineno, n.col_offset, n.value.value))
    return [label for *_, label in sorted(found)]


def test_subcommands_equal_the_jax_scripts():
    main = _jax_fn("main")
    table = next(n for n in ast.walk(main) if isinstance(n, ast.Dict))
    names = [k.value for k in table.keys]
    assert names == list(bk.BENCHES)
    assert sorted(names) == sorted(bk.FLAGS) == sorted(bk.REPS)
    # `whiches = sys.argv[1:] or ["din"]`
    assert "['din']" in ast.unparse(main)
    assert bk.parse([])[0] == ["din"]


@pytest.mark.parametrize("sub", list(bk.FLAGS))
def test_flags_and_reps_equal_the_jax_scripts(sub):
    fn = _jax_fn(f"bench_{sub}")
    assert list(bk.FLAGS[sub].items()) == _jax_flags(fn)
    reps = fn.args.defaults[0]
    assert fn.args.args[0].arg == "reps" and bk.REPS[sub] == reps.value


def test_switches_equal_the_jax_scripts():
    src = JAX_SCRIPT.read_text()
    for s in bk.SWITCHES:
        assert f'"--{s}" in sys.argv' in src


# --------------------------------------------- (b) the timed functions ---
def test_din_rows_match_jax():
    rng = np.random.default_rng(0)
    beh = rng.normal(size=(8, 16, 8)).astype(np.float32)
    item = rng.normal(size=(8, 8)).astype(np.float32)
    att0, mask = np.ones(16, np.float32), np.ones((8, 16), np.float32)
    want = din_attention_pool_jnp(beh, item, att0, mask)
    for fn in (bk.din_attention_pool_plain, bk.din_attention_pool):
        close(fn(t_(beh), t_(item), t_(att0), t_(mask)), want)


def test_gather_rows_match_jax():
    rng = np.random.default_rng(1)
    table = (rng.normal(size=(1000, 16)) * 0.01).astype(np.float32)
    ids = rng.integers(0, 1000, (16, 8)).astype(np.int32)
    want = fused_gather_pool_jnp(table, ids, "mean")
    for fn in (bk.take_sum, bk.gather_pool):
        close(fn(t_(table), t_(ids)), want)


def _scatter_inputs():
    rng = np.random.default_rng(2)
    table = (rng.normal(size=(5000, 8)) * 0.01).astype(np.float32)
    ids = rng.integers(0, 5000, 1024).astype(np.int32)   # repeats some
    g = rng.normal(size=(1024, 8)).astype(np.float32)
    assert np.unique(ids).size < ids.size
    return table, ids, g


def test_scatter_rows_match_jax():
    table, ids, g = _scatter_inputs()
    got = bk.scatter_plain(t_(table.copy()), t_(g), t_(ids))
    close(got, jnp.asarray(table).at[ids].add(g))
    got = bk.scatter_sorted(t_(table.copy()), t_(g), t_(ids))
    close(got, scatter_add_rows(jnp.asarray(table), jnp.sort(ids), g,
                                sorted_ids=True))


def test_sort_segsum_matches_jax():
    table, ids, g = _scatter_inputs()
    si = jnp.sort(ids)
    seg = jnp.cumsum(jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         (si[1:] != si[:-1]).astype(jnp.int32)])) - 1
    rows = jax.ops.segment_sum(g, seg, num_segments=ids.size,
                               indices_are_sorted=True)
    want = jnp.asarray(table).at[0, :1].add(rows[0, :1])
    close(bk.sort_segsum(t_(table.copy()), t_(g), t_(ids)), want)


def _jax_walk(v, n, reps, junkpct):
    """The JAX script's id walk (scripts/bench_kernels.py bench_fused)."""
    stride = 7_919_993
    assert n <= v and math.gcd(stride, v) == 1
    base = (np.arange(n, dtype=np.int64) * stride) % v
    ids = ((base[None, :] + np.arange(reps, dtype=np.int64)[:, None] * 101)
           % v).astype(np.int32)
    is_junk = None
    if junkpct:
        is_junk = np.random.default_rng(3).random(n) < junkpct / 100.0
        ids = np.where(is_junk[None, :],
                       v + 1 + np.arange(n, dtype=np.int64)[None, :],
                       ids).astype(np.int32)
    return ids, is_junk


@pytest.mark.parametrize("junkpct", [0, 25])
def test_fused_rows_match_jax(junkpct):
    v, n, d, reps = 4099, 1024, 64, 2
    ids, is_junk = bk.fused_ids(v, n, reps, junkpct)
    w_ids, w_junk = _jax_walk(v, n, reps, junkpct)
    np.testing.assert_array_equal(ids, w_ids)
    if junkpct:
        np.testing.assert_array_equal(is_junk, w_junk)
        assert 0 < is_junk.mean() < 0.5
    for r in ids:                       # pairwise distinct a rep
        assert np.unique(r).size == n
    rng = np.random.default_rng(4)
    v_alloc = v + (n + 2 if junkpct else 0)
    table = rng.random((v_alloc, 128), dtype=np.float32)   # acc lanes > 0
    g = rng.normal(size=(n, d)).astype(np.float32)
    if junkpct:
        g *= ~is_junk[:, None]
    gp = np.asarray(pack_grads(g))
    skip_ge = v if junkpct else None
    want = apply_row_updates(jnp.asarray(table), ids[0], gp, bk.FUSED_LR, d,
                             skip_ge=skip_ge, interpret=True)
    want_s = apply_row_updates_split(jnp.asarray(table), ids[0], gp,
                                     bk.FUSED_LR, d, skip_ge=skip_ge)
    close(want_s, want)
    for fn in (bk.fused_rmw, bk.fused_split):
        got = fn(t_(table.copy()), t_(gp), t_(ids[0]), d, skip_ge)
        close(got, want)


def test_fused_ids_refuse_a_walk_that_repeats():
    with pytest.raises(ValueError, match="gcd"):
        bk.fused_ids(7_919_993 * 2, 1024, 2)
    with pytest.raises(ValueError, match="n"):
        bk.fused_ids(1000, 1024, 2)


def test_rowgather_rows_match_jax():
    v, n, d = 5000, 2048, 8
    table = (np.arange(v, dtype=np.float32)[:, None]
             * np.float32(1e-6)).repeat(128, 1)
    ids = np.random.default_rng(5).integers(0, v, n).astype(np.int32)
    want = np.asarray(gather_rows_packed(jnp.asarray(table), ids,
                                         interpret=True))
    tt = t_(table)
    for fn in (bk.take_rows, bk.ring_gather):
        np.testing.assert_array_equal(fn(tt, t_(ids)).numpy(), want)
    np.testing.assert_array_equal(bk.slice_rows(tt, t_(ids), d).numpy(),
                                  want[:, :d])
    np.testing.assert_array_equal(bk.fwd_gather(tt, t_(ids), d).numpy(),
                                  want[:, :d])


def _zipf_stream(n=2048, v=4099, d=64):
    ids = bk.zipf_ids(v, n, 1)[0]
    g = np.random.default_rng(6).normal(size=(n, d)).astype(np.float32)
    return v, ids, g


def test_zipf_ids_are_the_jax_scripts():
    import bench

    rng = np.random.default_rng(0)
    want = np.stack([(bench._zipf_ranks(rng, (2048,), 4099 // 2)
                      * 2_654_435_761) % 4099
                     for _ in range(3)]).astype(np.int32)
    np.testing.assert_array_equal(bk.zipf_ids(4099, 2048, 3), want)


def _runsum_close(got_rows, want_rows, s_g, ends, d):
    """Run sums within RUNSUM_RTOL of the prefix Σ|g| at each run's end
    (`ends`: the end position of each row's run), ‖Σg‖² lanes likewise."""
    prefix = np.cumsum(np.abs(s_g).astype(np.float64), 0)
    lim = RUNSUM_RTOL * prefix[ends]
    got, want = np.asarray(got_rows), np.asarray(want_rows)
    assert (np.abs(got[:, :d] - want[:, :d]) <= lim).all()
    if got.shape[1] > d:
        w = want[:, :d].astype(np.float64)
        nsq_lim = (2 * np.abs(w) * lim + lim * lim).sum(1) \
            + 1e-6 * want[:, d]
        assert (np.abs(got[:, d] - want[:, d]) <= nsq_lim).all()
        np.testing.assert_array_equal(got[:, d + 1:], want[:, d + 1:])


def test_segsum_rows_match_jax():
    v, ids, g = _zipf_stream()
    order = np.asarray(jnp.argsort(ids))
    s_ids, s_g = ids[order], g[order]
    np.testing.assert_array_equal(bk.sort_ids(t_(g), t_(ids)).numpy(),
                                  s_ids)
    np.testing.assert_array_equal(bk.sort_take(t_(g), t_(ids)).numpy(), s_g)
    # a row's run ends at the next position that ends a run
    is_end = np.append(s_ids[1:] != s_ids[:-1], True)
    ends = np.flip(np.minimum.accumulate(np.flip(
        np.where(is_end, np.arange(ids.size), ids.size))))
    _, w_rows = sorted_run_sums(jnp.asarray(s_ids), jnp.asarray(s_g), v + 1)
    _runsum_close(bk.run_sums(t_(g), t_(ids), v), w_rows, s_g, ends, 64)
    tgt, packed = bk.full_front(t_(g), t_(ids), v)
    w_tgt, w_rows = segment_rows_dedup(jnp.asarray(ids), jnp.asarray(g), v)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(w_tgt))
    _runsum_close(packed, pack_grads(w_rows), s_g, ends, 64)


@pytest.fixture(scope="module", params=[1024, 256], ids=["cap1024",
                                                          "cap256"])
def k9(request):
    """A zipf stream, its sort, and K9 (interpret mode) on it at cap."""
    v, ids, g = _zipf_stream()
    cap = request.param
    order = np.asarray(jnp.argsort(ids))
    s_ids, s_g = ids[order], g[order]
    tgt, rows, over = compact_runsums_block(
        jnp.asarray(s_ids), jnp.asarray(s_g), v, cap, interpret=True)
    is_end = np.append(s_ids[1:] != s_ids[:-1], True)
    end_pos = np.flatnonzero(is_end)[:cap]
    return dict(v=v, ids=ids, g=g, cap=cap, s_ids=s_ids, s_g=s_g,
                tgt=np.asarray(tgt), rows=np.asarray(rows),
                total=min(int(is_end.sum()), cap), over=int(over),
                end_pos=end_pos)


def _ends_of(k):
    ends = np.zeros(k["cap"], np.int64)
    ends[:k["total"]] = k["end_pos"]
    return ends


@pytest.mark.parametrize("name", ["compact_ranksort", "compact_searchsorted",
                                  "compact_blocked_sel"])
def test_compaction_candidates_match_k9(k9, name):
    tgt, packed = getattr(bk, name)(t_(k9["g"]), t_(k9["ids"]), k9["v"],
                                    k9["cap"])
    np.testing.assert_array_equal(tgt.numpy(), k9["tgt"])
    _runsum_close(packed, k9["rows"], k9["s_g"], _ends_of(k9), 64)


def test_compact_b_matches_k9(k9):
    tgt, rows = bk.compact_b_no_pack(t_(k9["g"]), t_(k9["ids"]), k9["v"],
                                     k9["cap"])
    np.testing.assert_array_equal(tgt.numpy(), k9["tgt"])
    _runsum_close(rows, k9["rows"][:, :64], k9["s_g"], _ends_of(k9), 64)


@pytest.mark.parametrize("name", ["compact_a_ranksort_only",
                                  "ranksort_boolkey"])
def test_ranksort_candidates_select_k9s_runs(k9, name):
    sel = getattr(bk, name)(t_(k9["g"]), t_(k9["ids"]), k9["v"],
                            k9["cap"]).numpy()
    assert sel.shape == (k9["cap"],)
    np.testing.assert_array_equal(sel[:k9["total"]], k9["end_pos"])
    np.testing.assert_array_equal(k9["s_ids"][sel[:k9["total"]]],
                                  k9["tgt"][:k9["total"]])


def test_cumsum_stages_match_jax():
    v, ids, g = _zipf_stream()
    order = jnp.argsort(ids)
    want = _cumsum_rows(jnp.take(jnp.asarray(g), order, axis=0))[-1:]
    s_g = g[np.asarray(order)]
    lim = RUNSUM_RTOL * np.abs(s_g).astype(np.float64).sum(0)
    got = bk.sort_take_cumsum(t_(g), t_(ids)).numpy()
    assert (np.abs(got - np.asarray(want)) <= lim).all()
    want16 = _cumsum_rows(jnp.take(jnp.asarray(g).astype(jnp.bfloat16),
                                   order, axis=0).astype(jnp.float32))[-1:]
    got16 = bk.permute_cumsum_bf16(t_(g), t_(ids)).numpy()
    assert (np.abs(got16 - np.asarray(want16)) <= lim).all()


# ------------------------------------------- (c) main on the CPU --------
def _rows(out):
    """The label of each printed row, in order."""
    return [line.split(" ms/call")[0].rsplit(maxsplit=1)[0].rstrip()
            for line in out.splitlines() if " ms/call " in line]


@pytest.mark.parametrize("sub,parts", [(s, False) for s in bk.FLAGS]
                         + [("stages", True)])
def test_main_prints_the_jax_rows_in_order(capsys, sub, parts):
    argv = [sub, *TINY[sub], "--reps=2", "--cpu"] + (["--parts"] * parts)
    assert bk.main(argv) == 0
    out = capsys.readouterr().out
    d = int(next(a for a in TINY[sub] if a.startswith("--d="))[4:])
    want = [label.format(d=d)
            for label in _jax_labels(_jax_fn(f"bench_{sub}"), parts)]
    assert want and _rows(out) == want
    assert out.splitlines()[0] == "backend: cpu"
    if sub == "din":
        assert "pallas/jnp speedup: " in out


# ------------------------------------- (d) a failing row, (e) refusals ---
def _raise(*a, **k):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("name,patch", [
    ("din_attention_pool", _raise),
    ("fused_gather_pool", lambda t, i, c="sum":
     bk.fused_gather_pool_plain(t, i, c) + 1e-3),
    ("apply_row_updates", _raise),
    ("gather_rows", lambda t, i, **k: bk.take_rows(t, i).roll(1, 0))])
def test_a_failing_kernel_row_fails_main(capsys, monkeypatch, name, patch):
    sub = {"din_attention_pool": "din", "fused_gather_pool": "gather",
           "apply_row_updates": "fused", "gather_rows": "rowgather"}[name]
    monkeypatch.setattr(bk, name, patch)
    argv = [sub, "scatter", *TINY[sub], *TINY["scatter"], "--reps=2",
            "--cpu"]
    assert bk.main(argv) == 1
    out = capsys.readouterr().out
    assert f"[{sub}] FAILED: RuntimeError" in out
    # the later subcommand still ran
    assert _rows(out)[-3:] == _jax_labels(_jax_fn("bench_scatter"))


def test_main_without_a_card_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bk.main(["din", *TINY["din"]]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--cpu" in cap.err


@pytest.mark.parametrize("argv,match", [
    (["nope", "--cpu"], "unknown bench 'nope'"),
    (["din", "--x=1", "--cpu"], "unknown flag '--x=1'"),
    (["din", "--b=two", "--cpu"], "not an integer")])
def test_main_refuses_unknown_arguments(capsys, argv, match):
    assert bk.main(argv) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and match in cap.err


def test_first_flag_counts_as_in_the_jax_script():
    assert bk.parse(["--t=16", "--t=31"])[1] == {"t": 16}


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::din_pool_kernel<float, 4>(float const*)",
     "din_pool_kernel"),
    ("row_gather_kernel(float const*, int const*, float*, long long)",
     "row_gather_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)",
     "vectorized_elementwise_kernel CUDAFunctor_add"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> > >(int, T3)", "elementwise_kernel MulFunctor"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>(cuda::detail::TensorInfo)",
     "indexSelectLargeIndex"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD")])
def test_kernel_name_reads_profiler_keys(key, name):
    from goctr_tpu_torch.utils.timing import kernel_name

    assert kernel_name(key) == name
