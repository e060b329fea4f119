"""The port's spans (goctr_tpu_torch/core/profiling.py) and their places in
the scanned trainer, on the CPU: spans nest, an outermost span starts the
store again, the off path touches neither the profiler's host ranges nor
CUDA, a profiler records every span as a host op (`cpu_op`, never a
`user_annotation`) on the store's clock, the recorder leaves every update
mode's results bit for bit as they were, and each step holds its six
stages."""
import json

import pytest
import torch

from goctr_tpu_torch.core import profiling
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.parallel import scanned
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample
from goctr_tpu_torch.parallel.step_cases import sample_arrays
from goctr_tpu_torch.parallel.table_opt import TableOptConfig

CPU = torch.device("cpu")
# 200 rows in batches of 64: 4 steps an epoch, the last one padded
ROWS, BATCH, EPOCHS = 200, 64, 2
STEPS = EPOCHS * -(-ROWS // BATCH)
STAGES = ("batch", "lookup", "fwd_bwd", "solver", "update_front",
          "update_rmw")
CALL_PARTS = ("upload", "resume", "epoch", "return")
NAMES = {"goctr.train"} | {f"goctr.train.{n}" for n in
                           STAGES + CALL_PARTS + ("step", "epoch_sync")}
# each way the trainer writes its table: D 64 holds one row a line, D 16
# grouped lines in `fused` and [V, 128] rows in fused2 and runfused
MODES = {
    "fused_rows": (64, dict(update_mode="fused")),
    "fused_rows_compact": (64, dict(update_mode="fused", compact_cap=256)),
    "fused_rows_kernels": (64, dict(update_mode="fused", compact_cap=256,
                                    compact_impl="kernel",
                                    rmw_impl="kernel")),
    "fused_lines": (16, dict(update_mode="fused")),
    "fused2": (16, dict(update_mode="fused2")),
    "runfused": (16, dict(update_mode="runfused")),
    "dedup": (16, dict(update_mode="dedup")),
    "sorted": (16, dict(update_mode="sorted")),
    "plain": (16, dict(update_mode="plain")),
}


@pytest.fixture
def recording():
    profiling.record(True)
    yield
    profiling.record(False)


def model_kw(dim: int) -> dict:
    return dict(item_vocab=300, emb_dim=dim, u_profile_dim=4, ctx_dim=3,
                behavior_len=5, hidden=(16, 8))


def train(dim: int = 16, change: dict = None):
    kw = model_kw(dim)
    model = SparseCTR(**kw, compute_dtype=torch.bfloat16, device=CPU)
    sample = SparseSample(**sample_arrays(kw, ROWS, seed=3))
    cfg = TrainerConfig(batch_size=BATCH, epochs=EPOCHS, seed=7,
                        shuffle=True)
    topt = TableOptConfig(kind="adagrad", lr=0.05, **(change or {}))
    return scanned.train_sparse_scanned(model, sample, cfg, topt,
                                        device=CPU)


def test_spans_nest_and_an_outermost_span_starts_the_store(recording):
    with profiling.span("a"):
        with profiling.span("b"):
            pass
        with profiling.span("c"):
            with profiling.span("d"):
                pass
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("a", None), ("b", 0), ("c", 0), ("d", 2)]
    assert len({s.call for s in got}) == 1
    for s in got:       # the CPU's device time is the host time
        assert s.device_ms == pytest.approx((s.end_ns - s.start_ns) / 1e6)
        if s.parent is not None:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    with profiling.span("e"):
        pass
    again = profiling.spans()
    assert [(s.name, s.parent) for s in again] == [("e", None)]
    assert again[0].call == got[0].call + 1


def test_spans_are_off_without_a_profiler_or_the_recorder():
    off = profiling.span("x")
    assert off is profiling.span("y")
    before = profiling.spans()
    with off:
        with profiling.span("z"):
            pass
    assert profiling.spans() == before


def test_off_path_touches_no_host_range_and_no_cuda(monkeypatch):
    """With the profiler's host ranges and CUDA events made to raise, a
    trainer call with spans off runs and records nothing."""
    def boom(*a, **k):
        raise AssertionError("touched while off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    before = profiling.spans()
    out = train()
    assert len(out.loss_curve) == EPOCHS
    assert profiling.spans() == before


def test_profiler_records_spans_as_host_ops(tmp_path):
    """Under torch.profiler every span of a trainer call is a `cpu_op`
    (none a `user_annotation`, which a profiler of the card would also
    lay on the device's timeline), and the store's starts lie on the
    profiler's host clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train()
    got = profiling.spans()
    assert {s.name for s in got} == NAMES
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats: dict = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if str(ev.get("name", "")).startswith("goctr."):
            cats.setdefault(ev["name"], set()).add(ev.get("cat"))
    assert set(cats) == NAMES
    assert all(c == {"cpu_op"} for c in cats.values()), cats
    traced: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in NAMES:
            traced.setdefault(ev.name(), []).append(ev.start_ns())
    for name in NAMES:
        mine = [s.start_ns for s in got if s.name == name]
        theirs = sorted(traced[name])
        assert len(mine) == len(theirs)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000


@pytest.mark.parametrize("mode", list(MODES))
def test_recorder_keeps_results(mode):
    dim, change = MODES[mode]
    off = train(dim, change)
    profiling.record(True)
    try:
        on = train(dim, change)
    finally:
        profiling.record(False)
    assert profiling.spans()[0].name == "goctr.train"
    assert on.loss_curve == off.loss_curve
    assert torch.equal(on.table, off.table)
    assert (on.acc is None) == (off.acc is None)
    if on.acc is not None:
        assert torch.equal(on.acc, off.acc)
    for a, b in zip(on.opt_state, off.opt_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_every_step_holds_its_six_stages(recording, mode):
    dim, change = MODES[mode]
    train(dim, change)
    got = profiling.spans()
    assert got[0].name == "goctr.train" and got[0].parent is None
    kids = {}
    for i, s in enumerate(got):
        kids.setdefault(s.parent, []).append(i)
    names = lambda ix: [got[i].name.rsplit(".", 1)[-1] for i in ix]
    assert names(kids[0]) == (["upload", "resume"] + ["epoch"] * EPOCHS
                              + ["return"])
    steps = []
    for e in kids[0][2:2 + EPOCHS]:
        assert names(kids[e]) == ["step"] * (STEPS // EPOCHS) + [
            "epoch_sync"]
        steps += kids[e][:-1]
    assert len(steps) == STEPS
    for st in steps:
        assert tuple(names(kids[st])) == STAGES
    for stage in STAGES:
        assert sum(s.name == f"goctr.train.{stage}" for s in got) == STEPS
