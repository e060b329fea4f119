"""The sparse_din family's traffic generator keeps the law of the JAX
bench's draw (goctr_tpu_torch/bench.py make_workload) on the same sizes."""
import numpy as np
import pytest
import torch

from benchmark.families import sparse_din
from goctr_tpu_torch import bench as port_bench

N, VOCAB, T, U, C, BATCH = 16384, 1_000_000, 32, 8, 4, 4096


def law(ids):
    return {"rows": N, "batch": BATCH, "t": T, "ids": ids, "zipf_s": 1.05,
            "rows_per_user": 256, "p_taste": 0.85, "noisy": True,
            "p_rule": 0.85, "hot_share": 0.1, "hot_bonus": 0.1,
            "cold_malus": 0.01, "p_clip": [0.02, 0.98]}


def numpy_stats(zipf: bool, seed: int):
    sample, uids, _ = port_bench.make_workload(N, VOCAB, T, U, C, seed=seed,
                                               zipf=zipf, noisy=True)
    rng = np.random.default_rng(seed)        # make_workload's first draws
    rng.integers(0, max(N // 256, 1), N)
    taste = rng.integers(0, 2, max(N // 256, 1))[uids]
    ids = np.concatenate([sample.behavior_ids[:BATCH].ravel(),
                          sample.item_ids[:BATCH]])
    return (len(np.unique(ids)) / ids.size, float(sample.labels.mean()),
            float(((sample.behavior_ids % 2) == taste[:, None]).mean()))


def torch_stats(ids: str, seed: int):
    d = sparse_din.draw_log(law(ids), VOCAB, U, C, seed, "cpu")
    share = sparse_din.unique_share(d, BATCH, batches=1)
    taste = ((d.behavior_ids % 2) == d.taste[:, None]).float().mean()
    return share, float(d.labels.mean()), float(taste)


@pytest.mark.parametrize("ids", ["zipf", "uniform"])
def test_draw_law_matches_bench(ids):
    want = numpy_stats(ids == "zipf", seed=0)
    got = torch_stats(ids, seed=0)
    # distinct-id share a batch within 0.02, label rate and taste share
    # within 0.015 (sampling spread at N = 16,384 is ~0.004)
    assert abs(got[0] - want[0]) < 0.02, (got, want)
    assert abs(got[1] - want[1]) < 0.015, (got, want)
    assert abs(got[2] - want[2]) < 0.015, (got, want)


def test_same_seed_same_rows_and_large_seeds():
    a = sparse_din.draw_log(law("zipf"), VOCAB, U, C, 2**31 + 5, "cpu")
    b = sparse_din.draw_log(law("zipf"), VOCAB, U, C, 2**31 + 5, "cpu")
    c = sparse_din.draw_log(law("zipf"), VOCAB, U, C, 2**31 + 6, "cpu")
    assert torch.equal(a.behavior_ids, b.behavior_ids)
    assert torch.equal(a.labels, b.labels)
    assert not torch.equal(a.behavior_ids, c.behavior_ids)
    assert int(a.behavior_ids.min()) >= 0
    assert int(a.behavior_ids.max()) < VOCAB


def test_compact_cap_is_the_bench_rule():
    d = sparse_din.draw_log(law("zipf"), VOCAB, U, C, 3, "cpu")
    host = d.host()
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

    assert sparse_din.compact_cap(d, BATCH) == port_bench.bench_compact_cap(
        SparseSample(**host), BATCH)
