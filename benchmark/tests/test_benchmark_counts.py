"""The benchmark's frozen counts against the port's own today."""
import json
from pathlib import Path

import pytest

from benchmark.families import sparse_din
from goctr_tpu_torch.parallel.scanned import model_flops_per_example
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name,t", [("sparse_din_v10m_d64", 32),
                                    ("sparse_din_v10m_d64", 256),
                                    ("sparse_din_v100m_d16_lines", 32)])
def test_flops_per_example_equals_the_port(name, t):
    m = json.loads((CONFIGS / f"{name}.json").read_text())["model"]
    model = SparseCTR(item_vocab=8, emb_dim=m["emb_dim"],
                      u_profile_dim=m["u_profile_dim"], ctx_dim=m["ctx_dim"],
                      behavior_len=t, hidden=tuple(m["hidden"]),
                      device="cpu")
    assert sparse_din.example_flops(m, t) == model_flops_per_example(model, t)
    assert sparse_din.dense_params(m, t) == sum(
        p.numel() for p in model.param_leaves())


def test_pool_bytes_match_the_kernel_bound():
    # K2 + K2b bound at the headline's step (B 65,536, T 32, D 64, bf16):
    # 0.08764 + 0.17028 ms at 3.35 TB/s
    m = json.loads((CONFIGS / "sparse_din_v10m_d64.json").read_text())["model"]
    ms = sparse_din.pool_needed_bytes(m, 32, 65536) / 3.35e12 * 1e3
    assert abs(ms - (0.08764 + 0.17028)) < 1e-4
