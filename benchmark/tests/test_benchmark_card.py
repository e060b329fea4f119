"""On the card, at a cell's own size: the program passes its cell's limits
and the float8 control fails them (run with `python -m pytest
benchmark/tests -m cuda`; skips without a card)."""
import pytest
import torch

from benchmark import check, registry
from benchmark.control import readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v10m_d64.zipf_t32_b65k"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = registry.Bench()
    limits = bench.cell(cell).limits
    rows = readings(bench, cell, [1, 2, 3], [1, 2, 3],
                    torch.device("cuda", 0), out=lambda s: None)
    for r in rows:
        ok, checks = check.judge(r, limits)
        assert ok == (r["kind"] == "program"), (r["kind"], checks)
