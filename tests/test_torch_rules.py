"""Rules of the port: goctr_tpu_torch imports neither JAX nor the JAX
package, and kernels are built from the package's own CUDA sources.

The import rule is read from the source (an AST scan of every module):
a check of sys.modules would pass vacuously in a process where the tests
themselves have imported both packages.
"""
import ast
from pathlib import Path

import pytest

import goctr_tpu_torch
from goctr_tpu_torch.ops.kernels import _build

PKG = Path(goctr_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "goctr_tpu", "flax", "optax")


def _imports(src: str) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _py_files():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15, files
    return files


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(
    p.relative_to(PKG)))
def test_module_imports_no_jax(path):
    bad = [n for n in _imports(path.read_text())
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_imports_no_jax():
    bad = [n for n in _imports((PKG.parent / "chip_smoke.py").read_text())
           if n.split(".")[0] in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("script", ["parity_ml20m_torch.py",
                                    "din_pool_sweep.py",
                                    "gather_run_sweep.py"])
def test_port_script_imports_no_jax(script):
    """The scripts that drive the port on the card import neither."""
    path = PKG.parent / "scripts" / script
    bad = [n for n in _imports(path.read_text())
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_imports():
    """The scan must catch every import form, nested ones included."""
    src = ("import os\nfrom a.b import c\n"
           "def f():\n    import jax.numpy as jnp\n")
    assert _imports(src) == ["os", "a.b", "jax.numpy"]


def test_every_kernel_source_is_built_for_sm90a():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == ["compact_runsums", "csum_rmw", "din_attention",
                       "din_attention_bwd", "gather_pool", "row_gather",
                       "row_rmw", "row_scatter", "run_rmw"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in sources:
        lib = _build.library_path(name)
        assert lib.parent == PKG / "_build" and name in lib.name
        # each source names the TPU kernel it replaces, its bound on the
        # card, its design and its plain version
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "goctr_tpu/ops/pallas/" in text
        for part in ("What bounds it on the H100", "Design:",
                     "Plain version"):
            assert part in text, (name, part)


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """A source that includes a csrc/ header is rebuilt when the header
    changes: the library's hash covers the headers too."""
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("run_rmw")
    header = tmp_path / "line_update.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path("run_rmw") != before
