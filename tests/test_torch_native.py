"""The port's native host tier (goctr_tpu_torch/native/: its own fnv.c,
built into goctr_tpu_torch/_build/) against the JAX package's, and the
checks the port adds before any pointer reaches C.

Every function is run on both of the port's paths: the C library, and
the NumPy/Python path it takes where no C compiler is found (forced here
by making get_lib return None). Both must equal the JAX package's
outputs exactly: the same FNV-1 arithmetic and the same copies.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from goctr_tpu.native import hashing as jh

import goctr_tpu_torch
from goctr_tpu_torch.native import build as tb
from goctr_tpu_torch.native import hashing as th

PKG = Path(goctr_tpu_torch.__file__).resolve().parent
STRINGS = ["", "a", "foobar", "Comedy", "日本語", "Action|Drama",
           "Sci-Fi|War|Action", "drama", "x" * 300]


@pytest.fixture(params=["c", "numpy"])
def path(request, monkeypatch):
    """The port's C path, or its NumPy/Python path."""
    if request.param == "c":
        assert tb.native_available(), "a C compiler is present here"
    else:
        monkeypatch.setattr(th, "get_lib", lambda: None)
    return request.param


def test_library_is_built_from_the_ports_source():
    """The port's own fnv.c, built into the port's build directory (never
    JAX's goctr_tpu/native/_fnv.so)."""
    assert tb.native_available()
    lib = tb.library_path()
    assert lib.exists() and lib.parent == PKG / "_build"
    assert lib.name.startswith("libfnv-")
    assert tb.SRC == PKG / "native" / "fnv.c"
    assert Path(tb.get_lib()._name) == lib


def test_every_exported_function_has_argtypes():
    """Each function fnv.c exports (every non-static definition) has its
    argument types and restype declared: an undeclared int64_t size would
    go through ctypes as a C int."""
    src = tb.SRC.read_text()
    exported = re.findall(r"^void (\w+)\(", src, flags=re.M)
    assert sorted(exported) == sorted(tb.signatures())
    lib = tb.get_lib()
    for name, types in tb.signatures().items():
        fn = getattr(lib, name)
        assert fn.argtypes == types and fn.restype is None, name
    # the int64_t slots of the gathers (fnv.c's gather_rows and
    # gather_emb_rows take every size, stride and column as int64_t)
    assert tb.signatures()["gather_emb_rows"][2:5] == [ctypes.c_int64] * 3
    assert tb.signatures()["gather_emb_rows"][6:] == [ctypes.c_int64] * 2


def test_fnv_batches_equal_jax(path):
    np.testing.assert_array_equal(th.fnv1_32_batch(STRINGS),
                                  jh.fnv1_32_batch(STRINGS))
    np.testing.assert_array_equal(th.fnv1a_32_batch(STRINGS),
                                  jh.fnv1a_32_batch(STRINGS))
    assert th.fnv1_32_batch(STRINGS).dtype == np.uint32


@pytest.mark.parametrize("size", [1, 10, 37, 1 << 20])
def test_hash_bucket_batch_equals_jax(path, size):
    vals = [f"genre{i}" for i in range(500)] + STRINGS
    got = th.hash_bucket_batch(vals, size)
    np.testing.assert_array_equal(got, jh.hash_bucket_batch(vals, size))
    assert got.dtype == np.int32


def test_multihot_batch_equals_jax(path):
    vals = ["Action|Comedy", "drama", "Sci-Fi|War|Action", "", "A|a|B"]
    for size in (10, 50):
        np.testing.assert_array_equal(th.multihot_batch(vals, "|", size),
                                      jh.multihot_batch(vals, "|", size))
    assert th.multihot_batch([], "|", 7).shape == (0, 7)


@pytest.mark.parametrize("n", [3001, (1 << 19) + 17])
def test_gathers_into_equal_jax(path, n):
    """gather_rows_into and gather_emb_rows_into write the same matrix as
    JAX's (negative behavior ids → zeros); at n ≥ 2^19 rows the C pass
    splits over two threads (fnv.c run_split)."""
    rng = np.random.default_rng(n)
    w, L, d = 7, 4, 5
    src = rng.standard_normal((50, w)).astype(np.float32)
    idx = rng.integers(0, 50, n)
    emb = rng.standard_normal((40, d)).astype(np.float32)
    idx2 = rng.integers(-1, 40, (n, L))
    width = w + L * d + 3
    got = np.full((n, width), -9.0, np.float32)
    want = np.full((n, width), -9.0, np.float32)
    for mod, out in ((th, got), (jh, want)):
        mod.gather_rows_into(out, 0, src, idx)
        mod.gather_emb_rows_into(out, w, emb, idx2)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -3:] == -9.0).all()          # columns past the blocks


def test_gather_rows_concat_equals_jax(path, rng):
    a = rng.random((10, 3)).astype(np.float32)
    b = rng.random((7, 2)).astype(np.float64)       # cast to f32 on entry
    ia, ib = rng.integers(0, 10, 9), rng.integers(0, 7, 9)
    got = th.gather_rows_concat([(a, ia), (b, ib)])
    np.testing.assert_array_equal(got, jh.gather_rows_concat(
        [(a, ia), (b, ib)]))
    assert got.dtype == np.float32 and got.shape == (9, 5)
    assert th.gather_rows_concat([]).shape == (0, 0)


@pytest.mark.parametrize("bad", ["fortran", "float64", "1-d", "short",
                                 "col past"])
def test_gather_refuses_an_out_it_cannot_write(path, bad):
    """`out` must be a C-contiguous float32 matrix with one row an index
    and room for the block (JAX's C path writes through any pointer)."""
    src = np.ones((4, 3), np.float32)
    idx = np.arange(5) % 4
    out = {"fortran": np.zeros((5, 8), np.float32, order="F"),
           "float64": np.zeros((5, 8)),
           "1-d": np.zeros(40, np.float32),
           "short": np.zeros((4, 8), np.float32),
           "col past": np.zeros((5, 8), np.float32)}[bad]
    col = 6 if bad == "col past" else 0
    with pytest.raises(ValueError):
        th.gather_rows_into(out, col, src, idx)
    with pytest.raises(ValueError):
        th.gather_emb_rows_into(out, col, src, idx[:, None])
    assert not out.any()


@pytest.mark.parametrize("bad_id", [4, 1000, -1])
def test_gather_refuses_indices_outside_the_source(path, bad_id):
    """Every gather index is held to [0, rows) before the call (the C
    gathers read src[idx] unchecked); a negative behavior id means a zero
    row, so only ids past the table are refused there."""
    src = np.ones((4, 3), np.float32)
    out = np.zeros((3, 6), np.float32)
    with pytest.raises(IndexError, match="outside"):
        th.gather_rows_into(out, 0, src, np.array([0, bad_id, 1]))
    with pytest.raises(IndexError, match="outside"):
        th.gather_rows_concat([(src, np.array([bad_id, 0, 1]))])
    assert not out.any()
    beh = np.array([[0, 1], [bad_id, 2], [3, -1]])
    if bad_id < 0:
        th.gather_emb_rows_into(out, 0, src, beh)
        assert (out[1, :3] == 0).all() and (out[1, 3:] == 1).all()
    else:
        with pytest.raises(IndexError, match="outside"):
            th.gather_emb_rows_into(out, 0, src, beh)
        assert not out.any()


def test_bucket_sizes_and_separators_are_checked(path):
    for size in (0, -3):
        with pytest.raises(ValueError, match="positive"):
            th.hash_bucket_batch(["a"], size)
        with pytest.raises(ValueError, match="positive"):
            th.multihot_batch(["a"], "|", size)
    with pytest.raises(ValueError, match="one ASCII"):
        th.multihot_batch(["a"], "||", 10)
