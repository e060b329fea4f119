"""Build and load the native host tier (`native/fnv.c`) with ctypes (port
of goctr_tpu/native/build.py).

The library is compiled at first use by the system C compiler (`cc`,
else `gcc`, else `clang`: -O3 -shared -fPIC -pthread) into
`goctr_tpu_torch/_build/libfnv-<hash>.so`, the port's git-ignored build
directory; the hash covers the source and the flags, so an edited source
is rebuilt and a stale library never loads. Without a C compiler the
wrappers of native/hashing.py take their NumPy/Python paths, as the JAX
package's do. This is host code: no device is involved.

Every exported function gets `argtypes` and `restype`. (The JAX package
leaves `gather_emb_rows` undeclared, so its int64_t sizes go through
ctypes as C ints, the last two on the stack.)
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "fnv.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libfnv-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *CC_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            log.debug("native build with %s failed: %s", cc, e)
            continue
        os.replace(tmp, so)             # atomic: readers never see half
        return so
    return None


def signatures() -> dict[str, list]:
    """The argument types of every function fnv.c exports (each returns
    void)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    return {
        "fnv1_32_batch": [u8p, i64p, i64, u32p],
        "fnv1a_32_batch": [u8p, i64p, i64, u32p],
        "hash_bucket_batch": [u8p, i64p, i64, ctypes.c_int32, i32p],
        "multihot_batch": [u8p, i64p, i64, ctypes.c_uint8, ctypes.c_int32,
                           f32p],
        "gather_rows": [f32p, i64p, i64, i64, f32p, i64, i64],
        "gather_emb_rows": [f32p, i64p, i64, i64, i64, f32p, i64, i64],
    }


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a C compiler
    (a failed build is not tried again in this process)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            log.info("native tier unavailable (no C compiler); "
                     "falling back to NumPy/Python paths")
            return None
        lib = ctypes.CDLL(str(so))
        for name, types in signatures().items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None
