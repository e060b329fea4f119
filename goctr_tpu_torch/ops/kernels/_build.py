"""Build and load the hand-written CUDA kernels (`goctr_tpu_torch/csrc/`).

Each `csrc/<name>.cu` is compiled at first use by `nvcc` for sm_90a into a
shared library with a plain C interface under `goctr_tpu_torch/_build/`
(git-ignored), and loaded with ctypes. No PyTorch headers are included,
so a build takes seconds, not minutes. The library's name carries a hash
of its source, the headers of csrc/ and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.

Conventions of every C entry point: pointers and the CUDA stream are
`void*` (ctypes.c_void_p — a c_int would cut a 64-bit pointer), sizes
are `long long` or `int`, and the function returns `cudaGetLastError()`
right after its launch; `<name>_error_string(code)` names the error. The
wrappers raise on any nonzero code: a launch that is refused never runs,
and a later synchronize would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "goctr_tpu_torch cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to: the hash covers the source, every
    header of csrc/ (a source may include one) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources that have no current library, one nvcc
    process per source, all started together. Raises with nvcc's output
    if any build fails; keeps ptxas's report of each kernel's registers,
    shared memory and spills beside the library (`resources`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        out[name].with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out[name])          # atomic: readers never see half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def resources(name: str) -> list[str]:
    """ptxas's report for csrc/<name>.cu's current library, one line a
    kernel: its (mangled) name, registers, shared memory and spills; empty
    when the library was built before the report was kept."""
    path = library_path(name).with_suffix(".ptxas.txt")
    if not path.exists():
        return []
    lines, entry, spills = [], None, ""
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spills = m[1], ""
        elif "spill stores" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            lines.append(f"{entry}: {line.split('Used', 1)[1].strip()}; "
                         f"{spills}")
            entry = None
    return lines


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use, with the
    given argument types set on its entry points (each returns an int
    CUDA error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            for fn_name, types in argtypes.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
