"""Build and load the flash-hash CUDA kernels (``csrc/flash_hash.cu``).

At first use the source is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``. The library lands in ``_build/`` beside this file (listed
in ``.gitignore``), named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads at once; ``ptxas``'s
report of each kernel's registers and shared memory is kept beside it.
Nothing is compiled when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "flash_hash.cu"
BUILD_DIR = HERE / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
#: C signatures of the entry points (every pointer and the stream as
#: ``c_void_p``; each returns ``cudaGetLastError()``)
SIGNATURES = {
    "fh_merge_dirty": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _U, _P],
    "fh_query_grid": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _P],
    "fh_filter_probe_grid": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the library's compile printed (the ``-Xptxas -v`` register and
#: shared-memory report), how long this process spent building, and where
#: the library is
last_build = {"log": "", "seconds": 0.0, "path": ""}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash-hash CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels unless a library for this source and these
    flags already exists; returns its path."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libflash_hash_{tag}.so"
    log = out.with_suffix(".log")
    if out.exists():
        last_build.update(log=log.read_text() if log.exists() else "",
                          seconds=0.0, path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    last_build.update(log=proc.stdout + proc.stderr,
                      seconds=time.perf_counter() - t0, path=str(out))
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(last_build["log"])
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
