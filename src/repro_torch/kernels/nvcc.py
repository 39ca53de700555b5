"""Build and load a CUDA source of the port as a shared library.

Each kernel family (``flash_hash``, ``flash_attn``) keeps one ``.cu``
file with a plain C interface under its ``csrc/`` (with any headers it
includes beside it) and describes it with a :class:`CudaLibrary`. At
first use the source is compiled with ``nvcc`` for Hopper (``sm_90a``)
and loaded with ``ctypes``. The library lands in the family's ``_build/``
(listed in ``.gitignore``), named by a hash of every file under ``csrc/``
and the flags, so a changed source or header rebuilds and an unchanged
one loads at once; ``ptxas``'s report of each kernel's registers and
shared memory is kept beside it. Nothing is compiled when a module is
imported. :func:`build_all` starts one ``nvcc`` per library at once;
:func:`ptxas_report` and :func:`sass_counts` read what was built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One ``.cu`` source, its C entry points and its build directory.

    ``signatures`` maps each entry point to its ``ctypes`` argument types
    (every pointer and the stream as ``c_void_p``); each returns
    ``cudaGetLastError()`` as an ``int``."""

    def __init__(self, name: str, source: Path,
                 signatures: Dict[str, List]):
        self.name = name
        self.source = Path(source)
        self.build_dir = self.source.parent.parent / "_build"
        self.signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        #: what the compile printed (the ``-Xptxas -v`` report), how long
        #: this process spent building, and where the library is
        self.last_build = {"log": "", "seconds": 0.0, "path": ""}

    def _start(self):
        """Start ``nvcc`` unless a library for this source and these flags
        already exists; returns what :meth:`_finish` needs."""
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        for f in sorted(p for p in self.source.parent.rglob("*")
                        if p.is_file()):
            digest.update(f.relative_to(self.source.parent).as_posix()
                          .encode() + b"\0" + f.read_bytes())
        tag = digest.hexdigest()[:16]
        out = self.build_dir / f"lib{self.name}_{tag}.so"
        if out.exists():
            return out, None, None, 0.0
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        proc = subprocess.Popen([nvcc_path(), *FLAGS, "-o", tmp,
                                 str(self.source)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return out, proc, tmp, time.perf_counter()

    def _finish(self, job) -> Path:
        out, proc, tmp, t0 = job
        log = out.with_suffix(".log")
        if proc is None:
            self.last_build.update(
                log=log.read_text() if log.exists() else "", seconds=0.0,
                path=str(out))
            return out
        text, _ = proc.communicate()
        self.last_build.update(log=text, seconds=time.perf_counter() - t0,
                               path=str(out))
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{text}")
        log.write_text(text)
        os.replace(tmp, out)
        return out

    def build(self) -> Path:
        """Compile unless a library for this source and these flags
        already exists; returns its path."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        """The loaded library (built at first call)."""
        if self._lib is None:
            built = self.last_build["path"]     # built by this process
            lib = ctypes.CDLL(built if built and os.path.exists(built)
                              else str(self.build()))
            for fn_name, args in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every library at once (one ``nvcc`` process each, started
    together), then load them."""
    jobs = [lib._start() for lib in libraries]
    try:
        for lib, job in zip(libraries, jobs):
            lib._finish(job)
    finally:   # a failed build stops the others' compilers too
        for _, proc, _, _ in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    for lib in libraries:
        lib.load()


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel from ``nvcc -Xptxas -v``
    output, by mangled name."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if v}


#: SASS instructions counted by :func:`sass_counts`: tensor-core MMAs, TMA
#: tensor loads, 1-D bulk copies, barrier operations, and loads from device
#: memory
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS", "LDG")


def sass_counts(library: Path) -> Dict[str, Dict[str, int]]:
    """Static count of each of :data:`SASS_OPS` in each kernel of a built
    library (``cuobjdump -sass``), by mangled name."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            counts = out.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if counts is not None and m and m.group(1) in counts:
            counts[m.group(1)] += 1
    return out
