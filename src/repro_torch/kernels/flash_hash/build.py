"""The flash-hash CUDA kernels (``csrc/flash_hash.cu``) as a library.

Compiled at first use into ``_build/`` beside this file and loaded with
``ctypes`` by :class:`~repro_torch.kernels.nvcc.CudaLibrary`; the source
includes ``csrc/bulk_copy.cuh``, which the build's hash covers.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint

#: the merge's and the query's entry points each share one signature
#: with their baseline's (the in-place merge adds its scratch, the
#: cluster merge its plan)
_MERGE = [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _U, _P]
_QUERY = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _P]

LIBRARY = CudaLibrary(
    "flash_hash", Path(__file__).resolve().parent / "csrc" / "flash_hash.cu",
    {"fh_merge_dirty": _MERGE, "fh_merge_dirty_serial": _MERGE,
     "fh_merge_dirty_in_place": _MERGE[:-1] + [_P, _P],
     "fh_merge_dirty_cluster": _MERGE[:-1] + [_I, _I, _P],
     "fh_merge_cluster_capacity": [_I, _I],
     "fh_merge_scratch_words": [_I],
     "fh_query_grid": _QUERY, "fh_query_grid_staged": _QUERY,
     "fh_filter_probe_grid": [_P, _P, _P, _P, _I, _I, _I, _P]})
build = LIBRARY.build
load = LIBRARY.load
last_build = LIBRARY.last_build
