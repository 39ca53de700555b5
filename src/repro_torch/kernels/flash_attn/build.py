"""The flash-attention CUDA kernels (``csrc/flash_attn.cu``, with the
Hopper helpers of ``csrc/hopper.cuh``) as a library.

Compiled at first use into ``_build/`` beside this file and loaded with
``ctypes`` by :class:`~repro_torch.kernels.nvcc.CudaLibrary`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int

LIBRARY = CudaLibrary(
    "flash_attn", Path(__file__).resolve().parent / "csrc" / "flash_attn.cu",
    {"fa_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                    _I, _I, _P],
     "fa_forward_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _I, _P]})
build = LIBRARY.build
load = LIBRARY.load
last_build = LIBRARY.last_build
