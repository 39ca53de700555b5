# CUDA kernels of the counting table, built at first use (build.py).
from . import kernel, ops, ref  # noqa: F401
