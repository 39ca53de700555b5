# CUDA kernel of causal/non-causal GQA attention, built at first use
# (build.py), beside its plain PyTorch version (ref.py).
from . import kernel, ops, ref  # noqa: F401
