"""Optimizer of the port: AdamW, its LR schedule, int8 gradient
compression."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
from .compress import (CompressionState, compress_init,  # noqa: F401
                       compressed_psum)
