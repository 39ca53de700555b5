"""Serving: paged block pool, flash-hash prefix KV cache, serial engine.
The continuous-batching scheduler and trace replay are not ported yet."""
from .block_pool import BlockPool, NUM_TOKENS_IN_BLOCK  # noqa: F401
from .prefix_cache import PrefixKVCache  # noqa: F401
from .engine import ServeEngine, Request  # noqa: F401
