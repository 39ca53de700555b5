"""Serving: paged block pool, flash-hash prefix KV cache, the serial
engine, the continuous-batching scheduler and trace replay."""
from .block_pool import BlockPool, NUM_TOKENS_IN_BLOCK  # noqa: F401
from .prefix_cache import PrefixKVCache  # noqa: F401
from .engine import ServeEngine, Request  # noqa: F401
from .scheduler import (ContinuousBatchingScheduler, SchedRequest,  # noqa: F401
                        TraceReport, replay_trace)
from .trace import TraceItem, make_trace  # noqa: F401
