"""``PrefixKVCache(backend="sharded")``: the port's refcounts in its
sharded ``FlashStore`` against the reference's, on the CPU.

Both caches run the same request order: pins past the flush threshold
(2 x capacity) drain H_R into the sharded table, the pool of 4 evicts by
the sharded store's heat, and counts come back through the shards'
lookups. Hits, misses, evictions, the resident blocks and every refcount
must be equal. One device each: the reference's JAX CPU device and the
port's ``device="cpu"``, so one shard on both sides."""
import jax
import numpy as np
import torch

from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro_torch.serving import PrefixKVCache

torch.set_num_threads(1)
GEOM = dict(q_log2=10, r_log2=6, block_tokens=2, capacity_blocks=4)


def _order(c):
    """Inserts with a second pin each, releases of every third, prefix
    hits on earlier chains, a flush; the refcounts read at each step."""
    seen = []
    for i in range(12):
        toks = [3 * i + 1, 3 * i + 2, 3 * i + 3, 3 * i + 4]
        keys = c.insert(toks, f"v{i}", slicer=lambda v, n: v)
        n, _value, held = c.acquire(toks)               # a second pin
        seen.append([n, len(held), c._count(held).tolist()])
        if i % 3 == 0:
            c.release(held)
            c.release(keys)
        if i % 4 == 3:
            n, _value, held = c.acquire([1, 2, 3, 4, 5])  # the first chain
            seen.append([n, c._count(held).tolist()])
            c.release(held)
    c._refs.flush()
    keys = sorted(c.store)
    seen.append(keys)
    seen.append(c._count(keys).tolist())
    return seen


def test_sharded_prefix_cache_matches_reference():
    assert jax.device_count() == 1
    ref = RefPrefixKVCache(backend="sharded", **GEOM)
    port = PrefixKVCache(backend="sharded", device="cpu", **GEOM)
    try:
        a, b = _order(ref), _order(port)
        assert a == b
        rs, ps = ref.stats(), port.stats()
        same = ("hits", "misses", "evictions", "resident", "dropped",
                "carried", "write_buffered", "write_cancelled",
                "write_flushes", "write_dispatches", "pool_allocs",
                "pool_frees", "pool_in_use")
        assert {k: rs[k] for k in same} == {k: ps[k] for k in same}
        assert ps["backend"] == "sharded"
        assert ps["evictions"] > 0 and ps["hits"] > 0
        assert ps["write_dispatches"] > 0 and ps["dropped"] == 0
        assert np.asarray(a[-1]).max() > 0
    finally:
        ref._refs.close()
        port.close()
