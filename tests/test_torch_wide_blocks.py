"""The port's device ``FlashStore`` (on the CPU) against the reference's
at block widths the card's staged merge does not take: the paper's flash
block (128 pages of 512 entries: 65,536 slots, ``r_log2=16``) for all
three schemes, and blocks of 1 and 4 slots. One stream of updates (with
negative deltas), lookups and a flush mid-way: the same answers, the
same ``wear()``, the same ``stats()`` and the same table state, with
drains inline (``async_flush=False``)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.store import FlashStore as JStore
from repro_torch import convert
from repro_torch.core.store import FlashStore as TStore

torch.set_num_threads(1)

ENGINE = dict(chunk=64, flush_threshold=96, query_chunk=64, hot_capacity=64)
#: name: (q_log2, r_log2, scheme)
CASES = {
    "paper_block_MB": (17, 16, "MB"),
    "paper_block_MDB": (17, 16, "MDB"),
    "paper_block_MDB-L": (17, 16, "MDB-L"),
    "r1_MDB-L": (8, 0, "MDB-L"),
    "r4_MDB": (10, 2, "MDB"),
    "r4_MB": (10, 2, "MB"),
}


def _stream(seed, n_keys):
    """Updates over ``n_keys`` ids (a quarter of the table's slots at
    most, so that nothing is dropped), lookups that miss a sixth of the
    time."""
    rng = np.random.default_rng(seed)
    for i in range(16):
        yield "update", rng.integers(0, n_keys, 160), None
        if i % 4 == 1:
            keys = rng.integers(0, n_keys, 40)
            yield "update", keys, rng.integers(-1, 3, 40)
        if i % 3 == 2:
            yield "query", rng.integers(0, n_keys * 7 // 6, 80), None
        if i == 8:
            yield "flush", None, None


@pytest.mark.parametrize("case", list(CASES))
def test_wide_and_narrow_blocks_match_reference_store(case):
    q_log2, r_log2, scheme = CASES[case]
    # drains inline, so that every counter is the stream's alone
    kw = dict(scheme=scheme, track_wear=True, async_flush=False,
              q_log2=q_log2, r_log2=r_log2,
              log_capacity=256, max_updates_per_block=16,
              cs_partitions=min(4, 1 << (q_log2 - r_log2)),
              overflow_capacity=256, **ENGINE)
    js = JStore.open(backend="device", **kw)
    ts = TStore.open(backend="device", device="cpu", **kw)
    truth = {}
    n_keys = min(3000, (1 << q_log2) // 4)
    for op, a, b in _stream(q_log2 + r_log2, n_keys):
        if op == "update":
            js.update(a, b)
            ts.update(a, b)
            for k, d in zip(a.tolist(),
                            [1] * len(a) if b is None else b.tolist()):
                truth[k] = truth.get(k, 0) + d
        elif op == "query":
            want = js.query_batch(a)
            np.testing.assert_array_equal(ts.query_batch(a), want)
            np.testing.assert_array_equal(
                want, [truth.get(k, 0) for k in a.tolist()])
        else:
            js.flush()
            ts.flush()
    js.flush()
    ts.flush()
    keys = np.arange(-1, n_keys * 7 // 6)
    np.testing.assert_array_equal(ts.query(keys), js.query(keys))
    assert ts.wear() == js.wear()
    assert ts.wear()["dropped"] == 0
    skip = {"write_overlap_us", "write_stall_us"}   # wall-clock ledgers
    assert ({k: v for k, v in ts.stats().items() if k not in skip}
            == {k: v for k, v in js.stats().items() if k not in skip})
    got = convert.state_to_numpy(ts.state)
    want = jax.tree.map(np.asarray, js.state)
    for f in ("keys", "counts", "log_keys", "ov_keys", "filter_words"):
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    js.close()
    ts.close()
