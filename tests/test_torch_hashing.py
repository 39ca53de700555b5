"""The port's hash pair and Bloom positions against the reference's, bit
for bit, on random int32 keys (negatives and EMPTY included)."""
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th

torch.set_num_threads(1)


def _keys(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64)
    k[:5] = [-1, 0, 1, (1 << 31) - 1, -(1 << 31)]
    return k.astype(np.int32)


@pytest.mark.parametrize("q_log2,r_log2", [(6, 3), (12, 8), (16, 10),
                                           (24, 10), (31, 11)])
def test_pair_matches_reference(q_log2, r_log2):
    k = _keys(seed=q_log2)
    ref = jh.Pow2Hash(q_log2=q_log2, r_log2=r_log2)
    got = th.Pow2Hash(q_log2=q_log2, r_log2=r_log2)
    t = torch.as_tensor(k)
    for fn in ("g", "s", "home_within_block"):
        want = np.asarray(getattr(ref, fn)(k)).astype(np.int64)
        have = getattr(got, fn)(t)
        assert have.dtype == torch.int32, fn
        np.testing.assert_array_equal(have.numpy().astype(np.int64), want,
                                      err_msg=fn)
    for x in (-1, 0, 7, 123456789):
        assert got.g(x) == int(ref.g(x)), x


@pytest.mark.parametrize("bits_log2", [7, 12, 16])
def test_bloom_positions_match_reference(bits_log2):
    k = _keys(seed=bits_log2)
    want = jh.bloom_positions(k, bits_log2)
    have = th.bloom_positions(torch.as_tensor(k), bits_log2)
    for w, h in zip(want, have):
        np.testing.assert_array_equal(h.numpy(), np.asarray(w).astype(np.int64))


def test_filter_words_for_matches_reference():
    for r_log2 in range(0, 14):
        r = 1 << r_log2
        assert th.filter_words_for(r) == jh.filter_words_for(r)
        fw = th.filter_words_for(r)
        assert 1 << th.filter_bits_log2(fw) == fw * 32
