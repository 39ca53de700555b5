"""Two-level hash pairs and Bloom positions.

    g(x) = (x * mult) & (q - 1)     -- primary (entry-level, closed table)
    s(x) = g(x) >> r_log2           -- secondary (block-level)

:class:`Pow2Hash` is the device table's pair, on tensors: the same
power-of-two geometry as the reference package's ``Pow2Hash``. All keys
in secondary slot ``m`` land in the primary range ``[r*m, r*(m+1))``, so
a staged update merges with exactly one block.

:class:`HashPair` is the paper's linear-congruential pair
``g(x) = (a*x + b) mod q``, ``s(x) = g(x) div r`` over any ``q`` and
``r``, and :func:`bloom_positions_np` the Bloom mix in numpy ``uint32``:
both are the event-level simulator's (:mod:`.table_sim`), exact in
numpy as in the reference package.

torch has no unsigned 32-bit shift on the CPU, so the arithmetic is
written in signed types with identical bits:

* ``g`` multiplies in **int32** by the multiplier reinterpreted as int32
  (two's complement wraps exactly like uint32), then masks;
* the Bloom mix runs in **int64**, masked to 32 bits after every
  multiply and before every shift. The multiply may wrap past 2**63;
  only the low 32 bits are kept, and those are exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Knuth multiplicative constants (odd, fit uint32).
_DEFAULT_A = 2_654_435_761
_DEFAULT_B = 1_013_904_223
_U32 = 0xFFFFFFFF


def _as_i32(u: int) -> int:
    """A uint32 constant reinterpreted as a signed int32 Python int."""
    u &= _U32
    return u - (1 << 32) if u >= (1 << 31) else u


def bloom_positions(x: torch.Tensor, bits_log2: int):
    """k=2 Bloom bit positions in ``[0, 2**bits_log2)`` for keys ``x``.

    One murmur3-finalizer mix, then both positions sliced from disjoint
    bit ranges of the mixed word. Requires ``bits_log2 <= 16``. Returns a
    tuple of two int64 tensors shaped like ``x``."""
    h = x.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    h = h ^ (h >> 16)
    m = (1 << bits_log2) - 1
    return h & m, (h >> bits_log2) & m


def bloom_positions_np(x: np.ndarray, bits_log2: int):
    """:func:`bloom_positions` on a numpy array, in ``uint32`` arithmetic
    (multiplies wrap mod 2**32, as the reference's do): the sim's blocked
    Bloom filter. Returns a tuple of two ``uint32`` arrays shaped like
    ``x``."""
    h = np.asarray(x).astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    m = np.uint32((1 << bits_log2) - 1)
    return h & m, (h >> np.uint32(bits_log2)) & m


def filter_words_for(block_entries: int) -> int:
    """32-bit lanes per block-filter row: smallest power of two giving
    >=4 bits per entry of block capacity, capped at 2**16 bits."""
    words = 4
    while words * 32 < block_entries * 4 and words < 2048:
        words *= 2
    return words


def filter_bits_log2(fw: int) -> int:
    """log2 of a filter row's bit count (``fw`` 32-bit words)."""
    return (fw * 32).bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Pow2Hash:
    """(g, s) pair with power-of-two table geometry."""

    q_log2: int  # log2(total entries)
    r_log2: int  # log2(entries per block)
    mult: int = _DEFAULT_A  # odd multiplier

    def __post_init__(self):
        if self.r_log2 > self.q_log2:
            raise ValueError("r must not exceed q")
        if self.mult % 2 == 0:
            raise ValueError("multiplier must be odd")

    @property
    def q(self) -> int:
        return 1 << self.q_log2

    @property
    def r(self) -> int:
        return 1 << self.r_log2

    @property
    def num_slots(self) -> int:
        return 1 << (self.q_log2 - self.r_log2)

    def g(self, x):
        """x: integer tensor or Python int -> int32 in ``[0, q)``."""
        if isinstance(x, int):
            return ((x * self.mult) & _U32) & (self.q - 1)
        u = x.to(torch.int32) * _as_i32(self.mult)
        return u & _as_i32(self.q - 1)

    def s(self, x):
        return self.g(x) >> self.r_log2

    def home_within_block(self, x):
        return self.g(x) & (self.r - 1)


@dataclasses.dataclass(frozen=True)
class HashPair:
    """The paper's (g, s) pair. ``q`` = total entries, ``r`` = entries per
    block; any ``q`` that ``r`` divides."""

    q: int  # number of entries in the primary (closed) table
    r: int  # entries per block == primary entries per secondary slot
    a: int = _DEFAULT_A
    b: int = _DEFAULT_B

    def __post_init__(self):
        if self.q % self.r != 0:
            raise ValueError(f"q={self.q} must be a multiple of r={self.r}")
        if self.q <= 0 or self.r <= 0:
            raise ValueError("q and r must be positive")

    @property
    def num_slots(self) -> int:
        """Secondary-table slot count (== number of primary blocks)."""
        return self.q // self.r

    # Inputs: Python ints or numpy int64 arrays with x < 2**31, so that
    # a*x + b < 2**63 stays exact in int64.
    def g(self, x):
        return (self.a * x + self.b) % self.q

    def s(self, x):
        return self.g(x) // self.r

    def block_of(self, x):
        """The block a key belongs to (== s(x))."""
        return self.s(x)

    def home_within_block(self, x):
        """Entry offset of the key's home position inside its block."""
        return self.g(x) % self.r


def hash_pair_for(num_blocks: int, block_entries: int, a: int = _DEFAULT_A,
                  b: int = _DEFAULT_B) -> HashPair:
    return HashPair(q=num_blocks * block_entries, r=block_entries, a=a, b=b)
