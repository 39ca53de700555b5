"""SSD cost model (numpy only; the reference package keeps the same
model) — replacement for the paper's DiskSim(+SSD extension) slave.

Accounts the same quantities the paper reports: page/block reads & writes,
cleans (erases), merges, stages, and converts counters into device time via
the paper's Table-1 configurations (MLC-1, MLC-2, SLC).

Block-vs-page cost ratios come from the paper's footnote 4:
  "MLC-1 is on the order of 30 and 50 times more expensive for block level
   reads and block level writes, MLC-2 is over 25 and 35, and SLC is over
   24 and 28 respectively."
Erase (clean) latency is not given in the paper; we use literature values
(NAND block erase ≈ 1.5–2 ms).

The FTL model for *random* page writes (naive, bufferless table): a log-
structured FTL garbage-collects one block per ``pages_per_block`` random page
writes; each clean also incurs a block read + block write for valid-page
copy-out. This reproduces the paper's §3.5 naive-table magnitudes
(~1 clean / 81 random writes measured there; ours gives 1/128 before
valid-copy accounting — same order).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlashDevice:
    """Latency model of one SSD configuration (paper Table 1 + footnote 4)."""

    name: str
    page_read_us: float
    page_write_us: float
    block_read_mult: float   # block read  = mult * page_read
    block_write_mult: float  # block write = mult * page_write
    erase_us: float
    capacity_gb: int
    cell: str  # "MLC" | "SLC"

    @property
    def block_read_us(self) -> float:
        return self.block_read_mult * self.page_read_us

    @property
    def block_write_us(self) -> float:
        return self.block_write_mult * self.page_write_us


MLC1 = FlashDevice("MLC-1", page_read_us=65.0, page_write_us=110.0,
                   block_read_mult=30.0, block_write_mult=50.0,
                   erase_us=2000.0, capacity_gb=40, cell="MLC")
MLC2 = FlashDevice("MLC-2", page_read_us=65.0, page_write_us=85.0,
                   block_read_mult=25.0, block_write_mult=35.0,
                   erase_us=2000.0, capacity_gb=80, cell="MLC")
SLC = FlashDevice("SLC", page_read_us=75.0, page_write_us=85.0,
                  block_read_mult=24.0, block_write_mult=28.0,
                  erase_us=1500.0, capacity_gb=32, cell="SLC")

DEVICES = {d.name: d for d in (MLC1, MLC2, SLC)}


@dataclasses.dataclass(frozen=True)
class TableGeometry:
    """Physical layout of the drive-resident (closed) hash table."""

    num_blocks: int
    pages_per_block: int = 128
    entries_per_page: int = 512  # 4KB page / 8B (key,count) pair

    @property
    def block_entries(self) -> int:
        return self.pages_per_block * self.entries_per_page

    @property
    def total_entries(self) -> int:
        return self.num_blocks * self.block_entries

    @property
    def total_pages(self) -> int:
        return self.num_blocks * self.pages_per_block

    def page_of_entry(self, entry_offset_in_block: int) -> int:
        return entry_offset_in_block // self.entries_per_page


@dataclasses.dataclass
class CostLedger:
    """Device-independent operation counters (the paper's Table-2 columns)."""

    page_reads: int = 0
    page_writes_seq: int = 0       # sequential (MDB-L log appends)
    page_writes_semi: int = 0      # semi-random (MDB change-segment stages)
    page_writes_rand: int = 0      # random (naive table)
    block_reads: int = 0
    block_writes: int = 0
    cleans: int = 0
    merges: int = 0
    stages: int = 0
    # FTL state for random-write garbage collection:
    _ftl_dirty: int = 0
    _pages_per_block: int = 128

    # ---- paper Table-2 aggregates ------------------------------------
    @property
    def block_ops(self) -> int:
        return self.block_reads + self.block_writes

    @property
    def page_ops(self) -> int:
        return (self.page_reads + self.page_writes_seq +
                self.page_writes_semi + self.page_writes_rand)

    @property
    def page_writes(self) -> int:
        return self.page_writes_seq + self.page_writes_semi + self.page_writes_rand

    def block_op_fraction(self) -> float:
        tot = self.block_ops + self.page_ops
        return self.block_ops / tot if tot else 0.0

    # ---- op recording --------------------------------------------------
    def read_page(self, n: int = 1):
        self.page_reads += n

    def write_page_seq(self, n: int = 1):
        self.page_writes_seq += n

    def write_page_semi(self, n: int = 1):
        self.page_writes_semi += n

    def write_page_random(self, n: int = 1):
        """Random page writes go through the FTL GC model (see module doc)."""
        self.page_writes_rand += n
        self._ftl_dirty += n
        while self._ftl_dirty >= self._pages_per_block:
            self._ftl_dirty -= self._pages_per_block
            self.cleans += 1
            self.block_reads += 1   # valid-page copy-out
            self.block_writes += 1

    def read_block(self, n: int = 1):
        self.block_reads += n

    def write_block(self, n: int = 1, clean: bool = True):
        self.block_writes += n
        if clean:  # erase-before-write
            self.cleans += n

    def erase_block(self, n: int = 1):
        self.cleans += n

    def merge_event(self, n: int = 1):
        self.merges += n

    def stage_event(self, n: int = 1):
        self.stages += n

    # ---- time conversion -------------------------------------------------
    def time_us(self, dev: FlashDevice) -> float:
        return (self.page_reads * dev.page_read_us
                + self.page_writes * dev.page_write_us
                + self.block_reads * dev.block_read_us
                + self.block_writes * dev.block_write_us
                + self.cleans * dev.erase_us)

    def snapshot(self) -> dict:
        return {
            "page_reads": self.page_reads,
            "page_writes_seq": self.page_writes_seq,
            "page_writes_semi": self.page_writes_semi,
            "page_writes_rand": self.page_writes_rand,
            "block_reads": self.block_reads,
            "block_writes": self.block_writes,
            "block_ops": self.block_ops,
            "page_ops": self.page_ops,
            "cleans": self.cleans,
            "merges": self.merges,
            "stages": self.stages,
        }

    def diff(self, before: dict) -> dict:
        now = self.snapshot()
        return {k: now[k] - before.get(k, 0) for k in now}
