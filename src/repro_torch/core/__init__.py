"""Core: the paper's counting hash table, in PyTorch on the device and as
the event-level numpy simulator on the host (the reference's names)."""
from .flash_model import (CostLedger, FlashDevice, TableGeometry, DEVICES,
                          MLC1, MLC2, SLC)
from .hashing import HashPair, Pow2Hash, hash_pair_for
from .table_sim import (EMPTY, MBTable, MDBTable, MDBLTable, NaiveTable,
                        SCHEMES, make_table)
from .store import FlashStore
from .tfidf import TfIdfPipeline, token_id, tokenize

__all__ = [
    "CostLedger", "FlashDevice", "TableGeometry", "DEVICES", "MLC1", "MLC2",
    "SLC", "HashPair", "Pow2Hash", "hash_pair_for", "EMPTY", "MBTable",
    "MDBTable", "MDBLTable", "NaiveTable", "SCHEMES", "make_table",
    "FlashStore", "TfIdfPipeline", "token_id", "tokenize",
]
