"""Core: the paper's counting hash table on the device, in PyTorch."""
from .hashing import Pow2Hash
from .store import EMPTY, FlashStore
from .tfidf import TfIdfPipeline, token_id, tokenize

__all__ = ["Pow2Hash", "EMPTY", "FlashStore", "TfIdfPipeline", "token_id",
           "tokenize"]
