"""flashlint fixture: FL001 — engine construction outside core/store.py.

Deliberately violating file; the recursive walk skips ``lint_fixtures``
directories, so only the flashlint tests ever lint this."""
from repro_torch.core.query_engine import BatchedQueryEngine
from repro_torch.core.write_engine import BatchedWriteEngine


def hand_wired_pair(cfg):
    qe = BatchedQueryEngine(cfg)
    return BatchedWriteEngine(cfg, query_engine=qe, device="cpu"), qe
