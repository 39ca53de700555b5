"""Structural rules: who may construct engines (FL001), who may spin
threads (FL004), and the deprecated-shim ban (FL005)."""
from __future__ import annotations

import ast
from typing import List

from .rules_base import Rule, callee_name, path_endswith

#: engine/backend classes whose pairing contract (write engine + query
#: engine + dispatcher share one lock and one invalidation channel)
#: only ``core/store.py`` is allowed to assemble.
ENGINE_NAMES = frozenset({
    "BatchedWriteEngine", "BatchedQueryEngine", "FlushDispatcher",
    "SimBackend", "DeviceBackend", "ShardedBackend", "SealedFront",
})

#: modules that hand out threads or executors. ``core/store.py`` owns the
#: one worker pool; the race harness instruments it.
THREADING_MODULES = frozenset({
    "threading", "_thread", "concurrent", "concurrent.futures",
    "multiprocessing",
})

#: names of the shims the facade replaced. A grep matches the bare
#: strings; a parser also catches ``import ... as`` laundering.
SHIM_NAMES = frozenset({"DeviceTableAdapter", "make_device_table"})

#: CorpusStats keyword args from the pre-facade constructor signature.
SHIM_KEYWORDS = frozenset({"engine", "writer"})

_FL001_ALLOWED = ("core/store.py", "core/write_engine.py",
                  "core/query_engine.py")
_FL004_ALLOWED = ("core/store.py", "core/wal.py",
                  "analysis/race_harness.py",
                  # trace-replay feeder workers; other serving files must
                  # stay thread-free
                  "serving/scheduler.py")
# ``checkpoint/checkpoint.py`` (the CheckpointManager's writer thread) is
# deliberately not listed: it keeps its own ``disable=FL004`` on the
# import line, which documents the exception where it is made and which
# the reference package's flashlint (it walks this tree too) honours.


def _check_fl001(ctx) -> List:
    """Engine construction outside the store module.

    ``write_engine.py``/``query_engine.py`` stay allowed for their own
    class definitions and internal helpers (same allowance the original
    ``tests/test_store.py`` walker made)."""
    if path_endswith(ctx, *_FL001_ALLOWED):
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and callee_name(node) in ENGINE_NAMES:
            out.append(ctx.violation(
                "FL001", node,
                f"{callee_name(node)}() constructed outside core/store.py — "
                "engine pairing (shared lock + invalidation) lives only in "
                "the FlashStore backends"))
    return out


def _check_fl004(ctx) -> List:
    if path_endswith(ctx, *_FL004_ALLOWED):
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                root = a.name.split(".")[0]
                if a.name in THREADING_MODULES or root in THREADING_MODULES:
                    out.append(ctx.violation(
                        "FL004", node,
                        f"direct import of '{a.name}' — threads/executors "
                        "belong to core/store.py's FlushDispatcher"))
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            if mod in THREADING_MODULES or mod.split(".")[0] in THREADING_MODULES:
                out.append(ctx.violation(
                    "FL004", node,
                    f"direct import from '{mod}' — threads/executors "
                    "belong to core/store.py's FlushDispatcher"))
    return out


def _check_fl005(ctx) -> List:
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                # a.name is the *original* name — aliasing can't hide it
                if a.name.split(".")[-1] in SHIM_NAMES:
                    out.append(ctx.violation(
                        "FL005", node,
                        f"import of removed shim '{a.name}'"
                        + (f" (aliased as '{a.asname}')" if a.asname else "")
                        + " — use repro_torch.core.store.FlashStore"))
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in SHIM_NAMES:
                out.append(ctx.violation(
                    "FL005", node,
                    f"reference to removed shim '{node.id}' — use "
                    "repro_torch.core.store.FlashStore"))
        elif isinstance(node, ast.Attribute) and node.attr in SHIM_NAMES:
            out.append(ctx.violation(
                "FL005", node,
                f"reference to removed shim '.{node.attr}' — use "
                "repro_torch.core.store.FlashStore"))
        elif isinstance(node, ast.Call) and callee_name(node) == "CorpusStats":
            for kw in node.keywords:
                if kw.arg in SHIM_KEYWORDS:
                    out.append(ctx.violation(
                        "FL005", node,
                        f"CorpusStats({kw.arg}=...) uses the pre-facade "
                        "constructor signature — pass a FlashStore config"))
    return out


FL001 = Rule(
    id="FL001",
    summary="no engine/backend construction outside core/store.py",
    scope="src",
    check=_check_fl001,
)

FL004 = Rule(
    id="FL004",
    summary="no direct threading/executor use outside the store dispatcher",
    scope="src",
    check=_check_fl004,
)

FL005 = Rule(
    id="FL005",
    summary="no deprecated-shim imports or references",
    scope="src",
    check=_check_fl005,
)
