"""Shared plumbing for flashlint rules: the ``Rule`` record and the AST
helpers every rule leans on (dotted-name chains, import-alias maps)."""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named contract. ``check(ctx) -> list[Violation]`` runs over a
    parsed :class:`~.flashlint.FileContext`; ``scope`` is ``"src"`` for
    contracts about package code only (see the flashlint docstring) or
    ``"all"``."""

    id: str
    summary: str
    scope: str
    check: Callable[[object], List]


def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a ``Name``/``Attribute`` chain (``self.state``,
    ``st.cfg``), or ``None`` when the base is not a plain name
    (calls, subscripts, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def callee_name(call: ast.Call) -> Optional[str]:
    """Trailing identifier of a call's target: ``Foo(...)`` → ``Foo``,
    ``mod.Foo(...)`` → ``Foo``."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def module_aliases(tree: ast.Module, module: str) -> set:
    """Names the module binds to the port module whose last dotted part
    is ``module`` (``tt`` for ``table_torch`` in most of the tree):
    ``from <port package> import <module> [as X]`` and ``import
    repro_torch...<module> as X``. Imports from outside the port
    (``import torch.distributed as dist``) do not count."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            ours = (node.level > 0
                    or (node.module or "").split(".")[0] == "repro_torch")
            for a in node.names:
                if ours and a.name == module:
                    out.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if (parts[0] == "repro_torch" and parts[-1] == module
                        and a.asname):
                    out.add(a.asname)
    return out


def path_endswith(ctx, *suffixes: str) -> bool:
    """True when the file's path ends with any of the given
    ``/``-separated suffixes (``core/store.py``)."""
    p = ctx.path.resolve().as_posix()
    return any(p.endswith(s) for s in suffixes)
