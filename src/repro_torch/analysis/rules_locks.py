"""FL006 — dispatcher lock discipline.

Classes that share mutable state with the FlushDispatcher worker declare
it explicitly::

    class BatchedWriteEngine:
        _fl_guarded = ("state", "_inflight")

Any ``self.<guarded>`` access inside a method must then sit lexically
inside a ``with self._lock():`` / ``with self.dispatcher.lock:`` block.
Two def-line markers opt a whole method out, and double as
documentation of *why* it is safe:

- ``# flashlint: under-lock`` — the method is only ever invoked with the
  lock already held (e.g. worker-side drain bodies submitted via
  ``dispatcher.submit``, which wraps the job in the lock).
- ``# flashlint: quiescent`` — the method begins by waiting out the
  in-flight job (``_barrier``/``wait``), so no worker can race it.

``__init__`` is exempt (no worker exists yet). Nested functions are
scanned as lock-free: a closure capturing ``self`` gives no lexical
evidence it runs under the lock — mark the enclosing method instead.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from .rules_base import Rule, attr_chain

_LOCK_CALL_NAMES = frozenset({"_lock", "lock"})
_MARKERS = ("# flashlint: under-lock", "# flashlint: quiescent")


def _guarded_fields(cls: ast.ClassDef) -> Optional[Tuple[str, ...]]:
    """The class's ``_fl_guarded = ("a", "b")`` declaration, if any."""
    for st in cls.body:
        targets = []
        if isinstance(st, ast.Assign):
            targets = st.targets
            value = st.value
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            targets = [st.target]
            value = st.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "_fl_guarded":
                try:
                    got = ast.literal_eval(value)
                except ValueError:
                    return None
                return tuple(got)
    return None


def _is_lock_ctx(expr: ast.AST) -> bool:
    """Does this ``with``-item expression take the state lock?
    Recognized shapes: ``self._lock()`` / ``self.dispatcher.lock`` /
    ``self._disp.lock`` / anything ending in ``.lock`` or a ``*_lock()``
    call."""
    if isinstance(expr, ast.Call):
        f = expr.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        return name in _LOCK_CALL_NAMES
    chain = attr_chain(expr)
    return bool(chain) and chain.split(".")[-1] in _LOCK_CALL_NAMES


class _LockScan(ast.NodeVisitor):
    def __init__(self, ctx, guarded, method_name):
        self.ctx = ctx
        self.guarded = guarded
        self.method = method_name
        self.locked = 0
        self.out: List = []

    def visit_With(self, node: ast.With) -> None:
        takes = any(_is_lock_ctx(i.context_expr) for i in node.items)
        for i in node.items:
            self.visit(i.context_expr)
            if i.optional_vars is not None:
                self.visit(i.optional_vars)
        self.locked += takes
        for st in node.body:
            self.visit(st)
        self.locked -= takes

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (not self.locked
                and node.attr in self.guarded
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            mode = "written" if isinstance(node.ctx, ast.Store) else "read"
            self.out.append(self.ctx.violation(
                "FL006", node,
                f"self.{node.attr} {mode} outside the state lock in "
                f"'{self.method}' — guarded by _fl_guarded; wrap in "
                "'with self._lock():' or mark the method "
                "'# flashlint: under-lock' / '# flashlint: quiescent'"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        # nested def: no lexical lock evidence crosses the boundary
        saved, self.locked = self.locked, 0
        self.generic_visit(node)
        self.locked = saved

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _check_fl006(ctx) -> List:
    out: List = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = _guarded_fields(cls)
        if not guarded:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            sig = ctx.def_marker_lines(fn)
            if any(m in sig for m in _MARKERS):
                continue
            scan = _LockScan(ctx, frozenset(guarded), fn.name)
            for st in fn.body:
                scan.visit(st)
            out.extend(scan.out)
    return out


FL006 = Rule(
    id="FL006",
    summary="guarded dispatcher state only accessed under the state lock",
    scope="src",
    check=_check_fl006,
)
