"""Dataflow rules.

FL002 — use after consumption. The port's table entry points update a
``DeviceTableState`` in place: ``table_torch.update`` / ``flush`` (and
the sharded ``distributed.update`` / ``flush`` over a list of shard
states) rewrite the argument's tensors and return its successor, marking
the argument consumed (``table_torch._consume``). Any later read of the
same binding sees tensors that already hold the successor's contents (at
best a ``RuntimeError`` from ``segments.assert_live``, at worst counts
that silently describe another state). The rule runs a linear,
statement-ordered scan of each function body: a name (or dotted
``self.x`` chain) passed in a consumed position becomes *spent*; reading
a spent binding — or any deeper attribute of it — flags, until an
assignment rebinds it.

Consuming calls are the port modules' entry points, resolved through
the names a file binds to them (``tt.update``, ``D.flush``).

The scan is deliberately shallow: only plain ``Name``/``Attribute``
chains are tracked (a consumed *expression* like ``f(state)`` has no
binding to poison), and branches merge conservatively (spent in either
arm ⇒ spent after).

FL003 — flush→invalidate. Every function that rebinds a ``.state``
attribute (the consumed table state living on an engine/backend) must
also invalidate the paired query engine, or stale cached counts survive
the swap. ``__init__`` (first bind, nothing cached yet) is exempt.

FL003 additionally guards the Bloom-filter contract: a
``DeviceTableState(...)`` rebuild that lists fields by keyword but drops
``filter_words`` silently zombifies the filter (the no-false-negatives
invariant dies at the next probe), and a device ``merge``/``merge_dirty``
call that passes table arrays but no filter argument skips the in-kernel
maintenance that keeps merged keys covered. Both are flagged at the call
site.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .rules_base import Rule, attr_chain, module_aliases

#: port modules whose entry points consume a state argument in place,
#: by the module's last dotted name: entry point → consumed positions
#: (``table_torch``: the state after ``cfg``; ``distributed``: the shard
#: states after ``cfg`` and the group).
_CONSUMING = {
    "table_torch": {"update": (1,), "flush": (1,)},
    "distributed": {"update": (2,), "flush": (1,)},
}

_INVALIDATE_NAMES = frozenset({"invalidate", "_invalidate"})


def _module_consumers(tree: ast.Module) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Alias → that module's consuming entry points, for every name the
    file binds to a consuming port module."""
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for module, entries in _CONSUMING.items():
        for alias in module_aliases(tree, module):
            out[alias] = entries
    return out


class _ConsumeScan:
    """Linear statement-order scan of one function body."""

    def __init__(self, ctx, modules):
        self.ctx = ctx
        self.modules = modules
        self.spent: Dict[str, int] = {}        # chain -> consuming lineno
        self.out: List = []

    # -- call-site consumption resolution ----------------------------
    def _consumed_indices(self, call: ast.Call
                          ) -> Optional[Tuple[int, ...]]:
        f = call.func
        if isinstance(f, ast.Attribute):
            entries = self.modules.get(attr_chain(f.value))
            if entries is not None:
                return entries.get(f.attr)
        return None

    # -- spent-set bookkeeping ---------------------------------------
    def _read(self, chain: str, node) -> None:
        for key, line in self.spent.items():
            if chain == key or chain.startswith(key + "."):
                self.out.append(self.ctx.violation(
                    "FL002", node,
                    f"'{chain}' read after being consumed on line {line} — "
                    "the call rewrote its tensors in place and returned "
                    "the successor; rebind the result instead"))
                return

    def _kill(self, chain: str) -> None:
        for key in [k for k in self.spent
                    if k == chain or k.startswith(chain + ".")]:
            del self.spent[key]

    # -- expression walk (reads + consumptions, in evaluation order) --
    def _expr(self, node) -> None:
        if node is None:
            return
        if isinstance(node, (ast.Name, ast.Attribute)):
            chain = attr_chain(node)
            if chain is not None:
                self._read(chain, node)
                return                      # chain fully handled
            # fall through: complex base (subscript/call) — walk children
        if isinstance(node, ast.Call):
            for child in list(node.args) + [kw.value for kw in node.keywords]:
                self._expr(child)
            self._expr(node.func)
            idx = self._consumed_indices(node)
            if idx:
                for i in idx:
                    if i < len(node.args):
                        chain = attr_chain(node.args[i])
                        if chain:
                            self.spent[chain] = node.lineno
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return                          # separate scope, scanned apart
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            self._comprehension(node)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child)

    def _comprehension(self, node) -> None:
        """A comprehension in evaluation order: each generator's iterable,
        its target (rebound every iteration), its filters, then the
        element. Its targets are local, so what they spent ends with
        it."""
        for gen in node.generators:
            self._expr(gen.iter)
            self._target(gen.target)
            for cond in gen.ifs:
                self._expr(cond)
        if isinstance(node, ast.DictComp):
            self._expr(node.key)
            self._expr(node.value)
        else:
            self._expr(node.elt)
        for gen in node.generators:
            for sub in ast.walk(gen.target):
                if isinstance(sub, ast.Name):
                    self._kill(sub.id)

    def _target(self, node) -> None:
        """Assignment target: kill rebound chains (value side was already
        scanned); subscript/starred targets still *read* their base."""
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self._target(elt)
        elif isinstance(node, ast.Starred):
            self._target(node.value)
        elif isinstance(node, (ast.Name, ast.Attribute)):
            chain = attr_chain(node)
            if chain:
                self._kill(chain)
            else:
                self._expr(node.value)      # e.g. ``f(x).attr = v``
        elif isinstance(node, ast.Subscript):
            self._expr(node.value)          # ``spent[i] = v`` reads spent
            self._expr(node.slice)

    # -- statement walk ----------------------------------------------
    def _merge(self, *snapshots: Dict[str, int]) -> None:
        merged: Dict[str, int] = {}
        for snap in snapshots:
            merged.update(snap)
        self.spent = merged

    def _branch(self, body) -> Dict[str, int]:
        saved = dict(self.spent)
        self._stmts(body)
        result = self.spent
        self.spent = saved
        return result

    def _stmts(self, body) -> None:
        for st in body:
            self._stmt(st)

    def _stmt(self, st) -> None:
        if isinstance(st, ast.Assign):
            self._expr(st.value)
            for t in st.targets:
                self._target(t)
        elif isinstance(st, ast.AnnAssign):
            self._expr(st.value)
            self._target(st.target)
        elif isinstance(st, ast.AugAssign):
            self._expr(st.value)
            chain = attr_chain(st.target)
            if chain:
                self._read(chain, st.target)  # x += v reads then rebinds
                self._kill(chain)
        elif isinstance(st, (ast.Expr, ast.Return)):
            self._expr(st.value)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                chain = attr_chain(t)
                if chain:
                    self._kill(chain)
        elif isinstance(st, ast.If):
            self._expr(st.test)
            a = self._branch(st.body)
            b = self._branch(st.orelse)
            self._merge(a, b)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self._target(st.target)
            a = self._branch(st.body)
            b = self._branch(st.orelse)
            self._merge(self.spent, a, b)
        elif isinstance(st, ast.While):
            self._expr(st.test)
            a = self._branch(st.body)
            b = self._branch(st.orelse)
            self._merge(self.spent, a, b)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._target(item.optional_vars)
            self._stmts(st.body)
        elif isinstance(st, ast.Try):
            snaps = [self._branch(st.body)]
            for h in st.handlers:
                snaps.append(self._branch(h.body))
            snaps.append(self._branch(st.orelse))
            self._merge(*snaps)
            self._stmts(st.finalbody)
        elif isinstance(st, (ast.Raise, ast.Assert)):
            self._expr(getattr(st, "exc", None) or getattr(st, "test", None))
            self._expr(getattr(st, "cause", None) or getattr(st, "msg", None))
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            pass                            # separate scope, scanned apart
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._expr(child)


def _check_fl002(ctx) -> List:
    modules = _module_consumers(ctx.tree)
    out: List = []
    scopes = [n for n in ast.walk(ctx.tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in scopes:
        scan = _ConsumeScan(ctx, modules)
        scan._stmts(fn.body)
        out.extend(scan.out)
    # module level (rare but real: scripts updating at top level)
    scan = _ConsumeScan(ctx, modules)
    scan._stmts([s for s in ctx.tree.body
                 if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))])
    out.extend(scan.out)
    return out


def _check_fl003(ctx) -> List:
    out: List = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name == "__init__":
            continue                        # first bind: nothing cached yet
        rebinds = []
        invalidates = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    for sub in ast.walk(t):
                        if (isinstance(sub, ast.Attribute)
                                and sub.attr == "state"
                                and isinstance(sub.ctx, ast.Store)):
                            rebinds.append(sub)
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _INVALIDATE_NAMES):
                    invalidates = True
                elif isinstance(f, ast.Name) and f.id in _INVALIDATE_NAMES:
                    invalidates = True
        if rebinds and not invalidates:
            for r in rebinds:
                out.append(ctx.violation(
                    "FL003", r,
                    f"'{fn.name}' rebinds a .state attribute without "
                    "calling query_engine.invalidate() — stale cached "
                    "counts survive the swap (flush→invalidate contract)"))
    out.extend(_check_filter_contract(ctx))
    return out


#: DeviceTableState field count (segments.py); a keyword-style rebuild
#: naming fewer fields than this while omitting filter_words is dropping
#: the filter arrays, not renaming them.
_STATE_FIELDS = 10

_MERGE_NAMES = frozenset({"merge", "merge_dirty"})


def _mentions_filter(node: ast.expr) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "filter" in sub.id:
            return True
        if isinstance(sub, ast.Attribute) and "filter" in sub.attr:
            return True
    return False


def _check_filter_contract(ctx) -> List:
    """Bloom-filter lifecycle: state rebuilds must carry ``filter_words``;
    device merges must pass the filter through."""
    out: List = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if name == "DeviceTableState" and node.keywords:
            kw_names = {kw.arg for kw in node.keywords}
            if (None not in kw_names            # **kwargs may carry it
                    and "filter_words" not in kw_names
                    and len(node.args) + len(node.keywords) < _STATE_FIELDS):
                out.append(ctx.violation(
                    "FL003", node,
                    "DeviceTableState(...) rebuilt without filter_words — "
                    "dropping the Bloom filter arrays breaks the "
                    "no-false-negatives invariant"))
        elif (name in _MERGE_NAMES and len(node.args) >= 4
                and not any(_mentions_filter(a) for a in node.args)
                and not any(_mentions_filter(kw.value)
                            for kw in node.keywords)):
            # ≥4 positional args = the kernel/ops merge signature (pair,
            # keys, counts, …), not an engine-level merge(wait=...)
            out.append(ctx.violation(
                "FL003", node,
                f"'{name}' called without a filter argument — merges must "
                "thread filter_words so inserted keys stay covered"))
    return out


FL002 = Rule(
    id="FL002",
    summary="no read of a binding after a call consumed it in place",
    scope="all",
    check=_check_fl002,
)

FL003 = Rule(
    id="FL003",
    summary="every .state rebind must invalidate the paired query engine",
    scope="src",
    check=_check_fl003,
)
