"""AST rule pass: PagePool transaction discipline and decode-path
hygiene, as ruff-style diagnostics (the port's copy of the JAX
package's ``analysis/rules.py``).

The pool invariants these rules prove (DESIGN.md §7/§8):

  RWA501  every ``pool.begin()`` reaches a ``commit()``/``rollback()``
          on **every normal exit path** (fall-through, return, break,
          continue, and each loop iteration must leave the transaction
          depth where it found it). ``raise`` paths are excused: the
          engine's recovery boundary drains open transactions
          (`while pool.in_transaction(): pool.rollback()`).
  RWA502  ``_make_room``/``reclaim`` (prefix-cache LRU eviction) must
          run strictly *before* ``begin``: a rollback restores
          refcounts but cannot resurrect a dropped radix-tree node, so
          an in-transaction eviction strands pages forever.
  RWA503  multi-page pool mutation (``admit``/``ensure``/``map_shared``
          /``cow``) only inside an open transaction — outside one, an
          ``AllocFault`` mid-sequence leaks a half-admission.
          (``release`` is exempt by design: it is a self-contained
          single-owner teardown the recovery path calls while *no*
          transaction can be live.)
  RWA504  no ``torch.cat``/``stack``/``vstack``/``hstack`` in serving
          modules: a per-token weight-panel rebuild belongs in the fused
          param layout, and activation concats hide O(len) copies in the
          decode step. A function may be allowed them (``concat_allow``:
          the engine's ``_fetch`` stacks the few per-slot values it reads
          back, so the call's one read is one transfer).

The walker abstract-interprets each function over a *set* of possible
transaction depths (branches merge by union), which is exact for the
engine's shapes: straight-line begin/try/commit blocks with
early-continue and AllocFault rollbacks.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.report import Diagnostic, PassResult

_MUTATORS = frozenset({"admit", "ensure", "map_shared", "cow"})
_EVICTORS = frozenset({"_make_room", "reclaim"})
_CONCATS = frozenset({"cat", "concat", "concatenate", "stack", "vstack",
                      "hstack"})


def _call_attr(node: ast.AST) -> str:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id
    return ""


def _on_pool(node: ast.Call) -> bool:
    """True for `<...>.pool.m(...)` or `pool.m(...)` receivers."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    base = f.value
    if isinstance(base, ast.Attribute):
        return base.attr == "pool"
    if isinstance(base, ast.Name):
        return base.id == "pool"
    return False


@dataclasses.dataclass
class _TxWalker:
    path: str
    fname: str
    diags: List[Diagnostic] = dataclasses.field(default_factory=list)
    checked: int = 0

    def _diag(self, code: str, node: ast.AST, msg: str):
        self.diags.append(Diagnostic(
            code=code, message=f"{msg} (in {self.fname})",
            path=self.path, line=getattr(node, "lineno", 0)))

    # states: the set of possible open-transaction depths here
    def walk(self, body: List[ast.stmt],
             states: Set[int]) -> Optional[Set[int]]:
        """Returns the state set at fall-through, or None if every path
        exits (return/raise/break/continue)."""
        for stmt in body:
            states = self.stmt(stmt, states)
            if states is None:
                return None
        return states

    def _scan_calls(self, node: ast.AST, states: Set[int]):
        """Apply the eviction/mutation rules to every call under
        `node` — which must contain no nested *statements*, so the
        transaction state here is exact."""
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            attr = _call_attr(call)
            if attr in _EVICTORS and any(s > 0 for s in states):
                self.checked += 1
                self._diag("RWA502", call,
                           f"`{attr}` runs inside an open pool "
                           "transaction: rollback cannot resurrect an "
                           "evicted prefix-cache node")
            elif attr in _MUTATORS and _on_pool(call):
                self.checked += 1
                if 0 in states:
                    self._diag("RWA503", call,
                               f"pool.{attr}() outside a transaction: "
                               "an AllocFault here leaks a partial "
                               "admission")

    def stmt(self, stmt: ast.stmt,
             states: Set[int]) -> Optional[Set[int]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return states             # analysed as its own function
        # compound statements: rule-scan only their header expressions
        # here (their bodies recurse below, each at its own state)
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_calls(stmt.test, states)
        elif isinstance(stmt, ast.For):
            self._scan_calls(stmt.iter, states)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._scan_calls(item.context_expr, states)
        elif not isinstance(stmt, ast.Try):
            self._scan_calls(stmt, states)

        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            attr = _call_attr(stmt.value)
            if _on_pool(stmt.value):
                if attr == "begin":
                    self.checked += 1
                    return {s + 1 for s in states}
                if attr in ("commit", "rollback"):
                    return {max(0, s - 1) for s in states}
            return states

        if isinstance(stmt, ast.If):
            a = self.walk(list(stmt.body), set(states))
            b = self.walk(list(stmt.orelse), set(states))
            if a is None and b is None:
                return None
            return (a or set()) | (b or set())

        if isinstance(stmt, (ast.For, ast.While)):
            end = self.walk(list(stmt.body), set(states))
            if end is not None and end != states:
                self._diag("RWA501", stmt,
                           "transaction depth changes across a loop "
                           f"iteration ({sorted(states)} -> "
                           f"{sorted(end)})")
            self.walk(list(stmt.orelse), set(states))
            return states

        if isinstance(stmt, ast.Try):
            body_end = self.walk(list(stmt.body), set(states))
            # a handler can enter at the state of ANY point in the body:
            # approximate with entry + fall-through states
            handler_entry = set(states) | (body_end or set())
            handler_ends: Set[int] = set()
            for h in stmt.handlers:
                he = self.walk(list(h.body), set(handler_entry))
                if he is not None:
                    handler_ends |= he
            else_end = self.walk(list(stmt.orelse),
                                 set(body_end if body_end is not None
                                     else states))
            out: Set[int] = set()
            if body_end is not None and not stmt.orelse:
                out |= body_end
            if else_end is not None:
                out |= else_end
            out |= handler_ends
            if stmt.finalbody:
                return self.walk(list(stmt.finalbody),
                                 out or set(states))
            return out if (out or handler_ends or body_end is not None
                           or else_end is not None) else None

        if isinstance(stmt, ast.With):
            return self.walk(list(stmt.body), states)

        if isinstance(stmt, (ast.Return, ast.Break, ast.Continue)):
            if any(s > 0 for s in states):
                kind = type(stmt).__name__.lower()
                self._diag("RWA501", stmt,
                           f"`{kind}` with an open pool transaction "
                           "(begin without commit/rollback on this "
                           "path)")
            return None

        if isinstance(stmt, ast.Raise):
            return None               # recovery boundary drains these

        return states


def _enclosing(tree: ast.AST) -> dict:
    """id(call) -> the name of the innermost function holding it."""
    owner = {}

    def visit(node, fname):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fname
            if isinstance(child, ast.Call):
                owner[id(child)] = name
            visit(child, name)
    visit(tree, "")
    return owner


def audit_source(src: str, path: str = "<string>", *,
                 concat_rule: bool = True,
                 concat_allow: Tuple[str, ...] = ()) -> PassResult:
    result = PassResult(name="rules")
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _TxWalker(path=path, fname=node.name)
            end = w.walk(list(node.body), {0})
            if end is not None and any(s > 0 for s in end):
                w._diag("RWA501", node,
                        "function falls through with an open pool "
                        "transaction")
            result.diagnostics.extend(w.diags)
            result.checked += w.checked
    if concat_rule:
        owner = _enclosing(tree)
        for call in [n for n in ast.walk(tree) if isinstance(n, ast.Call)]:
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in _CONCATS and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in ("torch", "jnp"):
                result.checked += 1
                if owner.get(id(call)) in concat_allow:
                    continue
                result.diagnostics.append(Diagnostic(
                    code="RWA504",
                    message=f"{f.value.id}.{f.attr} in a serving module: "
                            "decode must stream pre-fused panels, not "
                            "rebuild them per token",
                    path=path, line=call.lineno))
    return result


def audit_file(path: str, *, concat_rule: bool = True,
               concat_allow: Tuple[str, ...] = ()) -> PassResult:
    with open(path) as f:
        return audit_source(f.read(), path=path, concat_rule=concat_rule,
                            concat_allow=concat_allow)
