"""Sync-point pass: find hidden host<->device synchronisation in the
serving hot path.

The engine's latency contract is *one* device read per step-loop call:
the sampled tokens and their finite-ness flags travel in one
``Engine._fetch`` (one ``.cpu()`` of one stacked tensor). Anything else
that forces a transfer (``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``int()/float()/bool()`` on a device tensor,
``np.asarray`` on one, ``torch.cuda.synchronize``) adds a blocking
round trip per call site and serialises the loop.

Two halves:

* :func:`audit_source`, the port's retarget of the JAX package's AST
  taint analysis. Device-ness propagates forward from *producers*:
  ``torch.*`` constructors and ops given a device (``device=`` not the
  CPU) or a device operand, ``.to(<device>)`` / ``.cuda()``,
  ``runtime.to_device``, the engine's step programs and ``_put``, and
  ``self.X`` attributes ever assigned a device value (a fixpoint across
  methods). Taint dies at host reads and at metadata: ``.shape``,
  ``.dtype``, ``.device``, ``.ndim``, ``.numel()``, ``.size()``,
  ``.dim()``. Unknown calls forward their arguments' taint. Sinks on a
  device value raise RWA101/102/103/107; ``torch.cuda.synchronize``
  RWA105. The count of ``self._fetch(...)`` call sites and of host-read
  sites (``.cpu()``, ``.item()``, ``.tolist()``, and ``.numpy()`` not on
  a ``.cpu()``) per function is held to an explicit allowlist (RWA104),
  so a refactor that adds "just one more read" fails the audit.
* :func:`audit_entry_points`, the counterpart of JAX's jaxpr scan: it
  runs each serving entry point once under the dispatch recorder
  (``analysis/dispatch.py``) and reports RWA106 for every host read
  inside one. On a card the same calls run under
  ``torch.cuda.set_sync_debug_mode("error")``, the ground truth, and the
  two must agree.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.report import Diagnostic, PassResult

# attribute reads that return host metadata, never device bytes
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "layout", "requires_grad", "itemsize"})
# methods that return host metadata
_META_METHODS = frozenset({"numel", "size", "dim", "stride",
                           "element_size", "get_device", "data_ptr",
                           "is_contiguous", "nelement"})
# torch callables that build no tensor (a generator, a device, a dtype's
# limits, a grad mode): never producers whatever their arguments
_TORCH_HOST = ("torch.Generator", "torch.device", "torch.finfo",
               "torch.iinfo", "torch.no_grad", "torch.inference_mode",
               "torch.enable_grad", "torch.is_tensor",
               "torch.get_default_dtype", "torch.cuda.")
# methods that read a tensor back to the host
_HOST_READS = frozenset({"cpu", "item", "tolist", "numpy"})
# the engine's one sanctioned read, and the host->device sender
FETCH = "_fetch"
TO_DEVICE = ("runtime.to_device", "to_device")
# numpy constructors that materialise their argument on the host
_NP_SINKS = frozenset({"asarray", "array", "concatenate", "stack",
                       "ascontiguousarray", "copy"})


@dataclasses.dataclass
class SyncPolicy:
    """What the audited module is allowed to do.

    ``fetch_allow`` maps function name -> sanctioned number of
    ``self._fetch(...)`` call sites; ``host_read_allow`` function name ->
    sanctioned number of host-read sites (``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()``). Unlisted functions get 0 of each.
    """
    fetch_allow: Dict[str, int] = dataclasses.field(default_factory=dict)
    host_read_allow: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    device_methods: Tuple[str, ...] = ("_step", "_admit", "_chunk",
                                       "_spec", "_put", "put_rep")


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for the callee of torch.cuda.synchronize()."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_cpu(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.split(":")[0] in ("cpu", "meta")


def _device_dataclass_fields(tree: ast.Module) -> Set[str]:
    """Field names annotated ``torch.Tensor`` in any class of the module:
    values travelling under these names are device tensors by contract."""
    fields: Set[str] = set()
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                ann = stmt.annotation
                name = _dotted(ann) if isinstance(
                    ann, (ast.Attribute, ast.Name)) else ""
                if name == "torch.Tensor":
                    fields.add(stmt.target.id)
    return fields


class _FunctionTaint:
    """One function body: forward taint, record diagnostics."""

    def __init__(self, path: str, fname: str, policy: SyncPolicy,
                 device_attrs: Set[str], device_fields: Set[str]):
        self.path, self.fname, self.policy = path, fname, policy
        self.device_attrs = device_attrs      # self.X names (mutated!)
        self.device_fields = device_fields
        self.tainted: Set[str] = set()
        self.diags: List[Diagnostic] = []
        # distinct call *sites* (loop bodies walk twice for the taint
        # fixpoint: a site must not count per walk)
        self.fetch_sites: Set[int] = set()
        self.read_sites: Dict[int, ast.Call] = {}
        self.flagged: Set[Tuple[int, str]] = set()
        self.checked = 0

    # -- expression taint ------------------------------------------------

    def taint_of(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False          # metadata read kills the taint
            if isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                return node.attr in self.device_attrs
            if node.attr in self.device_fields:
                return True
            return self.taint_of(node.value)
        if isinstance(node, ast.Call):
            return self.call_taint(node)
        if isinstance(node, ast.Subscript):
            return self.taint_of(node.value)
        if isinstance(node, ast.BinOp):
            return self.taint_of(node.left) or self.taint_of(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint_of(node.operand)
        if isinstance(node, ast.Compare):
            return self.taint_of(node.left) or \
                any(self.taint_of(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.taint_of(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.taint_of(node.body) or self.taint_of(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.taint_of(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.taint_of(node.value)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self.taint_of(node.elt) or any(
                self.taint_of(g.iter) for g in node.generators)
        return False

    def _flag(self, code: str, node: ast.AST, msg: str):
        key = (id(node), code)
        if key not in self.flagged:
            self.flagged.add(key)
            self.diags.append(Diagnostic(
                code=code, message=f"{msg} (in {self.fname})",
                path=self.path, line=getattr(node, "lineno", 0)))

    def call_taint(self, node: ast.Call) -> bool:
        callee = _dotted(node.func)
        args_tainted = any(self.taint_of(a) for a in node.args) or \
            any(self.taint_of(kw.value) for kw in node.keywords)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            base = node.func.value
            if attr == FETCH and \
                    isinstance(base, ast.Name) and base.id == "self":
                self.fetch_sites.add(id(node))
                return False          # the sanctioned read: host after
            if attr in _HOST_READS:
                base_tainted = self.taint_of(base)
                chained = attr == "numpy" and isinstance(base, ast.Call) \
                    and isinstance(base.func, ast.Attribute) and \
                    base.func.attr == "cpu"
                if not chained:
                    self.read_sites[id(node)] = node
                if base_tainted:
                    if attr == "item":
                        self._flag("RWA101", node,
                                   "`.item()` on a device value blocks on "
                                   "a device->host transfer")
                    else:
                        self._flag("RWA107", node,
                                   f"`.{attr}()` on a device value is a "
                                   "blocking device->host read")
                return False          # the result is on the host
            if attr in _META_METHODS:
                self.taint_of(base)
                return False
            if attr == "synchronize" or callee == "torch.cuda.synchronize":
                self._flag("RWA105", node,
                           "torch.cuda.synchronize() serialises the step "
                           "loop outside a sanctioned fetch")
                return False
            if attr == "cuda":
                return True
            if attr == "to":
                target = [a for a in node.args] + [
                    kw.value for kw in node.keywords if kw.arg == "device"]
                if any(_is_cpu(t) for t in target):
                    if self.taint_of(base):
                        self._flag("RWA107", node,
                                   "`.to('cpu')` on a device value is a "
                                   "blocking device->host read")
                    return False
                dtype_only = target and all(
                    _dotted(t).startswith("torch.") for t in target)
                if dtype_only or not target:
                    return self.taint_of(base) or args_tainted
                return True           # .to(<a device>)
            if attr in _NP_SINKS and callee.startswith("np.") and \
                    args_tainted:
                self._flag("RWA103", node,
                           f"np.{attr}() on a device value is a hidden "
                           "device->host sync")
                return False          # result is host-resident
            if attr in self.policy.device_methods and \
                    isinstance(base, ast.Name) and base.id == "self":
                return True
        if callee in TO_DEVICE:
            return True
        if callee.startswith("torch."):
            if callee.startswith(_TORCH_HOST):
                return False
            dev = [kw.value for kw in node.keywords if kw.arg == "device"]
            if dev and not any(_is_cpu(d) for d in dev):
                return True           # built on a device
            return args_tainted
        if isinstance(node.func, ast.Name):
            if node.func.id in ("int", "float", "bool") and args_tainted:
                self._flag("RWA102", node,
                           f"{node.func.id}() on a device value is a "
                           "hidden blocking sync")
                return False
        # unknown callable (a method of a device value included): forward
        # the receiver's and the arguments' taint
        if isinstance(node.func, ast.Attribute) and \
                self.taint_of(node.func.value):
            return True
        return args_tainted

    # -- statement walk --------------------------------------------------

    def run(self, fn: ast.FunctionDef):
        self.exec_body(fn.body)
        for what, sites, allow in (
                (f"self.{FETCH}()",
                 len(self.fetch_sites),
                 self.policy.fetch_allow.get(self.fname, 0)),
                ("host-read (.cpu/.item/.tolist/.numpy)",
                 len(self.read_sites),
                 self.policy.host_read_allow.get(self.fname, 0))):
            self.checked += 1         # the per-function read contract
            if sites != allow:
                self.diags.append(Diagnostic(
                    code="RWA104",
                    message=(f"{self.fname} has {sites} {what} site(s), "
                             f"the contract allows {allow}"),
                    path=self.path, line=fn.lineno))

    def exec_body(self, body: List[ast.stmt]):
        for stmt in body:
            self.exec_stmt(stmt)

    def exec_stmt(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            tainted = self.taint_of(value)
            self.checked += 1
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if isinstance(stmt, ast.AugAssign):
                tainted = tainted or self.taint_of(stmt.target)
            for tgt in targets:
                self.assign(tgt, value, tainted)
        elif isinstance(stmt, ast.Expr):
            self.taint_of(stmt.value)
            self.checked += 1
        elif isinstance(stmt, ast.If):
            self.taint_of(stmt.test)
            self.exec_body(stmt.body)
            self.exec_body(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                self.assign(stmt.target, None, self.taint_of(stmt.iter))
            else:
                self.taint_of(stmt.test)
            # two passes approximate the loop fixpoint (taint introduced
            # late in the body reaches uses at the top)
            self.exec_body(stmt.body)
            self.exec_body(stmt.body)
            self.exec_body(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            self.exec_body(stmt.body)
            for h in stmt.handlers:
                self.exec_body(h.body)
            self.exec_body(stmt.orelse)
            self.exec_body(stmt.finalbody)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.taint_of(item.context_expr)
            self.exec_body(stmt.body)
        elif isinstance(stmt, (ast.Return, ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.taint_of(child)
        # nested defs/classes are analysed as their own functions

    def assign(self, tgt: ast.AST, value: Optional[ast.AST],
               tainted: bool):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            # elementwise only when the value side unpacks one-to-one
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(tgt.elts):
                for t, v in zip(tgt.elts, value.elts):
                    self.assign(t, v, self.taint_of(v))
            else:
                for t in tgt.elts:
                    self.assign(t, None, tainted)
            return
        if isinstance(tgt, ast.Name):
            if tainted:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif tainted and isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            # never un-taint a self attribute: another method may still
            # hold a device value under the same name
            self.device_attrs.add(tgt.attr)


def audit_source(src: str, path: str = "<string>", *,
                 policy: Optional[SyncPolicy] = None) -> PassResult:
    """Run the sync-point pass over one module's source text."""
    policy = policy or SyncPolicy()
    tree = ast.parse(src)
    device_fields = _device_dataclass_fields(tree)
    result = PassResult(name="sync")

    funcs: List[Tuple[str, ast.FunctionDef]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.append((node.name, node))

    # fixpoint over self.X device attributes: a method assigning
    # `self.cache = ...` a device value taints `self.cache` for every
    # other method
    device_attrs: Set[str] = set()
    for _ in range(3):
        before = set(device_attrs)
        for fname, fn in funcs:
            probe = _FunctionTaint(path, fname, policy, device_attrs,
                                   device_fields)
            probe.exec_body(fn.body)
        if device_attrs == before:
            break

    for fname, fn in funcs:
        ft = _FunctionTaint(path, fname, policy, set(device_attrs),
                            device_fields)
        ft.run(fn)
        result.diagnostics.extend(ft.diags)
        result.checked += ft.checked
    return result


def site_counts(src: str, policy: Optional[SyncPolicy] = None) \
        -> Dict[str, Tuple[int, int]]:
    """(``self._fetch`` call sites, host-read sites) of each function of
    a module that has any: what RWA104 holds to the allowlists."""
    policy = policy or SyncPolicy()
    out = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ft = _FunctionTaint("", node.name, policy, set(), set())
            ft.exec_body(node.body)
            if ft.fetch_sites or ft.read_sites:
                out[node.name] = (len(ft.fetch_sites), len(ft.read_sites))
    return out


def audit_file(path: str, *, policy: Optional[SyncPolicy] = None) \
        -> PassResult:
    with open(path) as f:
        return audit_source(f.read(), path=path, policy=policy)


def audit_entry_points(runs) -> PassResult:
    """The run-time half: ``runs`` are the entry points' records
    (``analysis/dispatch.EntryRun``), each entry point run once under the
    recorder, and on a card under the sync debug mode too. RWA106 for
    every host read the recorder saw, and for every disagreement with
    the debug mode (whose count is None off the card)."""
    result = PassResult(name="sync")
    for run in runs:
        result.checked += 1
        reads = run.recorder.host_reads
        if reads:
            result.diagnostics.append(Diagnostic(
                code="RWA106", path=run.name,
                message=f"{len(reads)} host read(s) inside the entry "
                        f"point: {', '.join(sorted(set(reads)))}"))
        if run.debug_syncs is not None:
            result.checked += 1
            if (run.debug_syncs > 0) != bool(reads):
                result.diagnostics.append(Diagnostic(
                    code="RWA106", path=run.name,
                    message=f"the recorder saw {len(reads)} host read(s), "
                            "torch.cuda.set_sync_debug_mode('error') "
                            f"{run.debug_syncs}: the two disagree"))
    return result
