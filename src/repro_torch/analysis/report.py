"""Diagnostics for the port's static and run-time auditor.

Every analysis pass reports through the same two shapes:

  * :class:`Diagnostic`: one ruff-style finding, carrying a stable
    ``RWAnnn`` code, the offending location and a one-line message;
  * :class:`PassResult`: one pass run, its diagnostics plus how many
    invariant sites it checked (a pass that checked nothing is
    suspicious, not clean) and its wall time.

Code families, the JAX package's where the meaning carries over:

  RWA1xx  sync pass           hidden host<->device synchronisation
  RWA2xx  donation pass       a cache leaf not updated in place
  RWA3xx  compile-bound pass  shape signatures past the bound, operands
                              that would pay a host copy each call
  RWA4xx  shared-memory pass  kernel footprint over the H100's budget
  RWA5xx  AST rule pass       pool-transaction / serving-path rules

:data:`CODES` is the one list of codes.
"""
from __future__ import annotations

import dataclasses
from typing import List

CODES = {
    "RWA101": "`.item()` on a device value forces a blocking transfer",
    "RWA102": "int()/float()/bool() on a device value is a hidden sync",
    "RWA103": "np.asarray/np.array on a device value is a hidden sync",
    "RWA104": "device fetch count differs from the step-loop contract "
              "(Engine._fetch call sites, and host-read sites, per "
              "function)",
    "RWA105": "torch.cuda.synchronize() outside a sanctioned fetch site",
    "RWA106": "host read inside a serving entry point (recorded when it "
              "runs: a scalar read, a device->host copy, a "
              "data-dependent shape or a blocking host->device copy)",
    "RWA107": "`.cpu()`/`.tolist()`/`.numpy()` on a device value is a "
              "blocking device->host read",
    "RWA201": "a cache leaf was not updated in place (its storage, "
              "shape or dtype changed across an entry point)",
    "RWA202": "an entry point returned a fresh tensor of a cache pool "
              "leaf's shape (a copy of the pool)",
    "RWA203": "two cache leaves share storage",
    "RWA204": "a decode step's peak device memory grew by a cache pool "
              "leaf's bytes or more (the pool was copied)",
    "RWA301": "reachable shape-signature set exceeds the documented "
              "compile bound",
    "RWA302": "entry-point operand that pays a hidden host->device copy "
              "each call (a CPU tensor on a card engine, or a host value "
              "the entry point does not declare)",
    "RWA303": "run-time shape-signature count disagrees with the static "
              "enumeration",
    "RWA401": "kernel shared memory (static + dynamic) exceeds the "
              "232,448 bytes a block of the H100 may hold",
    "RWA402": "kernel shared memory differs from plan_matmul's or the "
              "model's accounting (the launcher's request)",
    "RWA403": "kernel spills registers to local memory",
    "RWA404": "registers x threads exceed 65,536 at the kernel's "
              "__launch_bounds__ minimum blocks an SM",
    "RWA501": "PagePool.begin not paired with commit/rollback on a "
              "normal exit path",
    "RWA502": "eviction (_make_room/reclaim) inside an open pool "
              "transaction",
    "RWA503": "pool mutation outside a transaction in the decode path",
    "RWA504": "torch.cat/stack/vstack/hstack in a serving module "
              "(weight-sized concats belong in the fused param layout)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    message: str
    path: str = ""                   # file, or entry-point name
    line: int = 0
    severity: str = "error"          # "error" gates; "warning" informs

    def __post_init__(self):
        assert self.code in CODES, f"unregistered diagnostic {self.code}"

    def __str__(self):
        loc = f"{self.path}:{self.line}: " if self.path else ""
        return f"{loc}{self.code} {self.message}"


@dataclasses.dataclass
class PassResult:
    name: str
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    checked: int = 0                 # invariant sites actually examined
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not any(d.severity == "error" for d in self.diagnostics)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def merge(self, other: "PassResult") -> "PassResult":
        self.diagnostics += other.diagnostics
        self.checked += other.checked
        return self

    def summary(self) -> str:
        state = "ok" if self.ok else f"{len(self.errors())} error(s)"
        return (f"[{self.name}] {state}: {self.checked} site(s) checked "
                f"in {self.wall_s * 1e3:.0f} ms")
