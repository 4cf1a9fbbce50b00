"""Deterministic fault injection for the serving engine (chaos layer).

The port's own copy of the JAX package's ``serve/faults.py``, whole:
plans built from the same specs or seed equal the reference's field
for field.

Production serving has to survive the failures it cannot prevent:
allocator exhaustion, numerically poisoned batches, lost device
buffers, stalled steps. This module makes those failures *injectable
and reproducible* so the engine's recovery paths are exercised by CI
instead of discovered in production.

A :class:`FaultPlan` is a seeded, immutable schedule of faults keyed by
the engine's monotonic step clock (one tick per ``Engine.run`` loop
iteration, monotonic across runs). The engine consults the plan at four
hook points:

  * ``alloc`` — the next :class:`~repro_torch.serve.paging.PagePool` page
    draw in that step raises :class:`AllocFault` (simulating allocator
    exhaustion mid-``ensure``; the engine's admission transaction rolls
    the pool back);
  * ``nan``   — the decode step's logits for one slot (or all slots)
    are overwritten with NaN *inside the decode step* via a poison
    mask on the device, so the engine's NaN guard trips exactly the way
    a real numeric blow-up would;
  * ``exc``   — the step raises :class:`StepFault` before dispatch,
    standing in for a mid-step device error that leaves the cache
    half written (the engine must rebuild device state);
  * ``slow``  — the step sleeps, standing in for a straggler device so
    deadline enforcement can be tested deterministically.

Plans are pure schedules: the same plan driven through the same engine
traffic injects the same faults. Build one explicitly
(:func:`FaultPlan.from_specs` / :func:`parse_plan`) or randomly but
reproducibly (:func:`FaultPlan.random`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("alloc", "nan", "exc", "slow")


class FaultError(RuntimeError):
    """Base class of injected faults (never raised by real failures, so
    tests can tell injected faults from genuine bugs)."""


class AllocFault(FaultError):
    """Injected page-allocation failure (pool pressure chaos)."""


class StepFault(FaultError):
    """Injected mid-step device error (donated buffers presumed lost)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind : 'alloc' | 'nan' | 'exc' | 'slow'
    step : engine clock tick (run-loop iteration, monotonic across runs)
    slot : for 'nan': the poisoned slot, or None => every active slot
    arg  : for 'slow': sleep seconds
    """
    kind: str
    step: int
    slot: Optional[int] = None
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


class FaultPlan:
    """An immutable, queryable schedule of :class:`Fault` entries."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, KINDS.index(f.kind),
                                          -1 if f.slot is None else f.slot)))
        self._by_step: Dict[int, List[Fault]] = {}
        for f in self.faults:
            self._by_step.setdefault(f.step, []).append(f)

    # -- constructors --------------------------------------------------

    @classmethod
    def from_specs(cls, *specs) -> "FaultPlan":
        return cls([s if isinstance(s, Fault) else Fault(**s)
                    for s in specs])

    @classmethod
    def random(cls, seed: int, n_steps: int, *, n_slots: int = 4,
               p_alloc: float = 0.0, p_nan: float = 0.0,
               p_exc: float = 0.0, p_slow: float = 0.0,
               slow_s: float = 1e-3) -> "FaultPlan":
        """Reproducible random schedule: same seed => same plan."""
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []
        for step in range(n_steps):
            draws = rng.random(4)
            if draws[0] < p_alloc:
                faults.append(Fault("alloc", step))
            if draws[1] < p_nan:
                faults.append(Fault("nan", step,
                                    slot=int(rng.integers(n_slots))))
            if draws[2] < p_exc:
                faults.append(Fault("exc", step))
            if draws[3] < p_slow:
                faults.append(Fault("slow", step, arg=slow_s))
        return cls(faults)

    # -- queries (all pure) --------------------------------------------

    def at(self, step: int) -> List[Fault]:
        return list(self._by_step.get(step, ()))

    def alloc_fails(self, step: int) -> bool:
        return any(f.kind == "alloc" for f in self.at(step))

    def poison_slots(self, step: int) -> Optional[List[Optional[int]]]:
        """Slots whose decode logits are NaN-poisoned this step (None
        inside the list = every active slot); None = no poisoning."""
        s = [f.slot for f in self.at(step) if f.kind == "nan"]
        return s or None

    def step_raises(self, step: int) -> bool:
        return any(f.kind == "exc" for f in self.at(step))

    def slow_s(self, step: int) -> float:
        return sum(f.arg for f in self.at(step) if f.kind == "slow")

    def max_step(self) -> int:
        return max((f.step for f in self.faults), default=-1)

    def describe(self) -> str:
        if not self.faults:
            return "no faults"
        return ",".join(
            f"{f.kind}@{f.step}"
            + (f".{f.slot}" if f.slot is not None else "")
            + (f":{f.arg:g}" if f.arg else "")
            for f in self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultPlan)
                and self.faults == other.faults)

    def __repr__(self) -> str:
        return f"FaultPlan({self.describe()})"


def parse_plan(text: str) -> FaultPlan:
    """Parse the ``--fault-plan`` CLI DSL: a comma-separated list of
    ``kind@step``, ``nan@step.slot`` and ``slow@step:seconds`` entries,
    e.g. ``"alloc@3,nan@5.1,exc@7,slow@2:0.01"``. Empty string => no
    faults."""
    text = (text or "").strip()
    if not text:
        return FaultPlan()
    faults = []
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            kind, _, rest = item.partition("@")
            arg = 0.0
            if ":" in rest:
                rest, _, a = rest.partition(":")
                arg = float(a)
            slot: Optional[int] = None
            if "." in rest:
                rest, _, sl = rest.partition(".")
                slot = int(sl)
            faults.append(Fault(kind.strip(), int(rest), slot=slot,
                                arg=arg))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad --fault-plan entry {item!r}: expected "
                "kind@step[.slot][:arg] with kind in "
                f"{KINDS} ({e})") from None
    return FaultPlan(faults)
