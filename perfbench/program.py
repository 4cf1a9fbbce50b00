"""What the per-layer metrics read from the port's own trace
(``repro_torch/core/trace.py``): its host spans and launch counters over
the traced units.

The port records them while a ``torch.profiler`` session is open, so the
traced run (``--trace 1``) gets them for exactly the traced units and the
measured run records nothing. They share the profiler's clock,
``time.time_ns()``. The first reader of a run takes them from the port
(which clears them) and keeps them on the reader context for the rest.
A reader returns None where the port keeps no such trace, or where the
entry spans do not match the traced units one for one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

KEY = "program_trace"


@dataclass
class Units:
    """The traced units as the port's trace saw them."""
    host_s: List[float]         # each entry call's span
    wrapper_s: List[float]      # each call's kernel wrapper spans, summed
    counters: Dict[str, int]    # the session's counters
    dropped: int                # spans past the port's bound

    @property
    def launches(self) -> int:
        return sum(n for k, n in self.counters.items()
                   if k.startswith("launch.") and k.count(".") == 2)


def _taken(ctx):
    if KEY not in ctx.__dict__:
        try:
            from repro_torch.core import trace
        except ImportError:
            ctx.__dict__[KEY] = None
        else:
            ctx.__dict__[KEY] = trace.take()
    return ctx.__dict__[KEY]


def units(ctx, entry: str) -> Optional[Units]:
    """The traced units' calls of the entry point ``entry``, or None."""
    taken = _taken(ctx)
    if taken is None:
        return None
    spans, counters = taken
    calls = [s for s in spans if s.name == entry and s.parent == -1]
    if not calls or len(calls) != len(ctx.traced_units):
        return None
    wrapper: Dict[int, int] = {s.unit: 0 for s in calls}
    for s in spans:
        if s.name.startswith("kernel.") and s.unit in wrapper:
            wrapper[s.unit] += s.end - s.start
    return Units(host_s=[(s.end - s.start) / 1e9 for s in calls],
                 wrapper_s=[wrapper[s.unit] / 1e9 for s in calls],
                 counters=dict(counters),
                 dropped=counters.get("trace.dropped_spans", 0))


def host_ms(ctx, entry: str) -> Optional[float]:
    """The mean host time of one entry call, ms."""
    u = units(ctx, entry)
    return None if u is None else 1e3 * sum(u.host_s) / len(u.host_s)


def wrapper_ms(ctx, entry: str) -> Optional[float]:
    """The mean host time of one entry call spent inside the kernel
    wrappers (from entry to return: checks, design pick, the output's
    allocation, the launch), ms."""
    u = units(ctx, entry)
    if u is None or u.dropped:
        return None
    return 1e3 * sum(u.wrapper_s) / len(u.wrapper_s)


def launches(ctx, entry: str, counter: Optional[str] = None
             ) -> Optional[float]:
    """Kernel launches a traced unit (``counter``: that counter a unit
    instead); None where nothing launched (a CPU run)."""
    u = units(ctx, entry)
    if u is None or not u.launches:
        return None
    n = u.launches if counter is None else u.counters.get(counter, 0)
    return n / len(u.host_s)
