"""What the granite cell's span and counter readers share: the port's
spans and counters of the traced batches (``program.units``' take)."""
from __future__ import annotations

from typing import Optional

from perfbench import program


def span_ms(ctx, prefix: str) -> Optional[float]:
    """The host ms a traced ``lm.prefill`` call spends in the spans whose
    names start with ``prefix`` (each span's whole length; the port opens
    none of them inside another), the mean over the traced batches; None
    where the port has no such span or dropped spans."""
    u = program.units(ctx, "lm.prefill")
    if u is None or u.dropped:
        return None
    spans, _counters = program._taken(ctx)
    ns = sum(s.end - s.start for s in spans
             if s.name.startswith(prefix) and s.unit is not None)
    found = any(s.name.startswith(prefix) for s in spans)
    return 1e-6 * ns / len(u.host_s) if found else None


def counter(ctx, name: str) -> Optional[float]:
    """The counter ``name`` a traced batch; None where the port has none."""
    u = program.units(ctx, "lm.prefill")
    if u is None or name not in u.counters:
        return None
    return u.counters[name] / len(u.host_s)
