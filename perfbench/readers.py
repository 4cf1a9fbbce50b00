"""What the per-layer metrics' readers share. A reader returns None
where it finds nothing to read (the harness then leaves the metric out
of the line); a share of a peak or of a roofline is never made 0 or
clipped at 100."""
from __future__ import annotations

from typing import Optional


def _peak_flops(ctx) -> Optional[float]:
    if ctx.peak is None:
        return None
    return ctx.peak.get(ctx.config["dtype"])


def mfu(ctx) -> Optional[float]:
    """The traced units' useful operations (the configuration's work of
    each) over the traced window's length on the host clock, as a share
    (%) of the card's peak in the configuration's dtype: the whole
    step's, host gaps included."""
    peak = _peak_flops(ctx)
    if (peak is None or not ctx.traced_units or ctx.trace is None
            or ctx.trace.busy_s <= 0):
        return None
    flops = sum(ctx.work.flops(u, ctx.config) for u in ctx.traced_units)
    return 100.0 * flops / ctx.trace.window_s / peak


def roofline(ctx, family: str, least) -> Optional[float]:
    """The least time the card could take for the traced units' work of
    one kernel family (``least(unit, config, dtype_peak, bytes_per_s)``,
    from the configuration's shapes) over the device time of that
    family, %."""
    peak = _peak_flops(ctx)
    device_s = ctx.trace.family_s.get(family, 0.0) if ctx.trace else 0.0
    if peak is None or device_s <= 0 or not ctx.traced_units:
        return None
    need = sum(least(u, ctx.config, peak, ctx.peak["bytes_per_s"])
               for u in ctx.traced_units)
    if need <= 0:
        return None
    return 100.0 * need / device_s


def idle_share(ctx) -> Optional[float]:
    """The share (%) of the traced window in which the card ran nothing."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
