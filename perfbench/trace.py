"""Device busy time, idle gaps and device time by kernel family, read
from a ``torch.profiler`` trace of a steady part of the window.

After the port's ``launch/profile.py::profile_call`` (frozen here so
that a later change to the program cannot change the yardstick): the
profiler traces the card alone (CUPTI's activity records; recording
every host op would slow a host-paced loop by a third), and every
device activity (kernels, copies, fills) counts as busy. A kernel's
family is the first family file (``families/*.json``) one of whose name
patterns it contains, else ``glue``. The harness's own spans
(``bench.*``, ``engine.*``) are kept on the host's real-time clock,
which the profiler's records share: where the host was while the card
idled is the innermost span covering the middle of each gap.

A driver calls :meth:`Tracer.at_unit` before it submits each unit of
work; the tracer synchronises and starts the profiler before unit
``skip_units`` and stops it, again after a synchronise, before unit
``skip_units + units``. The trace therefore holds the device work of
exactly those units.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT_SPAN = "bench.trace"
SPAN_PREFIXES = ("bench.", "engine.")
# the breakdown keeps this many entries a list, and this much of a name
TOP = 10
NAME_CHARS = 96


@dataclass
class Event:
    name: str
    start: int              # ns since the epoch (the profiler's clock)
    end: int
    device: bool


@dataclass
class Summary:
    window_s: float
    busy_s: float
    family_s: Dict[str, float]
    ops: List[Tuple[str, float]]
    gaps: List[Tuple[str, float]]
    span_family_s: Dict[str, Dict[str, float]] = field(default_factory=dict)
    span_count: Dict[str, int] = field(default_factory=dict)

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.ops],
                "idle_gaps": [[n, s] for n, s in self.gaps]}


def load_families(directory: Path) -> List[Tuple[str, Tuple[str, ...]]]:
    """Every family file of ``directory``, in name order."""
    out = []
    for path in sorted(Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        out.append((spec["family"], tuple(spec["patterns"])))
    return out


def family_of(name: str, families) -> str:
    for fam, patterns in families:
        if any(p in name for p in patterns):
            return fam
    return "glue"


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[List[int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _name_gaps(gaps, host: List[Event]) -> Dict[str, float]:
    """Seconds of device idle by what the host was doing at the middle of
    each gap: the innermost host event covering it, with the innermost
    harness span around it where that is another."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Event] = []
    j = 0
    for s, e in sorted(gaps):
        mid = (s + e) // 2
        while j < len(host) and host[j].start <= mid:
            while stack and stack[-1].end <= host[j].start:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        covering = [ev for ev in stack if ev.start <= mid <= ev.end]
        inner = covering[-1].name if covering else "no host event"
        spans = [ev.name for ev in covering
                 if ev.name.startswith(SPAN_PREFIXES)
                 and ev.name != ROOT_SPAN]
        name = inner
        if spans and spans[-1] != inner:
            name = f"{inner} in {spans[-1]}"
        out[name[:NAME_CHARS]] += (e - s) / 1e9
    return out


def summarize(events: Sequence[Event], families) -> Summary:
    """The traced window is the root span's interval; device activity is
    clipped to it."""
    roots = [e for e in events if not e.device and e.name == ROOT_SPAN]
    if not roots:
        raise ValueError(f"the trace holds no {ROOT_SPAN!r} span")
    t0, t1 = roots[0].start, roots[0].end
    dev = sorted((e for e in events if e.device
                  and not e.name.startswith(SPAN_PREFIXES)
                  and e.end > t0 and e.start < t1),
                 key=lambda e: e.start)
    clipped = [(max(e.start, t0), min(e.end, t1)) for e in dev]
    busy = _merge(clipped)
    family_s: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    for e, (s, t) in zip(dev, clipped):
        family_s[family_of(e.name, families)] += (t - s) / 1e9
        ops[e.name[:NAME_CHARS]] += (t - s) / 1e9
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host = [e for e in events if not e.device
            and e.start < t1 and e.end > t0]
    named = _name_gaps(gaps, host)
    # device time inside each harness span: a device event belongs to
    # the span (of that name) whose interval holds its start
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for e in host:
        if e.name.startswith(SPAN_PREFIXES) and e.name != ROOT_SPAN:
            spans[e.name].append((e.start, e.end))
    span_family_s: Dict[str, Dict[str, float]] = {}
    for name, ivs in spans.items():
        ivs.sort()
        starts = [s for s, _ in ivs]
        acc: Dict[str, float] = defaultdict(float)
        for e, (s, t) in zip(dev, clipped):
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= ivs[i][1]:
                acc[family_of(e.name, families)] += (t - s) / 1e9
        span_family_s[name] = dict(acc)

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:TOP]

    return Summary(window_s=(t1 - t0) / 1e9,
                   busy_s=sum(e - s for s, e in busy) / 1e9,
                   family_s=dict(family_s), ops=top(ops), gaps=top(named),
                   span_family_s=span_family_s,
                   span_count={k: len(v) for k, v in spans.items()})


def device_events(prof) -> List[Event]:
    """The device records of a finished ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns()
            out.append(Event(e.name(), start, start + e.duration_ns(), True))
    return out


class Tracer:
    """Traces units ``skip_units`` .. ``skip_units + units - 1`` of a
    window when ``on``; otherwise every call is a no-op."""

    def __init__(self, on: bool, skip_units: int = 0, units: int = 0,
                 device=None):
        self.on = on
        self.first, self.last = skip_units, skip_units + units
        self.device = device
        self.traced: List[int] = []
        self.events: Optional[List[Event]] = None
        self.stop_s = 0.0
        self._prof = None
        self._spans: List[Event] = []
        self._t0 = 0

    def _sync(self):
        import torch
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def at_unit(self, i: int) -> None:
        if not self.on:
            return
        if i == self.first and self._prof is None and self.events is None:
            self._start()
        elif i == self.last and self._prof is not None:
            self._stop()
        if self._prof is not None:
            self.traced.append(i)

    def warm(self) -> None:
        """A throwaway profiling session: the profiler's first start in a
        process (CUPTI's) takes seconds, which belong to set-up."""
        if not self.on:
            return
        import torch
        self._start()
        torch.ones(8, device=self.device).sum().item()
        self._stop()
        self.events = None

    def finish(self) -> None:
        """Stop a trace the window ended inside."""
        if self._prof is not None:
            self._stop()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        cuda = self.device is not None and self.device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                             else [ProfilerActivity.CPU])
        self._prof.__enter__()
        self._spans = []
        self._t0 = time.time_ns()

    def _stop(self):
        self._sync()
        t1 = time.time_ns()
        t = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.events = (device_events(self._prof) + self._spans
                       + [Event(ROOT_SPAN, self._t0, t1, False)])
        self._prof = None
        self.stop_s = time.perf_counter() - t

    @contextlib.contextmanager
    def _span(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self._spans.append(Event(name, t, time.time_ns(), False))

    def span(self, name: str):
        """A harness span around a call into a layer (traced only)."""
        if self._prof is None:
            return contextlib.nullcontext()
        return self._span(name)

    def open(self, name: str):
        """A span that a later call closes (:meth:`close`)."""
        if self._prof is None:
            return None
        return (name, time.time_ns())

    def close(self, token) -> None:
        if token is not None and self._prof is not None:
            self._spans.append(Event(token[0], token[1], time.time_ns(),
                                     False))
