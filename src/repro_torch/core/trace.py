"""The port's trace: the kernel wrappers' launch records, host spans at
the layer boundaries, and counters, in one place.

What records, and when:

* inside :func:`recording`: each kernel call's launch record
  (:func:`note`), and the spans and counters below;
* while a ``torch.profiler`` session is active: the spans and counters.

Otherwise every hook reads two flags and returns: nothing is appended
and no counter moves. There is no other switch.

**Spans.** A span is a name, a start and an end on ``time.time_ns()``
(the clock of ``torch.profiler``'s records, so a host span lines up with
the device trace), the index of the span open around it (its parent,
-1 at the top) and its unit: an entry point (:func:`traced` with
``is_entry``) opened outside any unit starts a new one, and every span
under it carries that unit's id (None outside every unit). The port
opens spans at its entry points (``vision.swin_forward``,
``lm.prefill``), at its structure (``vision.stage`` / ``block`` /
``merge`` / ``head``, ``lm.embed`` / ``layer`` / ``unembed`` /
``states_to_cache``), inside the layers whose work is torch ops
(``mamba.conv`` / ``scan``; the dropless expert layer's ``moe.route`` /
``dispatch`` / ``experts`` / ``combine`` / ``shared``) and around each
raw kernel wrapper
(``kernel.<name>``, from entry to return: its checks, the design pick,
the output's allocation and the launch). A span's self time, its length
less its children's, is the host time of its own layer: its work, or a
wait on the card. At most :data:`LIMIT` spans are kept; the rest are counted under
``trace.dropped_spans``.

**Counters**, moved by :func:`note` and :func:`count`:

* ``launch.<kernel>.<design>``: each wrapper call that launches on the
  card, and each shape-only call on ``meta`` tensors (the dry run's,
  which takes the card's path); a CPU tensor's plain version counts
  nothing;
* ``launch.masked_operand``: matmul launches whose operand TMA cannot
  take, which the wgmma design then loads by masked copies
  (``rowwise_matmul.tma_masked``);
* ``moe.rows_routed`` (tokens x top-k), ``moe.rows_held`` (the rows the
  held experts computed) and ``moe.expert_calls`` (the matmul calls they
  made), by the dropless expert layer.

:func:`take` hands over the spans and counters and clears them.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler

# spans kept between two calls of take()
LIMIT = 1 << 17
MASKED = "launch.masked_operand"
DROPPED = "trace.dropped_spans"

# The launch records (``launch/roofline.py``): None outside
# :func:`recording`; inside it, a list to which :func:`note` appends one
# record a kernel call.
records: Optional[list] = None
# How deep the calls are in a wrapper's plain version (:func:`plain_call`):
# the op walk (``launch/op_cost.py``) prices the call by its record and
# leaves the plain version's ATen ops out of the glue.
plain_depth = 0

# each span as [name, start, end, parent, unit] (end None while open)
_spans: List[list] = []
_counters: Dict[str, int] = {}
_units = 0
# each thread's open spans, innermost last, as (record, index)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start: int              # ns since the epoch
    end: int
    parent: int             # index of the enclosing span, -1 at the top
    unit: Optional[int]     # the entry call's id, None outside one


def active() -> bool:
    """Whether the trace records: inside :func:`recording` or while a
    ``torch.profiler`` session is active."""
    return records is not None or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record every kernel call in the block: yields the list of
    records, each ``{"kernel", "design", "launched", "tensors": {name:
    (shape, dtype)}, **options}``. Spans and counters record too."""
    global records
    prev, records = records, []
    try:
        yield records
    finally:
        records = prev


@contextlib.contextmanager
def plain_call():
    """Mark the block as a wrapper's plain version, run for a CPU tensor
    in place of the kernel."""
    global plain_depth
    plain_depth += 1
    try:
        yield
    finally:
        plain_depth -= 1


def note(kernel: str, design: str, tensors: dict, device, *,
         masked: bool = False, **options) -> None:
    """The hook of one kernel call on ``device`` (its output's): the
    record, inside :func:`recording`, with the shape and dtype of each
    tensor operand (the output included) and the scalar options,
    ``launched`` True on the card alone; and while the trace records,
    the launch counters of a call on the card or on ``meta`` (``masked``:
    an operand loaded by masked copies). A CPU call is noted with the
    design the card would take."""
    if records is not None:
        records.append({
            "kernel": kernel, "design": design,
            "launched": device.type == "cuda",
            "tensors": {name: (tuple(t.shape), t.dtype)
                        for name, t in tensors.items() if t is not None},
            **options})
    elif not _profiler._is_profiler_enabled:
        return
    if device.type != "cpu":
        key = f"launch.{kernel}.{design}"
        _counters[key] = _counters.get(key, 0) + 1
        if masked:
            _counters[MASKED] = _counters.get(MASKED, 0) + 1


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while the trace records (as
    :func:`note` moves the launch counters)."""
    if records is None and not _profiler._is_profiler_enabled:
        return
    _counters[name] = _counters.get(name, 0) + int(n)


def _open(name: str, entry: bool) -> list:
    global _units
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent, idx = stack[-1] if stack else (None, -1)
    unit = None if parent is None else parent[4]
    if entry and unit is None:
        _units += 1
        unit = _units
    rec = [name, 0, None, idx, unit]
    if len(_spans) < LIMIT:
        stack.append((rec, len(_spans)))
        _spans.append(rec)
    else:
        stack.append((rec, -1))
        _counters[DROPPED] = _counters.get(DROPPED, 0) + 1
    rec[1] = time.time_ns()
    return rec


def _close(rec: list) -> None:
    rec[2] = time.time_ns()
    _local.stack.pop()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _open(self.name, False)

    def __exit__(self, *exc):
        _close(self.rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span around the block (a no-op unless the trace records)."""
    if records is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def traced(name: str, is_entry: bool = False):
    """Decorator: each call is a span ``name``; with ``is_entry``, an
    entry point's, which outside any unit starts a unit of its own."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if records is None and not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            rec = _open(name, is_entry)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(rec)
        return call
    return wrap


def launches(kernel: Optional[str] = None) -> int:
    """The launches counted (``launch.<kernel>.<design>``, every
    design) of ``kernel``, or of every kernel."""
    if kernel is not None:
        prefix = f"launch.{kernel}."
        return sum(n for k, n in _counters.items() if k.startswith(prefix))
    return sum(n for k, n in _counters.items()
               if k.startswith("launch.") and k.count(".") == 2)


def take() -> Tuple[List[Span], Dict[str, int]]:
    """The spans and counters recorded since the last take, which are
    cleared. Called with no span open on this thread."""
    global _spans, _counters
    if getattr(_local, "stack", None):
        raise RuntimeError("trace.take inside an open span")
    spans = [Span(*r) for r in _spans]
    counters = _counters
    _spans, _counters = [], {}
    return spans, counters
