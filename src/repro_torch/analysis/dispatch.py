"""The dispatch recorder: what a call really ran, op by op, the port's
counterpart of the JAX package's ``analysis/jaxprs.py``.

JAX audits a traced jaxpr; the port has none, so it runs the call once
under a ``TorchDispatchMode`` that sees every ATen op the call
dispatches, on any device, and keeps:

  * ``ops``: a count of each op by name (``aten.cat``,
    ``aten._local_scalar_dense``, ...);
  * ``host_reads``: the ops that make the host wait for the device: a
    scalar read (``aten._local_scalar_dense``: ``.item()``, ``int()`` /
    ``float()`` / ``bool()`` of a tensor), a copy from a device tensor
    to the CPU, an op whose output shape depends on the data
    (``nonzero``, ``masked_select``, ``unique``, ...: on a card the
    host waits for the count), and a blocking copy from the CPU to the
    device (pinned, non-blocking copies do not wait). On the CPU the
    device copies cannot occur, and the other reads are recorded all
    the same: they are the ones that would wait on a card;
  * ``concats``: every ``cat`` / ``stack`` output, its bytes (for
    :func:`weight_concat`); ``largest``: the biggest output of any op
    (a fresh allocation: a copy of a cache pool would show there).

Every device read the serving engine makes goes through ``Engine._fetch``
outside the entry points, so a recorder around an entry point must see
no host read.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tree as tree_lib

# ops whose output shape depends on the data: on a card the host must
# read the count back before it can allocate the output
DATA_DEPENDENT = frozenset({
    "nonzero", "nonzero_numpy", "masked_select", "unique_dim",
    "_unique", "_unique2", "unique_consecutive", "repeat_interleave",
    "bincount", "histc", "equal", "is_nonzero",
})
_CONCATS = frozenset({"cat", "concat", "concatenate", "stack", "hstack",
                      "vstack"})


def _name(func) -> str:
    return getattr(func, "__name__", str(func)).split(".")[0]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Recorder(TorchDispatchMode):
    """``with Recorder() as rec:`` around a call; then ``rec.ops``,
    ``rec.host_reads``, ``rec.concats``."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.host_reads: List[str] = []
        self.concats: List[Tuple[str, int]] = []
        self.largest: Tuple[str, int] = ("", 0)   # the biggest output

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func.overloadpacket)
        self.ops[f"aten.{name}"] += 1
        out = func(*args, **kwargs)
        self._observe(name, func, args, kwargs, out)
        outs = [t for t in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(t, torch.Tensor)]
        if outs:
            # a fresh allocation: an output whose storage no input holds
            # (a view, or an op writing in place, allocates nothing)
            held = {_storage(a) for a in list(args) + list(kwargs.values())
                    if isinstance(a, torch.Tensor)}
            for t in outs:
                size = t.untyped_storage().nbytes()
                if _storage(t) not in held and size > self.largest[1]:
                    self.largest = (f"aten.{name}", size)
        return out

    def _observe(self, name, func, args, kwargs, out):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if name == "_local_scalar_dense":
            self.host_reads.append("aten._local_scalar_dense (a scalar "
                                   "read)")
            return
        if name in DATA_DEPENDENT:
            if name == "repeat_interleave" and kwargs.get(
                    "output_size") is not None:
                return
            self.host_reads.append(f"aten.{name} (a data-dependent shape)")
            return
        if name in ("_to_copy", "copy_", "to", "_copy_from",
                    "_copy_from_and_resize"):
            src = tensors[1] if name == "copy_" and len(tensors) > 1 \
                else (tensors[0] if tensors else None)
            dst = tensors[0] if name == "copy_" else (
                out if isinstance(out, torch.Tensor) else None)
            if src is None or dst is None:
                return
            non_blocking = bool(kwargs.get("non_blocking", False) or (
                name == "copy_" and len(args) > 2 and args[2]))
            if src.device.type == "cuda" and dst.device.type == "cpu":
                self.host_reads.append(f"aten.{name} (device->host)")
            elif src.device.type == "cpu" and dst.device.type == "cuda" \
                    and not (non_blocking and src.is_pinned()):
                self.host_reads.append(f"aten.{name} (a blocking "
                                       "host->device copy)")
            return
        if name in _CONCATS and isinstance(out, torch.Tensor):
            self.concats.append((f"aten.{name}", _nbytes(out)))


def count_op(recorder: Recorder, name: str) -> int:
    """How many times the recorded call dispatched ``aten.<name>``."""
    return recorder.ops.get(name if name.startswith("aten.")
                            else f"aten.{name}", 0)


def weight_concat(recorder: Recorder, min_bytes: int) -> List[Tuple[str,
                                                                    int]]:
    """The ``cat`` / ``stack`` outputs of at least ``min_bytes``: in a
    decode call these are weight-panel rebuilds the fused param layout
    exists to remove."""
    return [(n, b) for n, b in recorder.concats if b >= min_bytes]


def min_weight_bytes(cfg, itemsize: int = 4) -> int:
    """Threshold separating weight-panel concats from small activation
    concats: the smallest per-layer projection panel (KV heads)."""
    return cfg.d_model * cfg.n_kv_heads * cfg.head_dim * itemsize


# ----------------------------------------------------------------------
# The serving entry points, each run once under the recorder
# ----------------------------------------------------------------------


def tensor_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a tree (``core/tree.py``), with its path."""
    return [(p or ".", t) for p, t in tree_lib.leaves_with_paths(tree)
            if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Leaf:
    path: str
    ptr: int
    storage: int
    shape: tuple
    dtype: torch.dtype
    nbytes: int


def leaf_info(tree) -> List[Leaf]:
    return [Leaf(p, t.data_ptr(), t.untyped_storage().data_ptr(),
                 tuple(t.shape), t.dtype, _nbytes(t))
            for p, t in tensor_leaves(tree)]


@dataclasses.dataclass
class EntryRun:
    """One entry point's audited call: what the recorder saw (its host
    reads include the warm-up call's), the cache leaves before and
    after, the outputs, and on a card the sync debug mode's verdict over
    both calls and the peak memory the audited call added."""
    name: str
    args: tuple
    host: tuple
    recorder: Recorder
    before: List[Leaf]
    after: List[Leaf]
    outputs: List[Tuple[str, torch.Tensor]]
    debug_syncs: Optional[int] = None     # None: not on a card
    peak_growth: Optional[int] = None     # bytes, on a card
    device: Any = None


def run_entry_points(engine, entries=None) -> List[EntryRun]:
    """Run each of ``engine.audit_entry_points()`` twice under a
    :class:`Recorder`: a warm-up call (a wrapper's first launch grows
    its workspace once) and the audited call; on a card both under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising call
    raises inside it), and the peak memory the audited call added. The
    engine's step state is restored after."""
    entries = entries if entries is not None else \
        engine.audit_entry_points()
    saved = engine.audit_state()
    dev = torch.device(engine.device)
    cuda = dev.type == "cuda"
    runs = []

    def call(fn, args):
        """(recorder, outputs, synchronising calls) of one call."""
        syncs = None
        if cuda:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            syncs = 0
        with Recorder() as rec:
            try:
                out = fn(*args)
            except RuntimeError as e:
                if not (cuda and "synchroniz" in str(e)):
                    raise
                syncs, out = 1, ()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
        return rec, out, syncs

    try:
        for name, fn, args, host in entries:
            warm, _, warm_syncs = call(fn, args)
            before = leaf_info(engine.cache)
            peak = None
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            rec, out, syncs = call(fn, args)
            if cuda:
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) - base
                syncs += warm_syncs
            rec.host_reads = warm.host_reads + rec.host_reads
            runs.append(EntryRun(
                name=name, args=args, host=host, recorder=rec,
                before=before, after=leaf_info(engine.cache),
                outputs=tensor_leaves(out), debug_syncs=syncs,
                peak_growth=peak, device=dev))
    finally:
        engine.restore_audit_state(saved)
    return runs
