"""Donation pass: prove the serving caches are updated in place.

The JAX package donates its caches to the step programs and proves
from the lowered MLIR that each donated buffer aliases an output
(``tf.aliasing_output``): when XLA drops a donation it copies the
``(R, n_pages + n_slots, ps, Hkv, hd)`` pools every step and halves the
pool a memory budget holds. The port donates nothing: its step
programs write the pools in place (``attention.write_pages``,
``write_chunk_pages``). This pass proves the same fact eagerly, from
each entry point run once (``analysis/dispatch.run_entry_points``):

  * RWA201: every cache leaf (the pools' ``k`` / ``v``, dense caches,
    recurrent state) keeps its ``data_ptr()``, shape and dtype across
    the call;
  * RWA202: no output is a fresh tensor of a pool leaf's shape (a copy
    of the pool handed back);
  * RWA203: no two leaves share storage (a write to one would clobber
    the other);
  * RWA204: a decode step allocates no tensor of a pool leaf's bytes
    or more (the recorder's largest output), and, where the peak device
    memory is read (:func:`peak_check`, on a card), grows it by less.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.analysis.dispatch import EntryRun
from repro_torch.analysis.report import Diagnostic, PassResult

# the decode step: its peak memory is held to one pool leaf
DECODE_ENTRY = "step"


def audit_runs(runs: Iterable[EntryRun]) -> PassResult:
    result = PassResult(name="donation")
    for run in runs:
        by_path = {leaf.path: leaf for leaf in run.after}
        for leaf in run.before:
            result.checked += 1
            now = by_path.get(leaf.path)
            if now is None or (now.ptr, now.shape, now.dtype) != (
                    leaf.ptr, leaf.shape, leaf.dtype):
                got = "gone" if now is None else \
                    f"{now.dtype}{list(now.shape)} at {now.ptr:#x}"
                result.diagnostics.append(Diagnostic(
                    code="RWA201", path=run.name,
                    message=f"cache leaf {leaf.path} "
                            f"({leaf.dtype}{list(leaf.shape)} at "
                            f"{leaf.ptr:#x}) is {got} after the call: "
                            "not updated in place"))
        pools = {(leaf.shape, leaf.dtype): leaf for leaf in run.before
                 if len(leaf.shape) == 5}
        storages = {leaf.storage for leaf in run.after}
        for path, out in run.outputs:
            result.checked += 1
            pool = pools.get((tuple(out.shape), out.dtype))
            if pool is not None and \
                    out.untyped_storage().data_ptr() not in storages:
                result.diagnostics.append(Diagnostic(
                    code="RWA202", path=run.name,
                    message=f"output {path} is a fresh "
                            f"{out.dtype}{list(out.shape)}, the shape of "
                            f"pool leaf {pool.path}: a copy of the pool"))
        seen = {}
        for leaf in run.after:
            result.checked += 1
            if leaf.storage in seen:
                result.diagnostics.append(Diagnostic(
                    code="RWA203", path=run.name,
                    message=f"cache leaves {seen[leaf.storage]} and "
                            f"{leaf.path} share storage"))
            seen.setdefault(leaf.storage, leaf.path)
        if run.name == DECODE_ENTRY and pools:
            result.checked += 1
            leaf_bytes = min(p.nbytes for p in pools.values())
            op, nbytes = run.recorder.largest
            if nbytes >= leaf_bytes:
                result.diagnostics.append(Diagnostic(
                    code="RWA204", path=run.name,
                    message=f"{op} allocated {nbytes:,} B in the step, a "
                            f"pool leaf is {leaf_bytes:,} B"))
    return result


def peak_check(growth: int, leaf_bytes: int, name: str = "step") \
        -> PassResult:
    """RWA204 when a decode step's peak device memory grew by a pool
    leaf's bytes or more (``torch.cuda.max_memory_allocated`` over the
    step, less the memory allocated before it). At a reduced width one
    layer's page gather is of a leaf's order, so the check is made at
    full width."""
    result = PassResult(name="donation", checked=1)
    if growth >= leaf_bytes:
        result.diagnostics.append(Diagnostic(
            code="RWA204", path=name,
            message=f"peak device memory grew by {growth:,} B over the "
                    f"step, a pool leaf is {leaf_bytes:,} B"))
    return result
