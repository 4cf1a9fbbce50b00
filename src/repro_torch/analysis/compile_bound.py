"""Compile-bound enumeration pass: a closed-form proof of the engine's
shape-signature bound (the port's copy of the JAX package's
``analysis/compile_bound.py``).

The serving contract bounds the shape signatures the step programs see
per placement at::

    n_buckets  +  n_chunk_shapes  +  n_step_widths  (+ verify widths)
    (prefill)     (chunked prefill)  (decode; 1, or the pow2 ladder
                                      under table-width bucketing)

The JAX package counts compiled programs (its jit cache); the port has
no jit cache, and counts the distinct shape signatures its step programs
take, what CUDA graph captures would be keyed on. This module
*enumerates* the reachable sets from the paging settings alone, by
replaying the engine's host decisions (``bucket_for``,
``chunk_schedule``, ``_table_width``).

Consumers:

  * :func:`enumerate_programs` + :func:`audit_bound`: the enumerated set
    against the documented bound;
  * :func:`predict_compile_counts` + :func:`check_engine_counts`: the
    exact counts a fault-free run over given prompt lengths reaches,
    against ``Engine.compile_counts()`` and the signatures the step
    programs really took (:func:`record_signatures`);
  * :func:`operand_audit` (RWA302): an entry-point operand that would pay
    a hidden host->device copy on every call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.analysis.report import Diagnostic, PassResult
from repro_torch.serve.paging import (bucket_for, chunk_schedule,
                                default_buckets, spec_ladder)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _width_for(hi: int, max_pages: int) -> int:
    """Mirror of ``Engine._table_width`` for ``hi`` live pages."""
    width = 1 if hi <= 1 else 1 << (hi - 1).bit_length()
    return min(width, max_pages)


@dataclasses.dataclass(frozen=True)
class ProgramInventory:
    """The reachable shape-signature set of one engine configuration.
    One compiled program per element, per placement."""
    prefill_lens: Tuple[int, ...]    # padded one-shot prefill lengths
    chunk_shapes: Tuple[int, ...]    # chunk panel widths
    step_widths: Tuple[int, ...]     # decode block-table widths
    spec_shapes: Tuple[int, ...] = ()  # verify panel widths (1 + k-ladder)

    @property
    def bound(self) -> int:
        return (len(self.prefill_lens) + len(self.chunk_shapes)
                + len(self.step_widths) + len(self.spec_shapes))


def enumerate_programs(*, max_len: int, page_size: int,
                       prefill_chunk: int = 0, min_bucket: int = 16,
                       buckets: Optional[Sequence[int]] = None,
                       table_width_bucketing: bool = False,
                       speculate_k: int = 0,
                       bucketing: bool = True) -> ProgramInventory:
    """Statically enumerate every shape signature the engine can hand
    its step programs. ``bucketing=False`` models the
    recurrent/MoE exact-length prefill archs, whose prefill set is the
    (unbounded) set of submitted lengths — represented as empty here;
    only the decode side stays provable for them. ``speculate_k``
    enumerates the verify panel widths ``1 + paging.spec_ladder(k)``
    (speculation requires a bucketing-capable arch and full-width
    tables, so the set never multiplies against the width ladder)."""
    if bucketing:
        ladder = tuple(sorted(buckets)) if buckets is not None \
            else tuple(default_buckets(max_len, min_bucket))
    else:
        ladder = ()
    chunks = tuple(b for b in ladder if prefill_chunk
                   and b <= prefill_chunk)
    max_pages = _ceil_div(max_len, page_size)
    if table_width_bucketing:
        widths = tuple(sorted({_width_for(hi, max_pages)
                               for hi in range(max_pages + 1)}))
    else:
        widths = (max_pages,)
    specs = tuple(1 + w for w in spec_ladder(speculate_k)) \
        if bucketing else ()
    return ProgramInventory(prefill_lens=ladder, chunk_shapes=chunks,
                            step_widths=widths, spec_shapes=specs)


def audit_bound(inv: ProgramInventory, *, n_buckets: int,
                n_chunk_shapes: int, max_pages: int,
                table_width_bucketing: bool = False,
                n_spec_shapes: int = 0,
                name: str = "engine") -> PassResult:
    """Check the enumeration against the documented closed form:
    ``n_buckets + n_chunk_shapes + 1 + n_spec_shapes`` programs, the +1
    decode program growing to the ``log2(max_pages)+1``-entry pow2
    width ladder under table-width bucketing, and ``n_spec_shapes``
    being the documented verify k-ladder length (DESIGN.md §7/§10)."""
    result = PassResult(name="compile-bound")
    result.checked = 4
    if len(inv.spec_shapes) != n_spec_shapes:
        result.diagnostics.append(Diagnostic(
            code="RWA301", path=name,
            message=f"{len(inv.spec_shapes)} reachable verify panel "
                    f"shapes, documented k-ladder length is "
                    f"{n_spec_shapes}"))
    if len(inv.prefill_lens) != n_buckets:
        result.diagnostics.append(Diagnostic(
            code="RWA301", path=name,
            message=f"{len(inv.prefill_lens)} reachable prefill shapes, "
                    f"documented bound is n_buckets={n_buckets}"))
    if len(inv.chunk_shapes) != n_chunk_shapes:
        result.diagnostics.append(Diagnostic(
            code="RWA301", path=name,
            message=f"{len(inv.chunk_shapes)} reachable chunk shapes, "
                    f"documented bound is {n_chunk_shapes}"))
    if table_width_bucketing:
        # ladder entries: widths 1, 2, 4, ..., capped at max_pages —
        # at most log2(max_pages) + 2 and at least 2 for max_pages > 1
        cap = (max_pages - 1).bit_length() + 2 if max_pages > 1 else 1
        ok = 1 <= len(inv.step_widths) <= cap and \
            inv.step_widths[-1] == max_pages
        if not ok:
            result.diagnostics.append(Diagnostic(
                code="RWA301", path=name,
                message=f"step-width ladder {inv.step_widths} escapes "
                        f"the log2(max_pages)+1 bound (max_pages="
                        f"{max_pages})"))
    elif inv.step_widths != (max_pages,):
        result.diagnostics.append(Diagnostic(
            code="RWA301", path=name,
            message=f"decode widths {inv.step_widths}: exactly one "
                    "program (full table width) is documented"))
    return result


def predict_compile_counts(prompt_lens: Iterable[int], *, max_len: int,
                           prefill_chunk: int = 0,
                           min_bucket: int = 16,
                           buckets: Optional[Sequence[int]] = None,
                           bucketing: bool = True,
                           decode_steps: bool = True) -> Dict[str, int]:
    """Exact per-entry-point program counts a fault-free, prefix-cache-
    free run over ``prompt_lens`` compiles: each prompt either pads to
    its bucket (one-shot prefill) or splits into ``chunk_schedule``
    panels; decode compiles one program when any decode step runs."""
    ladder = (sorted(buckets) if buckets is not None
              else default_buckets(max_len, min_bucket)) if bucketing \
        else None
    prefill, chunks = set(), set()
    for plen in prompt_lens:
        if prefill_chunk and plen > prefill_chunk:
            for _, _, shape in chunk_schedule(plen, prefill_chunk,
                                              ladder):
                chunks.add(shape)
        elif ladder is not None:
            prefill.add(bucket_for(plen, ladder))
        else:
            prefill.add(plen)
    return {"prefill": len(prefill), "chunk": len(chunks),
            "step": 1 if decode_steps else 0}


def check_engine_counts(engine, expected: Dict[str, int],
                        name: str = "engine",
                        signatures: Optional[Dict[str, set]] = None) \
        -> PassResult:
    """Match ``Engine.compile_counts()`` against a static prediction, and
    (given ``signatures``, :func:`record_signatures`' sets) against the
    shape signatures the step programs really took. Any drift means a
    shape source the enumeration does not model."""
    result = PassResult(name="compile-bound")
    actual = engine.compile_counts()
    kinds = ("prefill", "chunk", "step")
    if "spec" in expected and "spec" in actual:
        kinds += ("spec",)
    for kind in kinds:
        result.checked += 1
        if actual[kind] != expected[kind]:
            result.diagnostics.append(Diagnostic(
                code="RWA303", path=name,
                message=f"{kind}: the engine counted {actual[kind]} shape "
                        f"signature(s), the static enumeration predicts "
                        f"{expected[kind]}"))
        if signatures is not None:
            result.checked += 1
            seen = len(signatures.get(kind, ()))
            if seen != actual[kind]:
                result.diagnostics.append(Diagnostic(
                    code="RWA303", path=name,
                    message=f"{kind}: the step program took {seen} shape "
                            f"signature(s) but the engine counted "
                            f"{actual[kind]}: a hidden operand shape is "
                            "fragmenting the set"))
    return result


ENTRY_KINDS = {"_admit": "prefill", "_chunk": "chunk", "_step": "step",
               "_spec": "spec"}


def _signature(value):
    shape = getattr(value, "shape", None)
    if shape is None:
        return type(value).__name__
    return (tuple(shape), str(getattr(value, "dtype", "")))


def record_signatures(engine) -> Dict[str, set]:
    """Wrap the engine's step programs (on the instance) to keep the
    shape signature of every call: its operands' shapes and dtypes (a
    Python number counts by type: its value keys nothing) and, for the
    decode and verify steps, the block-table width they read. Returns
    the live dict of sets by kind."""
    seen: Dict[str, set] = {k: set() for k in ENTRY_KINDS.values()}
    for attr, kind in ENTRY_KINDS.items():
        fn = getattr(engine, attr)

        def wrapped(*args, _fn=fn, _kind=kind):
            sig = tuple(_signature(a) for a in args)
            if _kind in ("step", "spec"):
                sig += (tuple(engine._tables_dev.shape),)
            seen[_kind].add(sig)
            return _fn(*args)
        setattr(engine, attr, wrapped)
    return seen


def operand_audit(runs) -> PassResult:
    """RWA302 for an entry-point operand that would pay a hidden
    host->device copy on every call: a CPU tensor handed to an engine
    on a card, or a host value (a Python number, a numpy array) in a
    position the entry point does not declare host (``host``, the
    positions ``Engine.audit_entry_points`` names)."""
    import numpy as np
    import torch
    result = PassResult(name="compile-bound")
    for run in runs:
        for i, arg in enumerate(run.args):
            result.checked += 1
            where = f"operand {i} ({type(arg).__name__})"
            if isinstance(arg, torch.Tensor):
                if run.device is not None and arg.device.type == "cpu" \
                        and torch.device(run.device).type != "cpu":
                    result.diagnostics.append(Diagnostic(
                        code="RWA302", path=run.name,
                        message=f"{where} is a CPU tensor on a "
                                f"{run.device} engine: a hidden "
                                "host->device copy each call"))
            elif isinstance(arg, (int, float, bool, np.ndarray,
                                  np.generic)) and i not in run.host:
                result.diagnostics.append(Diagnostic(
                    code="RWA302", path=run.name,
                    message=f"{where} is a host value the entry point "
                            "does not declare host: pass a device "
                            "tensor"))
    return result
