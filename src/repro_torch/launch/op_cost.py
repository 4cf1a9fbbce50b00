"""The op-level cost walk: FLOPs, bytes and collective bytes of every op
of one call, the kernels' and the glue's apart. The port's counterpart of
the JAX package's ``launch/hlo_cost.py`` and of its dry-run profile,
``launch/profile.py::per_op_breakdown``.

The JAX package walks the compiled HLO. The port has none: it runs the
call once under a ``TorchDispatchMode`` (the machinery of
``analysis/dispatch.py``) that sees every ATen op the call dispatches,
on any device (``cuda``, ``cpu``, or ``meta`` for the dry run), and the
kernel wrappers' launch records (``trace.recording``). It keeps the
fields of JAX's ``HLOCost``:

  * ``flops`` — JAX's HLO convention: every dot product counted
    2 x M x N x K, nothing else. A glue op's FLOPs come from
    ``torch.utils.flop_counter``'s registered formulas (mm, bmm, addmm,
    convolutions, SDPA); a kernel launch's from its record
    (:func:`plain_flops`): the FLOPs of the dots its plain version runs
    (a matmul 2MNK, attention's two products over the whole Sq x Skv, a
    norm none, WKV and SSD their chunked scans'), which are the dots
    JAX's HLO of the same call holds;
  * ``bytes`` — the HLO traffic model: each op's operand bytes plus its
    result bytes (a broadcast operand at its real size; an op writing
    in place its written bytes once). Ops that only change metadata are
    free (views, ``t``, ``permute``, ``expand``, ``detach``, ``empty``:
    the counterpart of ``_FREE_OPS``). A kernel launch counts its least
    bytes (each operand read once, the output written once:
    ``roofline.price``);
  * ``coll_bytes`` — by JAX's collective kinds, from the counted
    collectives of ``core/partitioning.py`` (``byte_counts`` before and
    after the call, through ``roofline.collective_bytes``);
  * ``attn_internal_bytes`` — the score traffic an unfused attention
    would move: each launch's fp32 score matrix, over its
    ``attention_pairs``, written once and read back. JAX measures the
    same by tagging the softmax scope's HLO; the port's kernel keeps it
    on chip, so it is the difference between the fused and the unfused
    memory terms (``roofline.analyze``).

On the CPU a wrapper runs its plain version as ATen ops: they are the
kernel's (``trace.plain_call``), priced by its record, and left out of
the glue. On the card a launch makes no ATen op; on ``meta`` the wrapper
returns an empty output. So the three devices give one walk of one call.

Beside those fields, the walk keeps the glue apart (``glue_*``: FLOPs,
bytes and the serial bound, each op at ``roofline.bound``; the launches
are priced from ``records`` by ``roofline.analyze``), the totals by ATen
op and by kernel design (:func:`per_op_breakdown`) and the peak bytes
of the intermediates alive at once (``temp_bytes``: fresh outputs
counted as they are made, and taken off as their storage is freed).

    PYTHONPATH=src python -m repro_torch.launch.op_cost --arch deepseek-7b \\
        --shape train_4k [--mesh pod|multipod] [--rules k=v,...] [--top 15]

walks one dry-run cell (``launch/dryrun.py``: this rank of a fake world
on ``meta`` tensors, on the CPU, no card) and prints its bytes and FLOPs
by op and its heaviest sites.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import trace
from repro_torch.launch import roofline

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
# ops that make or change no element: an allocation without a fill, a
# read of a host scalar, metadata
FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view",
    "_reshape_alias", "_local_scalar_dense", "resize_", "set_",
    "_has_compatible_shallow_copy_type", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "record_stream"})
# in-place ops that write their first operand without reading it
WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_",
                        "random_", "bernoulli_", "exponential_"})
# in-place ops that write only the given values' positions of their
# first operand (HLO's scatter / dynamic-update-slice: the slice twice)
SCATTERS = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                      "scatter_", "scatter_add_", "index_add_",
                      "masked_scatter_", "index_fill_"})
# the namespaces of the collectives: priced by their counted wrappers
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional")
# the bytes of one fp32 attention score
_SCORE_BYTES = 4


def _peak_name(dtype: torch.dtype) -> str:
    """The peak (``roofline.PEAK_FLOPS``) an op in ``dtype`` runs at."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype.is_floating_point or dtype.is_complex:
        return "fp32"
    return "int8"


def _unique_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements a read of ``t`` touches: a broadcast
    (stride 0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def plain_flops(record: dict) -> int:
    """The FLOPs of the dot products a launch's plain version runs, in
    the HLO convention (2 x M x N x K a product): what JAX's HLO of the
    same call counts, and what ``torch.utils.flop_counter`` counts over
    the plain version on the CPU."""
    t, kernel = record["tensors"], record["kernel"]
    if kernel == "rowwise_matmul":
        x, n = t["x"][0], t["w"][0][1]
        return 2 * math.prod(x[:-1]) * x[-1] * n * (2 if "w_gate" in t
                                                   else 1)
    if kernel == "flash_attention":
        b, hq, sq, hd = t["q"][0]
        return 4 * b * hq * sq * t["k"][0][2] * hd
    if kernel == "layernorm":
        return 0
    if kernel == "wkv":
        # models/rwkv6.wkv_chunked: per chunk of L tokens (the last
        # padded), A and A @ v (2 L^2 P each), rd @ S and the state
        # update (2 L P^2 each), the bonus term (2 L P)
        b, s, h, p = t["r"][0]
        ln = min(16, s)
        return -(-s // ln) * b * h * (4 * ln * ln * p + 4 * ln * p * p
                                      + 2 * ln * p) if s else 0
    if kernel == "ssd":
        # ssd.ssd_plain: per chunk of L tokens (the last padded), C B^T
        # (2 L^2 N) for the cb launch; the intra product (2 L^2 H P), the
        # inter term and the state update (2 L H P N each) for the scan
        b, s, n = t["B"][0]
        ln = record["chunk"]
        per = (2 * ln * ln * n if record["design"] == "cb" else
               2 * ln * t["x"][0][2] * t["x"][0][3] * (ln + 2 * n))
        return -(-s // ln) * b * per
    raise ValueError(f"no plain FLOPs for kernel {kernel!r}")


def score_bytes(record: dict) -> int:
    """An unfused attention's score traffic for one launch: the fp32
    scores of its (query, key) pairs, written once and read back."""
    if record["kernel"] != "flash_attention":
        return 0
    t = record["tensors"]
    b, hq, sq, _ = t["q"][0]
    pairs = roofline.attention_pairs(sq, t["k"][0][2],
                                     causal=record["causal"],
                                     window=record["window"],
                                     q_offset=record["q_offset"])
    return 2 * b * hq * pairs * _SCORE_BYTES


@dataclasses.dataclass
class OpCost:
    """The cost of one walked call (the fields of JAX's ``HLOCost``, and
    the glue apart: the launches' own terms are their records')."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    attn_internal_bytes: float = 0.0
    glue_flops: float = 0.0
    glue_bytes: float = 0.0
    glue_ms: float = 0.0            # the glue ops' bounds, summed
    glue_compute_s: float = 0.0     # their FLOPs at their peaks
    glue_ops: int = 0
    temp_bytes: int = 0             # peak of the call's live outputs
    # the launch records (``roofline.analyze`` prices them)
    records: List[dict] = dataclasses.field(default_factory=list)
    # by ATen op ('aten.mm') or kernel design ('kernel rowwise_matmul
    # persistent'): [bytes, flops, calls]
    by_op: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0.0, 0.0, 0]))
    # by site (op, operand shapes and dtypes): [bytes, flops, calls]
    sites: Dict[Tuple[str, str], List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0.0, 0.0, 0]))

    _SCALED = ("flops", "bytes", "attn_internal_bytes", "glue_flops",
               "glue_bytes", "glue_ms", "glue_compute_s")

    def scaled(self, k: float) -> "OpCost":
        """The cost of ``k`` runs of the call (``HLOCost.scaled``, a
        while-loop's trip count). Nothing in the port calls it: the walk
        runs every iteration of a loop, so no count needs scaling."""
        out = OpCost(coll_bytes={n: v * k for n, v in
                                 self.coll_bytes.items()},
                     glue_ops=int(self.glue_ops * k),
                     temp_bytes=self.temp_bytes,
                     records=self.records * int(k) if k == int(k) else [])
        for name in self._SCALED:
            setattr(out, name, getattr(self, name) * k)
        for src, dst in ((self.by_op, out.by_op), (self.sites, out.sites)):
            for key, (b, f, n) in src.items():
                dst[key] = [b * k, f * k, int(n * k)]
        return out

    def add(self, o: "OpCost") -> None:
        """Add ``o``'s cost in place (``HLOCost.add``). Nothing in the
        port calls it: one walk covers one whole call."""
        for name in self._SCALED:
            setattr(self, name, getattr(self, name) + getattr(o, name))
        for n, v in o.coll_bytes.items():
            self.coll_bytes[n] = self.coll_bytes.get(n, 0.0) + v
        self.glue_ops += o.glue_ops
        self.records += o.records
        self.temp_bytes = max(self.temp_bytes, o.temp_bytes)
        for src, dst in ((o.by_op, self.by_op), (o.sites, self.sites)):
            for key, (b, f, n) in src.items():
                e = dst[key]
                e[0] += b
                e[1] += f
                e[2] += n


class OpWalk(TorchDispatchMode):
    """``with OpWalk() as w: fn(...)``, then ``w.cost``: every ATen op
    of the block priced, every kernel launch (record) priced once."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._live = 0
        self._seen: Dict[int, int] = {}
        self._rec_ctx = None
        self.records: List[dict] = []
        self._coll0: Dict[str, int] = {}

    # -- entering and leaving -------------------------------------------

    def __enter__(self):
        from repro_torch.core import partitioning
        self._coll0 = partitioning.byte_counts()
        self._rec_ctx = trace.recording()
        self.records = self._rec_ctx.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.core import partitioning
        out = super().__exit__(*exc)
        self._rec_ctx.__exit__(*exc)
        after = partitioning.byte_counts()
        for kind, v in roofline.collective_bytes(
                {k: after[k] - self._coll0.get(k, 0) for k in after}).items():
            self.cost.coll_bytes[kind] += v
        for r in self.records:
            self._price_record(r)
        self.cost.records = list(self.records)
        return out

    # -- memory ---------------------------------------------------------

    def _freed(self, key: int, nbytes: int) -> None:
        if self._seen.pop(key, None) is not None:
            self._live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[key] = nbytes
            self._live += nbytes
            weakref.finalize(st, self._freed, key, nbytes)
        self.cost.temp_bytes = max(self.cost.temp_bytes, self._live)

    # -- pricing --------------------------------------------------------

    def _price_record(self, r: dict) -> None:
        """A launch's share of the totals: its plain FLOPs and its least
        bytes (its bound is ``roofline.analyze``'s)."""
        nbytes = roofline.price(r)[1]
        fl = plain_flops(r)
        c = self.cost
        c.flops += fl
        c.bytes += nbytes
        c.attn_internal_bytes += score_bytes(r)
        e = c.by_op[f"kernel {r['kernel']} {r['design']}"]
        e[0] += nbytes
        e[1] += fl
        e[2] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        returns = schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if len(returns) == 1 and isinstance(out, (tuple, list)):
            rets = returns * len(outs)          # a Tensor[] return
        else:
            rets = returns
        fresh = [t for t, ret in zip(outs, rets)
                 if isinstance(t, torch.Tensor) and ret.alias_info is None]
        if fresh:
            self._track(fresh)
        name = func.overloadpacket.__name__
        if (trace.plain_depth or name in FREE_OPS
                or func.namespace in _COLLECTIVE_NS):
            return out
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in returns):
            return out                    # a view
        self._price_op(func, name, schema, args, kwargs, out, fresh)
        return out

    def _price_op(self, func, name, schema, args, kwargs, out, fresh):
        # the operands by their schema arguments: which are written
        written, read = [], []
        for i, a in enumerate(args):
            arg = schema.arguments[i] if i < len(schema.arguments) else None
            w = arg is not None and arg.alias_info is not None and \
                arg.alias_info.is_write
            (written if w else read).extend(_tensors(a))
        for key, a in kwargs.items():
            arg = next((x for x in schema.arguments if x.name == key), None)
            w = arg is not None and arg.alias_info is not None and \
                arg.alias_info.is_write
            (written if w else read).extend(_tensors(a))
        out_variant = func._overloadname.endswith("out")
        if name in SCATTERS:
            # the values written (and read), the indices read
            moved = sum(_unique_bytes(t) for t in read)
            vals = [t for t in read if t.is_floating_point()]
            nbytes = moved + sum(_unique_bytes(t) for t in vals)
        elif name in WRITE_ONLY or out_variant:
            nbytes = (sum(_unique_bytes(t) for t in read)
                      + sum(_unique_bytes(t) for t in written))
        else:
            # read-modify-write in place: its operand read and written
            nbytes = (sum(_unique_bytes(t) for t in read + written)
                      + sum(_unique_bytes(t) for t in written)
                      + sum(_unique_bytes(t) for t in fresh))
        fl = 0
        counter = flop_registry.get(func.overloadpacket)
        if counter is not None:
            fl = int(counter(*args, **kwargs, out_val=out))
        ref = next((t for t in read + written + fresh
                    if t.is_floating_point()), None)
        dt = _peak_name(ref.dtype) if ref is not None else "int8"
        ms, _ = roofline.bound(fl, nbytes, dt)
        c = self.cost
        c.glue_ops += 1
        c.glue_flops += fl
        c.glue_bytes += nbytes
        c.glue_ms += ms
        c.glue_compute_s += fl / roofline.PEAK_FLOPS[dt]
        c.flops += fl
        c.bytes += nbytes
        e = c.by_op[f"aten.{name}"]
        e[0] += nbytes
        e[1] += fl
        e[2] += 1
        sig = ", ".join(f"{tuple(t.shape)}{str(t.dtype)[6:]}"
                        for t in (read + written)[:3])
        e = c.sites[(f"aten.{name}", sig)]
        e[0] += nbytes
        e[1] += fl
        e[2] += 1


def walk(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its OpCost)``."""
    with OpWalk() as w:
        out = fn(*args, **kwargs)
    return out, w.cost


def per_op_breakdown(cost: OpCost):
    """-> (by_op {op: [bytes, flops]}, rows [(bytes, calls, op, shapes,
    '')] of the heaviest sites, heaviest first): JAX's
    ``profile.per_op_breakdown`` over the walk. A kernel design is one
    op ('kernel rowwise_matmul persistent') and one site."""
    by_op = {op: [b, f] for op, (b, f, _n) in cost.by_op.items()}
    rows = [(b, n, op, sig, "") for (op, sig), (b, _f, n)
            in cost.sites.items()]
    rows += [(b, n, op, "(launch records)", "")
             for op, (b, _f, n) in cost.by_op.items()
             if op.startswith("kernel ")]
    rows.sort(key=lambda r: -r[0])
    return by_op, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.op_cost")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--rules", default="")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun

    result = dryrun.run_cell(args.arch, args.shape,
                             multi_pod=args.mesh == "multipod",
                             rules_override=dryrun._rules(args.rules) or None,
                             rank=args.rank, verbose=False,
                             keep_cost=True)
    by_op, rows = per_op_breakdown(result["cost"])
    print(f"== per-op traffic ({args.arch} x {args.shape}, {args.mesh}, "
          f"rank {args.rank}) ==")
    for op, (byt, fl) in sorted(by_op.items(), key=lambda kv: -kv[1][0]):
        print(f"  {op:34s} {byt / 1e9:10.1f} GB   {fl / 1e12:8.2f} TFLOP")
    print(f"== top {args.top} sites ==")
    for byt, mult, op, shp, _ in rows[:args.top]:
        print(f"  {byt / 1e9:8.1f}GB x{mult:5d} {op:24s} {shp[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
