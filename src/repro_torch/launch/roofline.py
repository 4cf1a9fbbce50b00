"""Roofline of the port on the H100, from the kernels' launch records.

The JAX package reads its roofline terms from a compiled dry-run module
(``cost_analysis`` and the HLO text). The port has no HLO: each kernel
wrapper counts its launches, and behind a recording switch
(:func:`recording`, ``kernels/_build.py``) it also keeps each launch's
shapes and dtypes. :func:`price` turns a record into the operations the
launch does and the least bytes it must move (each operand read once,
the output written once), and :func:`bound` into the least time the
card could take for it:

  compute term    = operations / the dtype's peak     (67 / 989 / 1979 T/s)
  memory term     = bytes / 3.35 TB/s
  collective term = collective bytes / 450 GB/s NVLink

:func:`bound` is the one definition of a kernel's bound in the repo;
``chip_smoke.py`` imports it. The peaks are the H100 SXM data sheet's
(``core/rowwise.H100``), not measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch deepseek-7b \\
        --batch 4 --seq 512 --dtype bf16 [--layers N] [--device cuda]

runs one prefill and one decode step of the arch (random weights from
``--seed``) under the op walk (``launch/op_cost.py``) and prints each
kernel's launches, operations, bytes and bound, the glue's bytes and
bound, and the call's roofline. It runs on the card unless given
``--device cpu``, where the wrappers take their plain versions and the
records are of the plain calls (noted ``launched`` False, with the
design the card would take), or ``--device meta``: shapes alone, every
call routed as on the card (the dry walk).

A whole call (:func:`analyze`, from the op walk) adds the glue between
the launches. Where its terms differ from the JAX package's, it is
because the port has launch records where JAX has fused HLO:
``flops_per_device`` is the walk's, in JAX's convention (dot products
alone; a launch's the dots its plain version runs, attention's over the
whole Sq x Skv), while ``compute_t`` prices what runs (each launch's
operations, attention's unmasked pairs and a norm's 7 an element, and
each glue op's FLOPs, each at its dtype's peak); ``memory_t`` (unfused)
adds to the launches' least bytes and the glue's the score traffic an
unfused attention moves (``attn_internal_bytes``), and
``memory_t_fused`` leaves it out (JAX adds ``flash_min_bytes`` in place
of the tagged softmax scope: the records already hold the kernel's
least bytes); ``collective_t`` is on NVLink; the MFU terms take the
call dtype's peak. :attr:`RooflineReport.call_bound_ms` is the serial
bound, each launch and glue op one after another.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rowwise import H100, dtype_name

PEAK_FLOPS = {"fp32": H100.peak_fp32, "bf16": H100.peak_bf16,
              "int8": H100.peak_int8}
PEAK_BYTES = H100.hbm_bw
NVLINK_BYTES = H100.nvlink_bw


def bound(flops: float, nbytes: float, dtype) -> Tuple[float, str]:
    """The least time, in ms, the card takes for ``flops`` operations of
    ``dtype`` ('fp32' / 'bf16' / 'int8' or a torch dtype) that move
    ``nbytes``: the larger of the two times, and which one bounds
    ('operations' or 'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def recording():
    """Record every kernel launch in the block (``with recording() as
    records:``); each record is priced by :func:`price`."""
    from repro_torch.kernels import _build
    return _build.recording()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _nbytes(entry) -> int:
    shape, dtype = entry
    return _numel(shape) * (torch.finfo(dtype).bits if dtype.is_floating_point
                            else torch.iinfo(dtype).bits) // 8


def attention_pairs(sq: int, skv: int, *, causal: bool, window: int = 0,
                    q_offset: int = 0) -> int:
    """The (query, key) pairs an attention call scores: query row i sits
    at position ``q_offset + i``; causal keeps keys at or before it, a
    window the last ``window`` of those (keys after ``pos - window``)."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq,
                                                                 np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def price(record: dict) -> Tuple[int, int, str]:
    """(operations, least bytes, dtype name) of one launch record."""
    t = record["tensors"]
    kernel = record["kernel"]
    nbytes = sum(_nbytes(e) for e in t.values())
    if kernel == "rowwise_matmul":
        (m, k), n = t["x"][0], t["w"][0][1]
        flops = 2 * m * n * k * (2 if "w_gate" in t else 1)
        dt = dtype_name(t["x"][1])
    elif kernel == "flash_attention":
        b, hq, sq, hd = t["q"][0]
        skv = t["k"][0][2]
        pairs = attention_pairs(sq, skv, causal=record["causal"],
                                window=record["window"],
                                q_offset=record["q_offset"])
        flops = 4 * b * hq * hd * pairs
        dt = dtype_name(t["q"][1])
    elif kernel == "layernorm":
        m, d = t["x"][0]
        flops = 7 * m * d
        dt = dtype_name(t["x"][1])
    elif kernel == "wkv":
        b, s, h, p = t["r"][0]
        # per chunk of n real tokens: A and A @ v (2 n^2 P each), rd @ S
        # and the state update (2 n P^2 each)
        chunks = [min(16, s - t0) for t0 in range(0, s, 16)]
        flops = b * h * sum(4 * n * p * (n + p) for n in chunks)
        dt = dtype_name(t["r"][1])
    else:
        raise ValueError(f"no pricing for kernel {kernel!r}")
    return flops, nbytes, dt


@dataclasses.dataclass
class Priced:
    kernel: str
    design: str
    dtype: str
    flops: int
    nbytes: int
    bound_ms: float
    bound_by: str


def price_all(records: Iterable[dict]) -> List[Priced]:
    out = []
    for r in records:
        flops, nb, dt = price(r)
        ms, by = bound(flops, nb, dt)
        out.append(Priced(r["kernel"], r["design"], dt, flops, nb, ms, by))
    return out


def collective_bytes(byte_counts: Optional[Dict[str, int]] = None) \
        -> Dict[str, int]:
    """Bytes by collective kind from the counted collectives of
    ``core/partitioning.py`` (``byte_counts()``, the output bytes of each
    call), in the JAX package's kinds: the TP hooks' all-reduce and
    tiled all-gather fold into theirs."""
    if byte_counts is None:
        from repro_torch.core import partitioning
        byte_counts = partitioning.byte_counts()
    out = {"all-gather": byte_counts.get("all_gather", 0)
           + byte_counts.get("tp_gather", 0),
           "all-reduce": byte_counts.get("all_reduce", 0)
           + byte_counts.get("tp_reduce", 0),
           "reduce-scatter": byte_counts.get("reduce_scatter", 0),
           "all-to-all": byte_counts.get("all_to_all", 0),
           "collective-permute": 0}
    return out


@dataclasses.dataclass
class RooflineReport:
    """The roofline of one call (a prefill, a decode step, a train step)
    from its launch records, and, from the op walk (:func:`analyze`),
    the glue between them. The launches and the glue ops run one after
    another on a stream, so the call's serial bound (:attr:`call_bound_ms`)
    is the sum of their bounds, and the collectives (synchronous on the
    stream) add theirs. The JAX package's terms are kept beside it:
    :attr:`step_time` is the largest of the three engines' totals."""

    arch: str
    shape: str
    launches: List[Priced]
    coll_bytes: Dict[str, int]
    # the op walk of the call (``launch/op_cost.OpCost``); None in a
    # report of launches alone
    cost: Optional[object] = None
    mesh: str = ""
    chips: int = 1
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS["bf16"]

    @property
    def flops(self) -> int:
        """The operations the launches do."""
        return sum(p.flops for p in self.launches)

    @property
    def nbytes(self) -> int:
        """The launches' least bytes."""
        return sum(p.nbytes for p in self.launches)

    def _walk(self, name: str) -> float:
        return getattr(self.cost, name) if self.cost is not None else 0.0

    @property
    def glue_flops(self) -> float:
        return self._walk("glue_flops")

    @property
    def glue_bytes(self) -> float:
        return self._walk("glue_bytes")

    @property
    def glue_ms(self) -> float:
        """The glue ops' bounds, summed."""
        return self._walk("glue_ms")

    @property
    def attn_internal_bytes(self) -> float:
        return self._walk("attn_internal_bytes")

    @property
    def flops_per_device(self) -> float:
        """The walk's FLOPs, JAX's convention (the launches' operations
        in a report of launches alone)."""
        return self.cost.flops if self.cost is not None else self.flops

    @property
    def bytes_per_device(self) -> float:
        """Unfused: the launches' and the glue's bytes and the score
        traffic the fused attention keeps on chip."""
        return self.nbytes + self.glue_bytes + self.attn_internal_bytes

    @property
    def compute_t(self) -> float:
        """Seconds at the peaks, each launch and glue op at its dtype's."""
        return (sum(p.flops / PEAK_FLOPS[p.dtype] for p in self.launches)
                + self._walk("glue_compute_s"))

    @property
    def memory_t(self) -> float:
        """Unfused (JAX's ``memory_t``): :attr:`bytes_per_device`."""
        return self.bytes_per_device / PEAK_BYTES

    @property
    def memory_t_fused(self) -> float:
        """With the fused attention kernel: the launches' least bytes and
        the glue's."""
        return (self.nbytes + self.glue_bytes) / PEAK_BYTES

    @property
    def collective_t(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BYTES

    @property
    def bound_ms(self) -> float:
        """The launches' bounds, summed."""
        return sum(p.bound_ms for p in self.launches)

    @property
    def call_bound_ms(self) -> float:
        """The whole call's serial bound: the launches', the glue ops' and
        the collectives' one after another."""
        return self.bound_ms + self.glue_ms + self.collective_t * 1e3

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_t, "memory": self.memory_t_fused,
                 "collective": self.collective_t}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Seconds, JAX's roofline: the largest of the three engines'
        totals, the memory term the fused one."""
        return max(self.compute_t, self.memory_t_fused, self.collective_t)

    @property
    def step_time_unfused(self) -> float:
        return max(self.compute_t, self.memory_t, self.collective_t)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * the walk's FLOPs): remat and the
        recomputing backward's share."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        denom = self.chips * self.peak_flops * self.step_time
        return self.model_flops / denom if denom else 0.0

    @property
    def mfu_unfused(self) -> float:
        denom = self.chips * self.peak_flops * self.step_time_unfused
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        """JAX's keys, then the port's: the kernels' and the glue's
        bounds and the serial bound of the call."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": dict(self.coll_bytes),
            "model_flops": self.model_flops,
            "attn_internal_bytes": self.attn_internal_bytes,
            "compute_t": self.compute_t, "memory_t": self.memory_t,
            "memory_t_fused": self.memory_t_fused,
            "collective_t": self.collective_t, "bound": self.bound,
            "step_time": self.step_time,
            "step_time_unfused": self.step_time_unfused,
            "mfu": self.mfu, "mfu_unfused": self.mfu_unfused,
            "useful_flops_ratio": self.useful_flops_ratio,
            "launches": len(self.launches),
            "kernel_operations": self.flops,
            "kernel_bytes": self.nbytes,
            "kernel_bound_ms": self.bound_ms,
            "glue_flops": self.glue_flops, "glue_bytes": self.glue_bytes,
            "glue_bound_ms": self.glue_ms,
            "call_bound_ms": self.call_bound_ms,
        }

    def by_kernel(self) -> Dict[str, dict]:
        """Launches, operations, bytes and bound summed by kernel and
        design."""
        out: Dict[str, dict] = defaultdict(lambda: {
            "launches": 0, "flops": 0, "bytes": 0, "bound_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0})
        for p in self.launches:
            e = out[f"{p.kernel} {p.design}"]
            e["launches"] += 1
            e["flops"] += p.flops
            e["bytes"] += p.nbytes
            e["bound_ms"] += p.bound_ms
            e["ops_ms"] += p.flops / PEAK_FLOPS[p.dtype] * 1e3
            e["bytes_ms"] += p.nbytes / PEAK_BYTES * 1e3
        for e in out.values():
            e["bound_by"] = ("operations" if e["ops_ms"] >= e["bytes_ms"]
                             else "bytes")
        return dict(out)


def report(records, *, arch: str = "", shape: str = "",
           coll_bytes: Optional[Dict[str, int]] = None) -> RooflineReport:
    return RooflineReport(arch=arch, shape=shape,
                          launches=price_all(records),
                          coll_bytes=coll_bytes or collective_bytes({}))


def analyze(cost, *, arch: str, shape: str, mesh_name: str = "",
            chips: int = 1, n_active: int = 0, tokens: int = 0,
            kind: str = "serve", dtype="bf16") -> RooflineReport:
    """The roofline of a whole call from its op walk
    (``launch/op_cost.OpCost``), the JAX package's ``analyze`` over the
    port's walk: the launch records priced as :func:`report` prices
    them, the glue, the score traffic and the collectives. ``dtype``
    (the call's) gives the peak of the MFU terms; ``kind`` 'train' or
    'serve' the model FLOPs (:func:`model_flops`)."""
    return RooflineReport(
        arch=arch, shape=shape, launches=price_all(cost.records),
        coll_bytes={k: int(v) for k, v in cost.coll_bytes.items()},
        cost=cost, mesh=mesh_name, chips=chips,
        model_flops=model_flops(n_active, tokens, kind),
        peak_flops=PEAK_FLOPS[dtype_name(dtype)])


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for forward-only serving steps."""
    mult = 6 if kind == "train" else 2
    return float(mult) * n_params_active * tokens


def flash_min_bytes(cfg, shape, chips: int) -> float:
    """Analytic per-device HBM floor of the row-wise flash attention
    kernel, per step: read q/k/v, write out (+lse), with the backward
    re-reading q/k/v/out/do and writing dq/dk/dv (recompute-from-lse).

    train:   ~3.5x the forward traffic (fwd + recompute + grads)
    prefill: forward only
    decode:  one cache read + O(1)-token q/out
    """
    hd = cfg.head_dim
    total = 0.0
    for stage in cfg.stages():
        for blk in stage.body:
            if blk.mixer != "attn":
                continue
            n_layers = stage.repeat
            if shape.kind == "decode":
                kv_len = min(blk.window, shape.seq_len) if blk.window \
                    else shape.seq_len
                kv_b = (shape.global_batch * kv_len * cfg.n_kv_heads
                        * hd * 2 * 2)
                q_b = shape.global_batch * cfg.n_heads * hd * 2 * 4
                total += n_layers * (kv_b + q_b)
            else:
                t = shape.global_batch * shape.seq_len
                q_b = t * cfg.n_heads * hd * 2 * 2     # read q, write o
                kv_b = t * cfg.n_kv_heads * hd * 2 * 2
                per = q_b + kv_b
                total += n_layers * (3.5 * per if shape.kind == "train"
                                     else per)
    return total / chips


def _lines(rep: RooflineReport, card: str) -> List[str]:
    out = [f"[roofline] {rep.arch} {rep.shape}: {len(rep.launches)} "
           f"launches, {rep.flops:.4g} operations, {rep.nbytes:.4g} bytes, "
           f"bound {rep.bound_ms:.4f} ms (compute {rep.compute_t * 1e3:.4f}"
           f" ms, memory {rep.memory_t * 1e3:.4f} ms, collectives "
           f"{rep.collective_t * 1e3:.4f} ms); the glue "
           f"{rep.glue_flops:.4g} FLOPs, {rep.glue_bytes:.4g} bytes, bound "
           f"{rep.glue_ms:.4f} ms; the whole call {rep.call_bound_ms:.4f} ms"
           f" | {card}"]
    for key, e in sorted(rep.by_kernel().items()):
        out.append(f"    {key}: {e['launches']} launches, bound "
                   f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dtype", default="bf16", choices=("fp32", "bf16"))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0 = all)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels' launches), 'cpu' (the "
                         "plain calls, priced as the card would launch "
                         "them) or 'meta' (shapes alone, routed as on "
                         "the card)")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import runtime
    from repro_torch.launch import op_cost
    from repro_torch.models import lm

    dev = runtime.resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    if dev.type == "meta":
        params = lm.init_lm(cfg, None, device=dev, dtype=dt)
        tokens = torch.zeros((args.batch, args.seq), dtype=torch.int64,
                             device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = lm.init_lm(cfg, gen, device=dev, dtype=dt)
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                               generator=gen, device=dev)
    card = dev.type
    if dev.type == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    extra = None
    if cfg.encdec:
        extra = {"frames": torch.zeros((args.batch, cfg.cross_len,
                                        cfg.d_model), dtype=dt, device=dev)}
    with torch.no_grad():
        (_, cache), pre = op_cost.walk(lm.prefill, params, tokens, cfg,
                                       alloc=args.seq + 1, extra=extra)
        last = tokens[:, -1:]
        lengths = torch.full((args.batch,), args.seq, dtype=torch.int32,
                             device=dev)
        _, step = op_cost.walk(lm.decode_step, params, cache, last, lengths,
                               cfg)
    shape = f"B={args.batch} x {args.seq} {args.dtype}"
    for cost, what in ((pre, "prefill"), (step, "decode step")):
        rep = analyze(cost, arch=cfg.name, shape=f"{what} {shape}",
                      dtype=dt)
        for line in _lines(rep, card):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
