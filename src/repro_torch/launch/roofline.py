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
``--seed``) under the recording switch and prints each kernel's
launches, operations, bytes and bound, and the step's roofline. It runs
on the card unless given ``--device cpu``, where the wrappers take their
plain versions and the records are of the plain calls (noted
``launched`` False, with the design the card would take).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

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
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(skv - 1, pos) if causal else skv - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


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
    from its launch records. The launches run one after another on a
    stream, so the call's bound is the sum of the launches' bounds, and
    the collectives (synchronous on the stream) add theirs."""

    arch: str
    shape: str
    launches: List[Priced]
    coll_bytes: Dict[str, int]

    @property
    def flops(self) -> int:
        return sum(p.flops for p in self.launches)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.launches)

    @property
    def compute_t(self) -> float:
        """Seconds at the peaks, each launch at its dtype's."""
        return sum(p.flops / PEAK_FLOPS[p.dtype] for p in self.launches)

    @property
    def memory_t(self) -> float:
        return self.nbytes / PEAK_BYTES

    @property
    def collective_t(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BYTES

    @property
    def bound_ms(self) -> float:
        return sum(p.bound_ms for p in self.launches)

    @property
    def step_time(self) -> float:
        """Seconds: the launches' bounds one after another, then the
        collectives."""
        return self.bound_ms / 1e3 + self.collective_t

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
           f"{rep.collective_t * 1e3:.4f} ms) | {card}"]
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
                    help="'cuda' (the kernels' launches) or 'cpu' (the "
                         "plain calls, priced as the card would launch "
                         "them)")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import runtime
    from repro_torch.models import lm

    dev = runtime.resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device=dev, dtype=dt)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=gen, device=dev)
    card = "cpu"
    if dev.type == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    with torch.no_grad():
        with recording() as pre:
            _, cache = lm.prefill(params, tokens, cfg,
                                  alloc=args.seq + 1)
        last = tokens[:, -1:]
        lengths = torch.full((args.batch,), args.seq, dtype=torch.int32,
                             device=dev)
        with recording() as step:
            lm.decode_step(params, cache, last, lengths, cfg)
    shape = f"B={args.batch} x {args.seq} {args.dtype}"
    for rec, what in ((pre, "prefill"), (step, "decode step")):
        rep = report(rec, arch=cfg.name, shape=f"{what} {shape}")
        for line in _lines(rep, card):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
