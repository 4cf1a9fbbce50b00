#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of ``src/repro_torch/csrc`` into ``build/repro_torch``:
   registers and spills from ``ptxas.log``, and the count of tensor-core
   instructions (``HGMMA`` / ``IGMMA`` / ``IMMA`` / ``HMMA``) in each
   matmul and attention kernel from ``cuobjdump -sass``;
3. each kernel against its plain version at every distinct Swin-T shape
   and mode (B=8), in fp32 and in bf16, plus a gated matmul and an
   LM-style attention (causal + window + GQA + q_offset): error beside
   its tolerance, kernel / plain / library ms (CUDA events, after
   warm-up; calls of M <= 16 rows rotate copies of their weights past
   the 50 MB L2, so each reads its weights from HBM as the model does),
   the bound, and the design the call took (matmul: skinny, wgmma or
   ffma; attention: mma or ffma; WKV: chunk or step; layernorm: cta or
   rows, each layernorm case with its own and ``F.layer_norm``'s device
   ms from the profiler beside the event ms); the attention of
   ViT-B/16 (B=8) and of a Swin-T forward at B=64; every kernel call of
   a deepseek-7b prefill (fused and unfused, B=4 x 512) and decode step
   (B=4), the weights of the qkv and gate|up panels read as the model
   reads them, summed in ``dense-table`` lines; every kernel call of a
   gemma3-27b prefill (B=2 x 2048: the local layers' causal attention
   with the 1024-token window and the global layers', GQA 32 over 16 at
   head dim 128, the GeGLU panel, the tied head at N = 262144) and
   decode step (B=2), and of a whisper-base prefill (B=4 x 64 over 1500
   frames: the encoder's causal attention at S = 1500, head dim 64,
   cross-attention of 64 queries to the 1500 frames, LayerNorm with
   beta at K = 512) and decode step (B=4), in ``gemma-table`` and
   ``whisper-table`` lines; then the int8 W8A8
   leg at every distinct Swin-T matmul shape and at RWKV6-3B's widths
   at M=2048 and M=4, held against the exact
   plain version (float64 products on the card), ``torch._int_mm`` as
   its library yardstick where that takes the shape; host µs per
   wrapper call. Where a matmul's norm does not stay in its design's
   prologue (``rowwise_matmul.norm_prologue_fits``: the skinny design
   up to ``SKINNY_NORM_MAX_K``) the case is the standalone norm and the
   matmul without one, as ``ops`` runs it;
4. full-width Swin-T, fused, B=8 fp32: kernel path against
   ``use_impl("ref")`` on the card, launch counts 53 / 12 / 25 (the
   final norm and the 24 prologue panels' norms, split);
5. the same unfused: counts 53 / 0 / 25, and agreement with fused;
6. ViT-B/16, B=8, kernel path against plain (50 / 12 / 25);
7. Swin-T bf16, fused and unfused, against its plain path, and images/s
   at B=64 in fp32 and bf16 (plain fp32 beside it);
8. RWKV6-3B at full width and depth (jittered random weights): 4 prompts
   of 512 tokens, then 32 greedy decode steps, then 1 prompt of 333
   tokens with 8 steps, in fp32 teacher-forced on the plain path's
   tokens (logits at prefill and every step, greedy picks, final WKV
   states), 321 / 0 / 97 / 32 launches per prefill and per step; bf16
   each layer on the plain bf16 path's input against the same layer in
   fp32 (beside a control in float8_e5m2), and at full depth as readings
   (and, for scale, the plain bf16 prefill against the plain fp32 one);
   prefill and decode tokens/s;
9. deepseek-7b at full width and depth (30 layers, d 4096, jittered
   norms): 4 prompts of 512 tokens, then 32 greedy decode steps, then 1
   prompt of 333 tokens with 8 steps, in fp32 teacher-forced on the
   plain path's tokens (logits at prefill and every step, greedy picks,
   the final KV cache), 121 / 30 / 61 / 0 launches per prefill and
   121 / 0 / 61 / 0 per step (the qkv and gate|up panels' norms split at
   K = 4096; decode attends in torch ops, as the JAX package does); the
   unfused prefill (211 / 30 / 61 / 0) against the fused one; bf16
   layer by layer against fp32 beside the float8 control, fused and
   unfused, the unfused bf16 prefill counted, and at full depth as
   readings; prefill and decode tokens/s; then paged serving (the
   JAX engine's step programs replayed on the host, ``PagedServing``):
   six greedy requests of 97, 333, 512, 700, 64 and 900 tokens, 32 new
   tokens each, on 4 slots of 16-token pages (max_len 1024) in fp32,
   the 700 and 900 chunked at 256 between lockstep paged decode steps,
   the others by bucketed one-shot prefill + ``insert_prefill``; slots
   retire and refill on reused pages; one verify step over a 4-token
   panel with 3 / 2 / 1 / 0 drafts kept (``insert_verify``) and one
   copy-on-write of a live page into a free one (the copy equal to its
   source); each stream held to the dense path's greedy stream
   (``dense_oracle``, near-tie rule), the first-token logits within
   1e-3 x max(1, max|logit|) and every layer's pool rows at every
   written position within 1e-3 of the dense cache's; every call's
   launches exact (a bucketed prefill 121 / 30 / 61 / 0, a chunk, a
   verify and a step 121 / 0 / 61 / 0, the inserts and the copy none);
   in bf16 (``paged_rates``) paged against dense decode tokens/s at B=4
   after 512 tokens, the profile of a paged step and of a chunk, and
   the 900-token prompt chunked at 256 against its one-shot prefill in
   bucket 1024;
10. gemma3-27b at full width (jittered norms): 8 layers (one 5:1 group
   and the 2-layer local tail) in fp32, 2 prompts of 2048 tokens then 16
   greedy steps and 1 prompt of 1020 then 12 (its ring wraps from the
   fifth step), teacher-forced on the plain path's tokens (logits, picks,
   the final ring and global caches), 33 / 8 / 17 / 0 launches a
   prefill and 33 / 0 / 17 / 0 a step, and unfused (57 / 8 / 17 / 0);
   then, the fp32 model freed, all 62 layers in bf16 (50.3 GiB of
   weights: the fp32 tree would not fit), 249 / 62 / 125 / 0 and
   249 / 0 / 125 / 0, layer by layer against fp32 beside the float8
   control, its logits as readings; prefill and decode tokens/s
   (fused, unfused, plain), peak memory, the tied head's per-call
   transpose; paged serving of a 1500-token prompt chunked at 512 (its
   chunks cross the 1024 window: the ring pages wrap mid-prompt) and a
   300-token one-shot on 2 slots (max_len 2048), 17 tokens each with
   one verify step (3 / 1 drafts kept), held to the dense path as for
   deepseek-7b at 8 fp32 layers (33 / 8 / 17 / 0 a bucketed prefill,
   33 / 0 / 17 / 0 a chunk, verify and step) and at 62 bf16 layers
   (249 / 62 / 125 / 0, 249 / 0 / 125 / 0; logits and pool rows within
   the bf16 tolerance 3e-2), and the bf16 readings at B=2 after 1024
   tokens and for the 1500-token prompt chunked at 512; whisper-base at
   full width and depth on seeded frames (B=4 x 1500 x 512): the
   encoder's launches, 4 prompts of 64 tokens then 32 steps and 1 of 16
   then 8, fp32 teacher-forced (logits, picks,
   self and cross caches), the unfused prefill, bf16 layer by layer
   (encoder and decoder) and as readings; tokens/s;
11. the int8 path: ``ops.matmul_int8`` at every Swin-T matmul shape
   (B=8), as often as a fused forward runs each (53 launches, counted),
   and its device time by matmul design (profiler);
12. the matmul, attention and WKV per design and dtype, summed over a
   Swin-T forward (B=8 and, for attention, B=64), a ViT-B/16 forward,
   each LM's prefill and decode step
   (``design-table`` lines); one JSON
   line of the kernels (the int8 leg a row of its own), then the last
   line ``{"ok": true, "device": {...}}``. Before the tables, each
   picker's boundary (``threshold`` lines, device µs from the
   profiler): the matmul's skinny design against the M > 16 design of
   each dtype at M = 4 .. 16, WKV's step design against its chunk
   design at S = 1 .. 32 tokens, layernorm's cta design against its
   rows design at M = 1 .. 2048 rows of D = 96 .. 2560, and each matmul
   design's norm prologue against the standalone norm and a
   prologue-free matmul at K = 64 .. 8192, each design's boundary
   beside the rule's; and decode tokens/s end to end of deepseek-7b
   (fp32, bf16) and gemma3-27b (bf16, 62 layers) with
   ``SKINNY_NORM_MAX_K`` on either side of their K, in ABBA order.
   The kernels line gives layernorm once per design: over the fused
   Swin-T forward (rows) and over an RWKV6-3B decode step (cta), and
   attention a second time over a deepseek-7b prefill (causal), and
   once per new mode: gemma3-27b's windowed layers, whisper-base's
   encoder (S = 1500) and its cross-attention.

Phase 3 also holds every RWKV6-3B kernel call (M=2048 prefill and M=4
decode matmuls and norms, the WKV recurrence at B=4 x 512, B=1 x 333
and the B=4 decode step with a starting state) and every deepseek-7b
kernel call (its four matmul panels at M=2048 and M=4, the head at
N=102400 with fp32 out, causal attention at B=4 x 32 heads x 512 x 128
with ``F.scaled_dot_product_attention(is_causal=True)`` as the
yardstick, the final RMSNorm) against its plain version, and sums them
per prefill and per decode step of each model (``rwkv-table`` and
``dense-table`` lines); a windowed or cross attention case's yardstick
is SDPA with a boolean mask.

Details of every case go to ``chiprun_out/chip_smoke.json``. Any
mismatch, wrong count or failed phase raises, and the script exits
non-zero with no result line. It exits non-zero at once where
``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# Tolerances, each with its reason.
# fp32 kernel against plain fp32 on the same inputs: only the order of
# the fp32 sums differs (and rsqrtf/expf/tanhf against torch's), so a
# few ulps times sqrt(K) — far below 1e-4.
FP32_TOL = 1e-4
# fp32 logits after 12 Swin blocks or 32 RWKV6 layers (and the final WKV
# states): the per-kernel differences above compound through the
# residual stream and the recurrence; judged against the logits' scale.
LOGIT_TOL = 1e-3
# bf16 kernel against the plain fp32 version fed the same bf16 inputs:
# bf16 keeps 8 bits of mantissa (relative step 2^-8 = 3.9e-3), and the
# kernel rounds at its own points (the normed prologue operand, the
# attention probabilities, the output); judged against max(1, max|ref|).
BF16_TOL = 3e-2
# bf16 RWKV6-3B, each layer on the plain bf16 path's input to it, held
# against the same layer in fp32 (the bf16 weights upcast) as
# rms(err) / rms(out). A sound bf16 path reads bf16's own rounding
# compounded inside the layer, whatever points it rounds at; the limit
# sits between the kernel path's largest reading and the least reading
# of a control in lower precision, the plain bf16 output rounded to
# float8_e5m2 (2 mantissa bits), for RWKV6-3B and deepseek-7b alike
# (PERF.md, Findings).
BF16_LAYER_TOL = 1.5e-2

# int8 W8A8 kernel against the plain version on the same int8 inputs:
# the int32 sums are exact on both sides (the plain version multiplies
# in float64 on the card, exact below 2^53), so only the fp32 dequant
# and activation differ, by a few ulps.
INT8_TOL = 1e-5

# H100 SXM peaks (NVIDIA's data sheet, dense): fp32 off the tensor cores,
# bf16 and int8 on them, and the device memory rate.
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

REPLACES = {
    "rowwise_matmul": "src/repro/kernels/rowwise_matmul.py:142",
    "flash_attention": "src/repro/kernels/flash_attention.py:101",
    "layernorm": "src/repro/kernels/layernorm.py:58",
    "wkv": "src/repro/kernels/wkv.py:66",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
# calls of at most this many rows are timed with their weights cold in
# L2: copies rotated past the 50 MB L2
COLD_M = 16
COLD_BYTES = 120e6


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_time(fn, budget_ms=25.0):
    """Mean ms of ``fn`` on the card: CUDA events around back-to-back
    launches after a warm-up, repeated for about ``budget_ms``."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        fn()
    end.record()
    end.synchronize()
    iters = max(3, min(200, int(budget_ms / max(start.elapsed_time(end) / 3,
                                                 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=300):
    """Host µs to enqueue one call of ``fn`` (no synchronise inside the
    loop), at a shape small enough that the device keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def launch_overheads(device):
    """Host cost of each kernel wrapper against its library call, on
    tiny operands (the floor under the per-case times of small shapes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_p
    from repro_torch.kernels.layernorm import layernorm_p
    from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
    from repro_torch.kernels.wkv import wkv_p

    x, w, b = (torch.randn(*s, device=device) for s in
               ((64, 64), (64, 64), (64,)))
    xb, wb, bb = (t.to(torch.bfloat16) for t in (x, w, b))
    x4 = x[:4]
    q = torch.randn(1, 1, 64, 32, device=device)
    r = -torch.rand(1, 16, 1, 64, device=device)
    return {
        # no single library call computes WKV6
        "wkv": (host_us(lambda: wkv_p(r, r, r, r, r[0, 0])), None),
        "rowwise_matmul": (host_us(lambda: rowwise_matmul_p(
            x, w, bias=b, residual=x)), host_us(
            lambda: torch.addmm(b, x, w) + x)),
        # the wgmma design encodes its TMA maps per call
        "rowwise_matmul wgmma bf16": (host_us(lambda: rowwise_matmul_p(
            xb, wb, bias=bb, residual=xb)), host_us(
            lambda: torch.addmm(bb, xb, wb) + xb)),
        # the skinny design allocates its split-K workspace per call
        "rowwise_matmul skinny M=4": (host_us(lambda: rowwise_matmul_p(
            x4, w, bias=b, residual=x4)), host_us(
            lambda: torch.addmm(b, x4, w) + x4)),
        "flash_attention": (host_us(lambda: flash_attention_p(
            q, q, q, causal=False)), host_us(
            lambda: F.scaled_dot_product_attention(q, q, q))),
        "layernorm": (host_us(lambda: layernorm_p(x, b, b)), host_us(
            lambda: F.layer_norm(x, (64,), b, b, 1e-6))),
    }


def tensor_core_counts(library):
    """Tensor-core instructions (``HGMMA``, ``IGMMA``, ``QGMMA``, ``HMMA``,
    ``IMMA``) in each matmul and attention kernel of the library, from
    ``cuobjdump -sass``, keyed by the kernel's mangled name from its stem
    (``rowwise_matmul_kernel``, ``attention_kernel``) on."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : \S*?((?:rowwise_matmul|attention)"
                          r"_kernel\w*?)E*v", line)
        if "Function :" in line:
            name = found.group(1) if found else None
            if name:
                counts[name] = {}
            continue
        op = re.search(r"\b(HGMMA|IGMMA|QGMMA|HMMA|IMMA)\b", line)
        if name and op:
            counts[name][op.group(1)] = counts[name].get(op.group(1), 0) + 1
    return counts


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors, out=(0, None)):
    """Bytes of the inputs, each read once, plus an output of ``out`` =
    (elements, dtype) written once."""
    import torch
    n_out, dt = out
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None) + (n_out * torch.finfo(dt).bits // 8
                                    if n_out else 0)


def err_ok(out, want, tol):
    """max |out - want| and whether it is within tol * max(1, max|want|)."""
    import torch
    out, want = out.float(), want.float()
    if not torch.isfinite(out).all():
        return float("inf"), False
    err = (out - want).abs().max().item()
    return err, err <= tol * max(1.0, want.abs().max().item())


# ------------------------------ cases ----------------------------------


# launches per Swin-T forward at B=8 (fused, unfused), per RWKV6-3B
# prefill at B=4 x 512 and decode step at B=4, per ViT-B/16 forward at
# B=8, per fused Swin-T forward at B=64 (attention only), per
# deepseek-7b prefill at B=4 x 512 (fused, unfused) and fused decode step
# at B=4, per gemma3-27b prefill at B=2 x 2048 and decode step at B=2
# (8 layers in fp32, 62 in bf16), and per whisper-base prefill at B=4 x
# 64 (its encoder over 1500 frames included) and decode step at B=4
COUNTS = ("fused", "unfused", "prefill", "decode", "vit", "fused64",
          "dprefill", "ddecode", "dunfused", "gprefill", "gdecode",
          "wprefill", "wdecode")
# the exact launches (rowwise_matmul, flash_attention, layernorm, wkv) of
# each fused run the model phases check, restated by hand as PERF.md §2
# lists them; :func:`want_launches` also holds each against the count
# the config and ``rowwise_matmul.norm_prologue_fits`` give. A norm
# panel splits (one more layernorm launch) on the designs of many rows,
# and on the skinny design past SKINNY_NORM_MAX_K
LAUNCHES = {
    "swin-t": (53, 12, 25, 0),                  # B=8, fp32 and bf16
    "vit-b16": (50, 12, 25, 0),                 # B=8
    "deepseek-7b prefill": (121, 30, 61, 0),    # 4 x 512 and 1 x 333
    "deepseek-7b step": (121, 0, 61, 0),        # B=4 and B=1, K = 4096
    "gemma3-27b/8 prefill": (33, 8, 17, 0),     # fp32, 8 layers
    "gemma3-27b/8 step": (33, 0, 17, 0),        # K = 5376
    "gemma3-27b prefill": (249, 62, 125, 0),    # bf16, 62 layers
    "gemma3-27b step": (249, 0, 125, 0),
    "whisper-base encoder": (24, 6, 13, 0),     # 4 x 1500 frames
    "whisper-base prefill": (67, 18, 32, 0),    # 4 x 64, the encoder's too
    "whisper-base prefill 1x16": (67, 18, 20, 0),   # 16 rows: skinny fp32
    "whisper-base step": (37, 0, 7, 0),         # K = 512: the norm stays
    # paged serving: a bucketed prefill launches as the dense prefill at
    # its bucket ("... prefill"), a paged step as the dense step; a
    # chunk (256 or 512 rows) and a verify panel (16 or 8 rows) attend
    # in torch ops, as JAX does in jnp: no attention launch
    "deepseek-7b chunk": (121, 0, 61, 0),
    "deepseek-7b verify": (121, 0, 61, 0),
    "gemma3-27b/8 chunk": (33, 0, 17, 0),
    "gemma3-27b/8 verify": (33, 0, 17, 0),
    "gemma3-27b chunk": (249, 0, 125, 0),
    "gemma3-27b verify": (249, 0, 125, 0),
}
NO_LAUNCHES = dict.fromkeys(REPLACES, 0)


class Case:
    """One kernel call at one shape: how to run the kernel, its plain
    version, the reference its output is checked against, and the
    library call that computes the same function."""

    def __init__(self, kernel, name, run, plain, check, library,
                 flops, nbytes_, design=None, **counts):
        self.kernel, self.name, self.design = kernel, name, design
        self.run, self.plain, self.check, self.library = (
            run, plain, check, library)
        self.flops, self.nbytes = flops, nbytes_
        self.counts = {k: counts.get(k, 0) for k in COUNTS}
        self.op = None


def _rand(gen, shape, dtype, device, scale=1.0):
    import torch
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return t.to(device=device, dtype=dtype)


def matmul_case(name, m, k, n, dtype, gen, device, *, bias=True, act=None,
                norm=None, beta=True, residual=False, gated=False,
                out_f32=False, panel=None, **counts):
    """One matmul call. int8: W8A8 operands (x and w int8 from the
    quantizers, fp32 scales and vectors); its plain version multiplies
    in float64, exact. M <= COLD_M: the kernel, plain and library calls
    each take the next of enough weight copies to pass the L2.
    ``panel=(width, offset)``: the weights are column views of one
    stored (K, width) panel, as the model reads them: w the N columns
    from ``offset``, or when gated the gate those and w the N after."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.rowwise_matmul import (pick_design,
                                                    rowwise_matmul_p)

    int8 = dtype == torch.int8
    vec = torch.float32 if int8 else dtype
    x = _rand(gen, (m, k), vec, device)
    if panel:
        width, off = panel
        full = _rand(gen, (k, width), vec, device, k ** -0.5)

        def views(t):
            if gated:
                return t[:, off + n:off + 2 * n], t[:, off:off + n]
            return t[:, off:off + n], None
        w, wg = views(full)
    else:
        w = _rand(gen, (k, n), vec, device, k ** -0.5)
        wg = _rand(gen, (k, n), vec, device, k ** -0.5) if gated else None
    b = _rand(gen, (n,), vec, device, 0.1) if bias else None
    bg = _rand(gen, (n,), vec, device, 0.1) if gated and bias else None
    res = _rand(gen, (m, n), vec, device) if residual else None
    g = (1 + _rand(gen, (k,), vec, device, 0.1)) if norm else None
    be = _rand(gen, (k,), vec, device, 0.1) if norm and beta else None
    out_dtype = torch.float32 if out_f32 or int8 else dtype
    scales = {}
    if int8:
        assert not panel, "the int8 cases take no panel views"
        x, scales["x_scale"] = quant.quantize_per_row(x)
        w, scales["w_scale"] = quant.quantize_per_channel(w)
        if gated:
            wg, scales["wg_scale"] = quant.quantize_per_channel(wg)
    ops = dict(bias=b, activation=act, bias_gate=bg, residual=res, **scales)
    weights = [(w, wg)]
    if m <= COLD_M:
        size = (full.numel() * full.element_size() if panel else
                sum(t.numel() * t.element_size() for t in (w, wg)
                    if t is not None))
        copies = range(int(-(-COLD_BYTES // size)) - 1)
        weights += ([views(full.clone()) for _ in copies] if panel else
                    [tuple(None if t is None else t.clone() for t in (w, wg))
                     for _ in copies])
    turn = itertools.cycle(weights)

    def plain_on(cast, rotate):
        c = (lambda t: None if t is None else t.to(cast)) if cast else (
            lambda t: t)

        def run():
            wt, wgt = next(turn) if rotate else weights[0]
            return ref.pipeline_ref(
                c(x), c(wt), w_gate=c(wgt),
                **{key: c(v) if isinstance(v, torch.Tensor)
                   and v.is_floating_point() and key not in scales else v
                   for key, v in ops.items()},
                norm_kind=norm, gamma=c(g), beta=c(be),
                out_dtype=cast or out_dtype)
        return run

    act_fn = ref.ACTIVATIONS[act]

    def library():
        wt, wgt = next(turn)
        xin = x
        if norm == "layer":
            xin = F.layer_norm(x, (k,), g, be, 1e-6)
        elif norm == "rms":
            xin = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * g
            xin = xin + be if be is not None else xin
        if int8:
            # the int32 product, then the dequant and the same epilogue
            def dot(wq, bias, scale):
                h = torch._int_mm(x, wq) * scales["x_scale"] * scale
                return h + bias if bias is not None else h
            h = dot(wt, b, scales["w_scale"])
            gg = dot(wgt, bg, scales.get("wg_scale")) if gated else None
        else:
            h = torch.addmm(b, xin, wt) if b is not None else xin @ wt
            gg = ((torch.addmm(bg, xin, wgt) if bg is not None else
                   xin @ wgt) if gated else None)
        if gated:
            h = act_fn(gg) * h
        else:
            h = act_fn(h)
        return h + res if res is not None else h

    # torch._int_mm, the int8 yardstick's product, takes M > 16 and K, N
    # multiples of 8
    has_library = not int8 or (m > 16 and k % 8 == 0 and n % 8 == 0)

    def run():
        wt, wgt = next(turn)
        return rowwise_matmul_p(x, wt, w_gate=wgt, **ops, prologue=norm,
                                gamma=g, pbeta=be, out_dtype=out_dtype)

    case = Case(
        "rowwise_matmul", f"{name} M={m} K={k} N={n}", run,
        plain_on(None, True),
        plain_on(torch.float32 if dtype == torch.bfloat16 else None, False),
        library if has_library else None, 2 * m * n * k * (2 if gated else 1),
        nbytes(x, w, wg, b, bg, res, g, be, *scales.values(),
               out=(m * n, out_dtype)),
        design=pick_design(m, dtype), **counts)
    case.op = dict(x=x, w=w, wg=wg, ops=ops, out_dtype=out_dtype)
    return case


def attention_case(name, qkv_shape, heads, hkv, dtype, gen, device, *,
                   bias=None, causal=False, window=0, q_offset=0, skv=None,
                   **counts):
    """q/k/v as the main path gives them: views of one fused qkv output
    (nw, t, (heads + 2 hkv) hd), split and reshaped per head."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_p,
                                                     pick_design)

    nw, t, hd = qkv_shape
    skv = skv or t
    q = _rand(gen, (nw, t, heads * hd), dtype, device)
    q = q.reshape(nw, t, heads, hd).permute(0, 2, 1, 3)
    kv = _rand(gen, (nw, skv, 2 * hkv * hd), dtype, device)
    k, v = (z.reshape(nw, skv, hkv, hd).permute(0, 2, 1, 3)
            for z in torch.split(kv, hkv * hd, dim=-1))
    kw = dict(causal=causal, window=window, q_offset=q_offset, bias=bias)

    def plain_on(cast):
        c = (lambda z: z.to(cast)) if cast else (lambda z: z)
        return lambda: ref.attention_ref(c(q), c(k), c(v), **kw)

    group = heads // hkv
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    qpos = q_offset + torch.arange(t, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    allowed = torch.ones((t, skv), dtype=torch.bool, device=device)
    if causal:
        allowed &= kpos <= qpos
    if window:
        allowed &= kpos > qpos - window
    # SDPA's boolean mask where there is no score bias, else the bias
    # with the mask added as -inf
    mask = allowed
    if bias is not None:
        nb = bias.shape[0]
        mask = (bias.to(dtype)[None].expand(nw // nb, *bias.shape)
                .reshape(nw, heads, t, skv)
                + torch.zeros((t, skv), dtype=dtype, device=device)
                .masked_fill(~allowed, float("-inf")))
    if causal and not (window or q_offset or bias is not None) and t == skv:
        # plain causal attention: the library's own causal path
        def library():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    else:
        def library():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)

    return Case(
        "flash_attention", f"{name} q={tuple(q.shape)} kv={tuple(k.shape)}",
        lambda: flash_attention_p(q, k, v, **kw), plain_on(None),
        plain_on(torch.float32 if dtype != torch.float32 else None),
        library,
        4 * nw * heads * hd * int(allowed.sum().item()),
        nbytes(q, k, v, bias, out=(q.numel(), dtype)),
        design=pick_design(dtype), **counts)


def layernorm_case(name, m, d, dtype, gen, device, kind="layer", **counts):
    """One norm call (``kind``: LayerNorm with beta, or RMSNorm without).
    Its operands fit in the 50 MB L2, so the kernel, plain and library
    calls each take the next of enough copies of x to pass the L2 and
    read x from HBM, as the bound assumes."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.layernorm import layernorm_p, pick_design

    x = _rand(gen, (m, d), dtype, device)
    g = 1 + _rand(gen, (d,), dtype, device, 0.1)
    b = _rand(gen, (d,), dtype, device, 0.1) if kind == "layer" else None
    copies = int(-(-COLD_BYTES // (x.numel() * x.element_size())))
    turn = itertools.cycle(x.expand(copies, m, d).contiguous().unbind(0))

    def plain_on(cast):
        if cast:
            return lambda: ref.layernorm_ref(
                x.to(cast), g.to(cast), None if b is None else b.to(cast),
                kind=kind)
        return lambda: ref.layernorm_ref(next(turn), g, b, kind=kind)

    def library():
        if kind == "layer":
            return F.layer_norm(next(turn), (d,), g, b, 1e-6)
        return F.rms_norm(next(turn), (d,), g, 1e-6)

    return Case(
        "layernorm", f"{name} M={m} D={d}" + ("" if b is not None else
                                             " rms"),
        lambda: layernorm_p(next(turn), g, b, kind=kind), plain_on(None),
        plain_on(torch.float32 if dtype != torch.float32 else None),
        library, 7 * m * d,
        nbytes(x, g, b, out=(x.numel(), dtype)),
        design=pick_design(m, d, dtype), **counts)


def norm_matmul_cases(name, m, k, n, dtype, gen, device, *, norm,
                      **kw):
    """A matmul with a pre-norm (``norm``: 'layer' with beta, 'rms'
    without) as the fused path runs it: one call with the norm in the
    kernel's prologue where ``norm_prologue_fits``, else the standalone
    norm and then the matmul without one, each with the counts given."""
    from repro_torch.kernels.rowwise_matmul import norm_prologue_fits
    counts = {key: kw.pop(key) for key in list(kw) if key in COUNTS}
    if norm_prologue_fits(m, k, dtype):
        return [matmul_case(f"{name} +{norm}", m, k, n, dtype, gen, device,
                            norm=norm, beta=norm == "layer", **kw, **counts)]
    return [layernorm_case(f"{name} pre-{norm}", m, k, dtype, gen, device,
                           kind=norm, **counts),
            matmul_case(name, m, k, n, dtype, gen, device, **kw, **counts)]


def prologue_splits(rows, k, dtype, panels):
    """The standalone norm launches the fused path adds for ``panels``
    prologue panels of ``rows`` x K that do not fit their design."""
    from repro_torch.kernels.rowwise_matmul import norm_prologue_fits
    return 0 if norm_prologue_fits(rows, k, dtype) else panels


def want_launches(key, derived):
    """``LAUNCHES[key]`` by kernel, after checking it against the count
    ``derived`` from the config and the split rule."""
    want = dict(zip(REPLACES, LAUNCHES[key]))
    if derived != want:
        raise AssertionError(f"{key}: launches restated as {want}, the "
                             f"config and the split rule give {derived}")
    return want


def swin_counts(cfg, batch, dtype):
    """Launches of a fused Swin-T forward: 53 matmuls, 12 attention, the
    final norm and the norms of the prologue panels that split (qkv and
    mlp1 of every block)."""
    res, c, norms = cfg.img_size // cfg.patch, cfg.embed_dim, 1
    for depth in cfg.depths:
        norms += prologue_splits(batch * res * res, c, dtype, 2 * depth)
        res, c = res // 2, c * 2
    return {"rowwise_matmul": 53, "flash_attention": 12, "layernorm": norms,
            "wkv": 0}


def swin_cases(cfg, batch, dtype, gen, device):
    """Every distinct kernel call of a Swin forward, with its launches
    per fused and per unfused forward, plus the extra modes."""
    cases = []
    res = cfg.img_size // cfg.patch
    c = cfg.embed_dim
    cases.append(matmul_case(
        "patch", batch * res * res, cfg.patch ** 2 * cfg.in_chans, c, dtype,
        gen, device, fused=1, unfused=1))
    for si, depth in enumerate(cfg.depths):
        m = batch * res * res
        s = f"s{si + 1}"
        cases += norm_matmul_cases(f"{s}.qkv", m, c, 3 * c, dtype, gen,
                                   device, norm="layer", fused=depth)
        cases += norm_matmul_cases(f"{s}.mlp1+gelu", m, c, 4 * c, dtype,
                                   gen, device, norm="layer", act="gelu",
                                   fused=depth)
        cases += [
            matmul_case(f"{s}.proj+res", m, c, c, dtype, gen, device,
                        residual=True, fused=depth),
            matmul_case(f"{s}.mlp2+res", m, 4 * c, c, dtype, gen, device,
                        residual=True, fused=depth),
            matmul_case(f"{s}.qkv", m, c, 3 * c, dtype, gen, device,
                        unfused=depth),
            matmul_case(f"{s}.proj", m, c, c, dtype, gen, device,
                        unfused=depth),
            matmul_case(f"{s}.mlp1+gelu", m, c, 4 * c, dtype, gen, device,
                        act="gelu", unfused=depth),
            matmul_case(f"{s}.mlp2", m, 4 * c, c, dtype, gen, device,
                        unfused=depth),
            layernorm_case(f"{s}.ln", m, c, dtype, gen, device,
                           unfused=2 * depth),
        ]
        if si < len(cfg.depths) - 1:
            cases.append(matmul_case(
                f"{s}.merge", m // 4, 4 * c, 2 * c, dtype, gen, device,
                bias=False, fused=1, unfused=1))
            res //= 2
            c *= 2
    cases += swin_attention_cases(cfg, batch, dtype, gen, device, "fused")
    cases.append(layernorm_case("final", batch * res * res, c, dtype, gen,
                                device, fused=1, unfused=1))
    cases.append(matmul_case("head", batch, c, cfg.num_classes, dtype, gen,
                             device, out_f32=True, fused=1, unfused=1))
    # modes off the Swin path: gated (with an RMS prologue), the other
    # activations, and the LM options of the attention kernel
    cases += [
        matmul_case("gated+rms+silu", 1024, 384, 1536, dtype, gen, device,
                    norm="rms", beta=False, act="silu", gated=True),
        matmul_case("relu", 512, 200, 300, dtype, gen, device, act="relu"),
        matmul_case("relu2", 512, 200, 300, dtype, gen, device, act="relu2"),
        attention_case("lm causal+window+gqa+offset", (2, 256, 128), 8, 2,
                       dtype, gen, device, causal=True, window=192,
                       q_offset=256, skv=512),
    ]
    return cases


def swin_attention_cases(cfg, batch, dtype, gen, device, key):
    """The window attention of each Swin stage at ``batch`` images, with
    the bias the block gives it (the relative-position table gathered per
    window geometry, plus the shift mask per window position in shifted
    blocks), and its launches per fused forward under ``key``."""
    import torch
    from repro_torch.models import vision

    cases = []
    res, c, w = cfg.img_size // cfg.patch, cfg.embed_dim, cfg.window
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        shifted = depth // 2 if res > w else 0
        blk = {"rel_bias": _rand(gen, ((2 * w - 1) ** 2, heads), dtype,
                                 device, 0.02)}
        rel_idx = vision._rel_pos_index(w, torch.device(device))
        mask = (vision._shift_mask(res, res, w, w // 2, torch.device(device))
                if res > w else None)
        nw = batch * (res // w) ** 2
        shape = (nw, w * w, c // heads)
        tag = f"s{si + 1}" + ("" if batch == 8 else f" B={batch}")
        cases.append(attention_case(
            f"{tag}.window", shape, heads, heads, dtype, gen, device,
            bias=vision._rel_bias(blk, rel_idx, heads, 0, mask),
            **{key: depth - shifted}))
        if shifted:
            cases.append(attention_case(
                f"{tag}.shifted", shape, heads, heads, dtype, gen, device,
                bias=vision._rel_bias(blk, rel_idx, heads, w // 2, mask),
                **{key: shifted}))
        res, c = res // 2, c * 2
    return cases


def wkv_case(name, b, s, cfg, dtype, gen, device, *, with_s0=False,
             **counts):
    """The WKV recurrence at the config's heads (RWKV6-3B: 40 of 64),
    r/k/v/lw in ``dtype`` (the model feeds fp32), decays spread over
    both clamp ends; checked against the plain chunked scan on fp32
    copies of the same inputs, y and the final state each."""
    import torch
    from repro_torch.kernels.wkv import pick_design, wkv_p
    from repro_torch.models.rwkv6 import CLAMP, wkv_chunked

    p = cfg.rwkv.head_dim
    h = cfg.d_model // p
    r, k, v = (_rand(gen, (b, s, h, p), dtype, device) for _ in range(3))
    lw = torch.clamp(-torch.exp(_rand(gen, (b, s, h, p), torch.float32,
                                      device, 2.0)), -CLAMP, -1e-6).to(dtype)
    u = _rand(gen, (h, p), torch.float32, device, 0.5)
    s0 = _rand(gen, (b, h, p, p), torch.float32, device) if with_s0 else None
    f32 = [t.float() for t in (r, k, v, lw)]
    # what this run's data needs: per chunk of n real tokens, A and A @ v
    # (2 n^2 P each) and rd @ S and the state update (2 n P^2 each)
    chunks = [min(16, s - t0) for t0 in range(0, s, 16)]
    flops = b * h * sum(4 * n * p * (n + p) for n in chunks)
    return Case(
        "wkv", f"{name} B={b} S={s} H={h} P={p}" + (" +s0" if with_s0
                                                   else ""),
        lambda: wkv_p(r, k, v, lw, u, s0=s0),
        lambda: wkv_chunked(*f32, u, s0=s0),
        lambda: wkv_chunked(*f32, u, s0=s0), None, flops,
        nbytes(r, k, v, lw, u, s0, out=(r.numel(), dtype)) + b * h * p * p * 4,
        design=pick_design(s), **counts)


def rwkv_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of an RWKV6-3B prefill at B=4 x 512
    (M=2048) and of a decode step at B=4 (M=4), with its launches per
    prefill and per step, plus a ragged WKV call (B=1 x 333)."""
    import torch
    d, f, lora, n_layers = (cfg.d_model, cfg.d_ff, cfg.rwkv.decay_lora,
                            cfg.n_layers)
    # the model feeds the recurrence fp32 in either dtype (rwkv6.apply
    # casts r, k, v): the bf16 WKV cases hold the kernel's bf16-input leg
    # and are on no model path
    n_wkv = n_layers if dtype == torch.float32 else 0
    cases = []
    for m, key in ((4 * 512, "prefill"), (4, "decode")):
        cases += [
            # wr wk wv wg wo of the time-mix and wr of the channel-mix
            matmul_case(f"rwkv.{key} d x d", m, d, d, dtype, gen, device,
                        bias=False, **{key: 6 * n_layers}),
            matmul_case(f"rwkv.{key} lora_a fp32-out", m, d, lora, dtype, gen,
                        device, bias=False, out_f32=True, **{key: n_layers}),
            matmul_case(f"rwkv.{key} lora_b fp32-out", m, lora, d, dtype, gen,
                        device, bias=False, out_f32=True, **{key: n_layers}),
            matmul_case(f"rwkv.{key} cmix wk+relu2", m, d, f, dtype, gen,
                        device, bias=False, act="relu2", **{key: n_layers}),
            matmul_case(f"rwkv.{key} cmix wv", m, f, d, dtype, gen, device,
                        bias=False, **{key: n_layers}),
            # norm1, the time-mix ln, norm2
            layernorm_case(f"rwkv.{key} ln", m, d, dtype, gen, device,
                           **{key: 3 * n_layers}),
        ]
    # the head and the final norm run on the last position only
    cases += [
        matmul_case("rwkv lm_head fp32-out", 4, d, cfg.vocab, dtype, gen,
                    device, bias=False, out_f32=True, prefill=1, decode=1),
        layernorm_case("rwkv final_norm", 4, d, dtype, gen, device,
                       prefill=1, decode=1),
        wkv_case("rwkv.prefill wkv", 4, 512, cfg, dtype, gen, device,
                 prefill=n_wkv),
        wkv_case("rwkv.decode wkv", 4, 1, cfg, dtype, gen, device,
                 with_s0=True, decode=n_wkv),
        wkv_case("rwkv ragged wkv", 1, 333, cfg, dtype, gen, device),
    ]
    return cases


def dense_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a deepseek-7b prefill at B=4 x 512
    (M=2048), fused and unfused, and of a fused decode step at B=4 (M=4),
    with its launches per prefill and per step. Fused, per layer: the
    qkv panel with the RMS norm (in the prologue, or standalone where it
    splits: :func:`norm_matmul_cases`), wo with the residual, the gate|up
    panel with the norm and SwiGLU, the down projection with the
    residual. Unfused, per layer: two RMS norms, q, k and v over column
    slices of the qkv panel, wo, gate+silu and up over the halves of the
    gate|up panel, down (the residual adds in torch). Causal attention
    at prefill (decode attends in torch ops); the final norm and the
    head on the last position only."""
    from repro_torch.models import attention, lm
    d, f, n_layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    splits = attention.proj_splits(cfg)
    qkv, ho = sum(splits), cfg.n_heads * cfg.head_dim
    cases = []
    for m, key in ((4 * 512, "dprefill"), (4, "ddecode")):
        tag = f"dense.{'prefill' if m > 4 else 'decode'}"
        cases += norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen,
                                   device, norm="rms", bias=False,
                                   **{key: n_layers})
        cases += norm_matmul_cases(f"{tag} gate|up+silu", m, d, f, dtype,
                                   gen, device, norm="rms", bias=False,
                                   act="silu", gated=True, panel=(2 * f, 0),
                                   **{key: n_layers})
        cases += [
            matmul_case(f"{tag} wo+res", m, ho, d, dtype, gen, device,
                        bias=False, residual=True, **{key: n_layers}),
            matmul_case(f"{tag} down+res", m, f, d, dtype, gen, device,
                        bias=False, residual=True, **{key: n_layers}),
        ]
    m, tag = 4 * 512, "dense.unfused"
    # q, k and v share one shape when the heads have no GQA (deepseek-7b)
    assert len(set(splits)) == 1, splits
    cases += [
        layernorm_case(f"{tag} norm", m, d, dtype, gen, device, kind="rms",
                       dunfused=2 * n_layers),
        matmul_case(f"{tag} q|k|v", m, d, splits[0], dtype, gen, device,
                    bias=False, panel=(qkv, 0), dunfused=3 * n_layers),
        matmul_case(f"{tag} wo", m, ho, d, dtype, gen, device, bias=False,
                    dunfused=n_layers),
        matmul_case(f"{tag} gate+silu", m, d, f, dtype, gen, device,
                    bias=False, act="silu", panel=(2 * f, 0),
                    dunfused=n_layers),
        matmul_case(f"{tag} up", m, d, f, dtype, gen, device, bias=False,
                    panel=(2 * f, f), dunfused=n_layers),
        matmul_case(f"{tag} down", m, f, d, dtype, gen, device, bias=False,
                    dunfused=n_layers),
        matmul_case("dense lm_head fp32-out", 4, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True, dprefill=1,
                    ddecode=1, dunfused=1),
        layernorm_case("dense final_norm", 4, d, dtype, gen, device,
                       kind="rms", dprefill=1, ddecode=1, dunfused=1),
        attention_case("dense.prefill causal", (4, 512, cfg.head_dim),
                       cfg.n_heads, cfg.n_kv_heads, dtype, gen, device,
                       causal=True, dprefill=n_layers, dunfused=n_layers),
    ]
    return cases


def gemma_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a gemma3-27b prefill at B=2 x 2048
    (M=4096) and of a decode step at B=2 (M=2), with its launches per
    prefill and per step of the model the phase runs in ``dtype`` (fp32:
    8 layers, 7 local and 1 global; bf16: all 62, 52 local and 10
    global). Per layer: the qkv panel (32 q and 2 x 16 kv heads of 128)
    and the gate|up panel (GeGLU) with the RMS norm (split or not:
    :func:`norm_matmul_cases`), wo and down with the residual; causal
    attention at prefill, with the 1024-token window on the local layers
    (GQA 32 over 16, head dim 128; decode attends in torch ops); the
    tied head (N = 262144, fp32 out) and the final norm on the last
    position only."""
    import torch
    from repro_torch.models import attention, lm
    n_layers = 8 if dtype == torch.float32 else cfg.n_layers
    stages = dataclasses.replace(cfg, n_layers=n_layers).stages()
    local = sum(st.repeat * sum(1 for b in st.body if b.window)
                for st in stages)
    d, f = cfg.d_model, cfg.d_ff
    qkv, ho = sum(attention.proj_splits(cfg)), cfg.n_heads * cfg.head_dim
    cases = []
    for m, key in ((2 * 2048, "gprefill"), (2, "gdecode")):
        tag = f"gemma.{'prefill' if m > 2 else 'decode'}"
        cases += norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen,
                                   device, norm="rms", bias=False,
                                   **{key: n_layers})
        cases += norm_matmul_cases(f"{tag} gate|up+gelu", m, d, f, dtype,
                                   gen, device, norm="rms", bias=False,
                                   act="gelu", gated=True, panel=(2 * f, 0),
                                   **{key: n_layers})
        cases += [
            matmul_case(f"{tag} wo+res", m, ho, d, dtype, gen, device,
                        bias=False, residual=True, **{key: n_layers}),
            matmul_case(f"{tag} down+res", m, f, d, dtype, gen, device,
                        bias=False, residual=True, **{key: n_layers}),
        ]
    shape = (2, 2048, cfg.head_dim)
    cases += [
        matmul_case("gemma tied head fp32-out", 2, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True,
                    gprefill=1, gdecode=1),
        layernorm_case("gemma final_norm", 2, d, dtype, gen, device,
                       kind="rms", gprefill=1, gdecode=1),
        attention_case("gemma.prefill causal+window", shape, cfg.n_heads,
                       cfg.n_kv_heads, dtype, gen, device, causal=True,
                       window=cfg.local_window, gprefill=local),
        attention_case("gemma.prefill causal", shape, cfg.n_heads,
                       cfg.n_kv_heads, dtype, gen, device, causal=True,
                       gprefill=n_layers - local),
    ]
    return cases


def whisper_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a whisper-base prefill at B=4 x 64
    tokens over 1500 frames and of a decode step at B=4, with its
    launches per prefill (the encoder's included) and per step. Encoder
    (M = 6000), per layer: qkv and mlp1 (GELU) with the LayerNorm (split
    or not: :func:`norm_matmul_cases`), wo and mlp2 with the residual,
    causal self-attention over the 1500 frames (as the JAX encoder runs
    it); then its final norm. Decoder (M = 256 at prefill, 4 at decode),
    per layer: qkv and mlp1 as in the encoder, wo and mlp2 with the
    residual, the standalone cross norm, wq, the cross wo; at prefill
    causal self-attention, the fused wkv panel over the encoder's output
    and cross-attention of 64 queries to the 1500 frames (decode attends
    in torch ops). The tied head (N = 51968, the padded vocabulary,
    fp32 out) and the final norm on the last position."""
    from repro_torch.models import lm
    d, f, hd, h = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_heads
    n_enc, n_dec, frames = cfg.n_enc_layers, cfg.n_layers, cfg.cross_len
    m_enc = 4 * frames
    cases = []
    for m, key, tag, layers in ((m_enc, "wprefill", "whisper.encoder",
                                 n_enc),
                                (4 * 64, "wprefill", "whisper.prefill",
                                 n_dec),
                                (4, "wdecode", "whisper.decode", n_dec)):
        cases += norm_matmul_cases(f"{tag} qkv", m, d, 3 * d, dtype, gen,
                                   device, norm="layer", bias=False,
                                   **{key: layers})
        cases += norm_matmul_cases(f"{tag} mlp1+gelu", m, d, f, dtype, gen,
                                   device, norm="layer", bias=False,
                                   act="gelu", **{key: layers})
        cases += [
            matmul_case(f"{tag} wo+res", m, d, d, dtype, gen, device,
                        bias=False, residual=True, **{key: layers}),
            matmul_case(f"{tag} mlp2+res", m, f, d, dtype, gen, device,
                        bias=False, residual=True, **{key: layers}),
        ]
        if tag != "whisper.encoder":
            cases += [
                layernorm_case(f"{tag} cross norm", m, d, dtype, gen,
                               device, **{key: n_dec}),
                matmul_case(f"{tag} cross wq", m, d, d, dtype, gen, device,
                            bias=False, **{key: n_dec}),
                matmul_case(f"{tag} cross wo", m, d, d, dtype, gen, device,
                            bias=False, **{key: n_dec}),
            ]
    cases += [
        layernorm_case("whisper.encoder final_norm", m_enc, d, dtype, gen,
                       device, wprefill=1),
        matmul_case("whisper.prefill cross wkv", m_enc, d, 2 * d, dtype, gen,
                    device, bias=False, wprefill=n_dec),
        attention_case("whisper.encoder causal", (4, frames, hd), h, h,
                       dtype, gen, device, causal=True, wprefill=n_enc),
        attention_case("whisper.prefill causal", (4, 64, hd), h, h, dtype,
                       gen, device, causal=True, wprefill=n_dec),
        attention_case("whisper.prefill cross", (4, 64, hd), h, h, dtype,
                       gen, device, skv=frames, wprefill=n_dec),
        # off the path: the encoder's frames without the causal mask
        attention_case("whisper 1500 non-causal", (4, frames, hd), h, h,
                       dtype, gen, device),
        matmul_case("whisper tied head fp32-out", 4, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True, wprefill=1,
                    wdecode=1),
        layernorm_case("whisper final_norm", 4, d, dtype, gen, device,
                       wprefill=1, wdecode=1),
    ]
    return cases


def int8_cases(cfg, rwkv_cfg, batch, gen, device):
    """The int8 W8A8 leg at every distinct Swin-T matmul shape (B=8, with
    its launches per fused forward, which the int8 path replays) and at
    RWKV6-3B's matmul widths at M=2048 and M=4, plus a gated call."""
    import torch
    i8 = torch.int8
    res, c = cfg.img_size // cfg.patch, cfg.embed_dim
    cases = [matmul_case("int8 patch", batch * res * res,
                         cfg.patch ** 2 * cfg.in_chans, c, i8, gen, device,
                         fused=1)]
    for si, depth in enumerate(cfg.depths):
        m, s = batch * res * res, f"int8 s{si + 1}"
        cases += [
            matmul_case(f"{s}.qkv", m, c, 3 * c, i8, gen, device,
                        fused=depth),
            matmul_case(f"{s}.proj+res", m, c, c, i8, gen, device,
                        residual=True, fused=depth),
            matmul_case(f"{s}.mlp1+gelu", m, c, 4 * c, i8, gen, device,
                        act="gelu", fused=depth),
            matmul_case(f"{s}.mlp2+res", m, 4 * c, c, i8, gen, device,
                        residual=True, fused=depth),
        ]
        if si < len(cfg.depths) - 1:
            cases.append(matmul_case(f"{s}.merge", m // 4, 4 * c, 2 * c, i8,
                                     gen, device, bias=False, fused=1))
            res, c = res // 2, c * 2
    cases += [
        matmul_case("int8 head", batch, c, cfg.num_classes, i8, gen, device,
                    fused=1),
        matmul_case("int8 gated+silu", 1024, 384, 1536, i8, gen, device,
                    act="silu", gated=True),
    ]
    d, f, lora = rwkv_cfg.d_model, rwkv_cfg.d_ff, rwkv_cfg.rwkv.decay_lora
    rgen = torch.Generator(device=device).manual_seed(4)
    for m in (4 * 512, 4):
        cases += [
            matmul_case(f"int8 rwkv d x d M={m}", m, d, d, i8, rgen, device,
                        bias=False),
            matmul_case(f"int8 rwkv lora_a M={m}", m, d, lora, i8, rgen,
                        device, bias=False),
            matmul_case(f"int8 rwkv lora_b M={m}", m, lora, d, i8, rgen,
                        device, bias=False),
            matmul_case(f"int8 rwkv cmix wk+relu2 M={m}", m, d, f, i8, rgen,
                        device, bias=False, act="relu2"),
            matmul_case(f"int8 rwkv cmix wv M={m}", m, f, d, i8, rgen,
                        device, bias=False),
        ]
    cases.append(matmul_case("int8 rwkv lm_head", 4, d, rwkv_cfg.vocab, i8,
                             rgen, device, bias=False))
    return cases


def threshold_readings(device):
    """Device µs per call of the skinny design against the M > 16 design
    of each dtype (wgmma for bf16, ffma for fp32) at M = 4 .. 16, at the
    RWKV6-3B d x d shape with its weights cold in L2: the measurement
    behind ``SKINNY_PICK_M``."""
    import torch
    from repro_torch.kernels import rowwise_matmul as rm
    from repro_torch.launch.profile import kernel_us
    out = {}
    for dt, other in ((torch.bfloat16, "wgmma"), (torch.float32, "ffma")):
        ws = [(torch.randn(2560, 2560, device=device) * 0.02).to(dt)
              for _ in range(int(-(-COLD_BYTES // (2560 * 2560 * 2))) + 1)]
        pick = rm.SKINNY_PICK_M[dt]
        for m in (4, 8, 12, 16):
            x = torch.randn(m, 2560, device=device).to(dt)
            # the picker's threshold moved so that M takes each design
            for design, upto in (("skinny", 16), (other, 0)):
                def run():
                    for w in ws:
                        rm.rowwise_matmul_p(x, w)
                rm.SKINNY_PICK_M[dt] = upto
                try:
                    out[f"{dt} M={m} {design}"] = kernel_us(
                        run, "rowwise_matmul_kernel", 5)
                finally:
                    rm.SKINNY_PICK_M[dt] = pick
    say("threshold", "device µs per call, M x 2560 x 2560, weights cold: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def wkv_threshold_readings(cfg, device):
    """Device µs per call of WKV's step design against its chunk design
    at S = 1 .. 32 tokens, B=4 at the config's heads, fp32, with a
    starting state (the decode step's shape at S=1): the measurement
    behind ``STEP_PICK_S``. Each design's output is held against the
    plain scan as well."""
    import torch
    from repro_torch.kernels import wkv as wk
    from repro_torch.launch.profile import kernel_us
    from repro_torch.models.rwkv6 import CLAMP, wkv_chunked
    p = cfg.rwkv.head_dim
    h = cfg.d_model // p
    gen = torch.Generator(device=device).manual_seed(6)
    pick, out = wk.STEP_PICK_S, {}
    for s in (1, 2, 4, 8, 16, 32):
        r, k, v = (_rand(gen, (4, s, h, p), torch.float32, device)
                   for _ in range(3))
        lw = torch.clamp(-torch.exp(_rand(gen, (4, s, h, p), torch.float32,
                                          device, 2.0)), -CLAMP, -1e-6)
        u = _rand(gen, (h, p), torch.float32, device, 0.5)
        s0 = _rand(gen, (4, h, p, p), torch.float32, device)
        want = wkv_chunked(r, k, v, lw, u, s0=s0)
        for design, upto in (("step", 1 << 30), ("chunk", 0)):
            wk.STEP_PICK_S = upto
            try:
                got = wk.wkv_p(r, k, v, lw, u, s0=s0)
                out[f"S={s} {design}"] = kernel_us(
                    lambda: wk.wkv_p(r, k, v, lw, u, s0=s0), "wkv_kernel")
            finally:
                wk.STEP_PICK_S = pick
            for g, w in zip(got, want):
                err, ok = err_ok(g, w, FP32_TOL)
                if not ok:
                    raise AssertionError(f"wkv {design} at S={s}: max abs "
                                         f"err {err}")
    say("threshold", f"wkv device µs per call, B=4 x {h} heads of {p}, "
        f"fp32, with s0 (STEP_PICK_S={pick}): " + ", ".join(
            f"{k} {v:.2f}" for k, v in out.items()))
    return out


def layernorm_threshold_readings(device):
    """Device µs per call of layernorm's cta design against its rows
    design at M = 1 .. 2048 rows of D = 96 .. 768 (Swin-T's stages,
    ViT-B/16) and 2560 (RWKV6-3B), fp32 and bf16, with beta, x warm in L2
    as the model leaves it: the measurement behind ``CTA_PICK_M``. Each
    design's output is held against the plain version as well."""
    import torch
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import ref
    from repro_torch.launch.profile import kernel_us
    gen = torch.Generator(device=device).manual_seed(8)
    pick, out = dict(ln.CTA_PICK_M), {}
    for dt, name, tol in ((torch.float32, "fp32", FP32_TOL),
                          (torch.bfloat16, "bf16", BF16_TOL)):
        for d in (96, 192, 384, 768, 2560):
            g = 1 + _rand(gen, (d,), dt, device, 0.1)
            b = _rand(gen, (d,), dt, device, 0.1)
            for m in (1, 4, 16, 64, 132, 196, 264, 392, 528, 784, 1056,
                      1568, 2048):
                x = _rand(gen, (m, d), dt, device)
                want = ref.layernorm_ref(x.float(), g, b)
                for design, upto in (("cta", 1 << 30), ("rows", 0)):
                    ln.CTA_PICK_M[dt] = upto
                    try:
                        got = ln.layernorm_p(x, g, b)
                        out[f"{name} D={d} M={m} {design}"] = kernel_us(
                            lambda: ln.layernorm_p(x, g, b),
                            "layernorm_kernel")
                    finally:
                        ln.CTA_PICK_M[dt] = pick[dt]
                    err, ok = err_ok(got, want, tol)
                    if not ok:
                        raise AssertionError(
                            f"layernorm {design} {name} at M={m} D={d}: "
                            f"max abs err {err}")
    say("threshold", "layernorm device µs per call (CTA_PICK_M: "
        f"fp32 {pick[torch.float32]}, bf16 {pick[torch.bfloat16]}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


# the prologue threshold line: (design, dtype, M of the LM panels (the
# deepseek-7b and gemma3-27b prefill M for wgmma / ffma), the batch of
# the vision panels) and the K it sweeps
PROLOGUE_DESIGNS = (("skinny", "fp32", (16, 16), 0),
                    ("skinny", "bf16", (4, 4), 0),
                    ("ffma", "fp32", (2048, 4096), 8),
                    ("wgmma", "bf16", (2048, 4096), 8))
PROLOGUE_KS = (64, 96, 128, 192, 256, 320, 384, 512, 768, 1024, 2048, 4096,
               5376, 8192)


def _prologue_panels(k, m_lm, batch):
    """(width, N, gated, M) of each panel with a norm prologue at K: the
    LM panels of deepseek-7b (qkv N = 12288, gate|up gated N = 11008)
    and gemma3-27b (qkv 8192, gate|up gated 21504) at every K; and at
    the K of a Swin-T stage (or ViT-B/16's 768), its qkv (N = 3K) and
    its GELU mlp1 (N = 4K) at B = ``batch`` images."""
    panels = [("deepseek qkv", 12288, False, m_lm[0]),
              ("deepseek gate|up", 11008, True, m_lm[0]),
              ("gemma qkv", 8192, False, m_lm[1]),
              ("gemma gate|up", 21504, True, m_lm[1])]
    swin = {96: 3136, 192: 784, 384: 196, 768: 49}
    if batch and k in swin:
        for name, tokens in (("swin-t", swin[k]),) + (
                (("vit-b16", 197),) if k == 768 else ()):
            panels += [(f"{name} qkv", 3 * k, False, batch * tokens),
                       (f"{name} mlp1", 4 * k, False, batch * tokens)]
    return panels


def prologue_threshold_readings(device):
    """Device µs per call of a matmul with its RMS norm in the kernel's
    prologue against the standalone norm and the matmul without one (the
    route ``ops`` takes where ``norm_prologue_fits`` is false), per
    design and dtype at K = 64 .. 8192 on the panels of
    :func:`_prologue_panels`; the skinny design at its largest M, its
    weights cold in L2. Returns the readings and, per design, the
    largest K of the sweep up to which the prologue is at or ahead of
    the split at one panel at least (from the first K where the split is
    ahead at every panel, it takes over), beside the rule's boundary
    (``SKINNY_NORM_MAX_K`` for the skinny design, none for the others).
    Raises where the prologue of a design the rule never gives it holds
    at some K: the rule is then stale."""
    import torch
    from repro_torch.kernels import rowwise_matmul as rm
    from repro_torch.kernels.layernorm import layernorm_p
    from repro_torch.launch.profile import kernel_us
    dts = {"fp32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device=device).manual_seed(9)
    out, fits = {}, {}
    for design, name, m_lm, batch in PROLOGUE_DESIGNS:
        dt = dts[name]
        holds = {}
        for k in PROLOGUE_KS:
            g = 1 + _rand(gen, (k,), dt, device, 0.1)
            for width, n, gated, m in _prologue_panels(k, m_lm, batch):
                assert rm.pick_design(m, dt) == design
                x = _rand(gen, (m, k), dt, device)
                size = k * n * (2 if gated else 1) * x.element_size()
                copies = (int(-(-COLD_BYTES // size)) + 1
                          if design == "skinny" and size < COLD_BYTES else 1)
                ws = [(_rand(gen, (k, n), dt, device, k ** -0.5),
                       _rand(gen, (k, n), dt, device, k ** -0.5)
                       if gated else None) for _ in range(copies)]
                act = "gelu" if gated else None

                def fused():
                    for w, wg in ws:
                        rm.rowwise_matmul_p(x, w, w_gate=wg, activation=act,
                                            prologue="rms", gamma=g)

                def split():
                    for w, wg in ws:
                        rm.rowwise_matmul_p(layernorm_p(x, g, kind="rms"),
                                            w, w_gate=wg, activation=act)
                want = rm.rowwise_matmul_p(x, ws[0][0], w_gate=ws[0][1],
                                           activation=act, prologue="rms",
                                           gamma=g)
                got = rm.rowwise_matmul_p(layernorm_p(x, g, kind="rms"),
                                          ws[0][0], w_gate=ws[0][1],
                                          activation=act)
                err, ok = err_ok(got, want, FP32_TOL if name == "fp32"
                                 else BF16_TOL)
                if not ok:
                    raise AssertionError(f"prologue threshold {design} "
                                         f"{name} K={k} {width}: split "
                                         f"against fused max abs err {err}")
                calls = 5 if design != "skinny" else 10
                f_us = kernel_us(fused, "rowwise_matmul_kernel", calls)
                s_us = (kernel_us(split, "rowwise_matmul_kernel", calls)
                        + kernel_us(lambda: layernorm_p(x, g, kind="rms"),
                                    "layernorm_kernel", calls))
                out[f"{design} {name} M={m} K={k} N={n} {width}"] = {
                    "fused_us": f_us, "split_us": s_us}
                holds[k] = holds.get(k, False) or f_us <= s_us
        fits[f"{design} {name}"] = max(
            [0] + [k for k in PROLOGUE_KS
                   if all(holds[j] for j in PROLOGUE_KS if j <= k)])
    say("threshold", "norm prologue, device µs per call fused / split "
        "(layernorm_p + the matmul without a prologue): " + ", ".join(
            f"{k} {v['fused_us']:.2f} / {v['split_us']:.2f}"
            for k, v in out.items()))
    rule = {k: rm.SKINNY_NORM_MAX_K if k.startswith("skinny") else 0
            for k in fits}
    say("threshold", "norm prologue at or ahead of the split at one panel "
        "at least, up to K: " + ", ".join(
            f"{k} {v} (rule {rule[k]}: "
            f"{'agrees' if v == rule[k] else 'differs'})"
            for k, v in fits.items()))
    stale = [k for k in fits if not k.startswith("skinny") and fits[k]]
    if stale:
        raise AssertionError(f"norm prologue of {stale} holds up to K = "
                             f"{[fits[k] for k in stale]}; the rule never "
                             "keeps it there")
    return {"readings": out, "prologue_holds_up_to_k": fits,
            "rule_max_k": rule}


def readings_apart(name, call):
    """``call`` (text: a call of this module's, where ``get_config`` is
    the port's) in a process of its own, the card's library already
    built; its result comes back through ``chiprun_out/<name>.json``.
    The threshold sweeps run so: the profiles they take, on top of the
    rest of this script's, have left the profiler recording no kernel
    at all (the prologue sweep's ~2,700 in one run, the layernorm
    sweep's after it in another; PERF.md)."""
    out = ROOT / "chiprun_out" / f"{name}.json"
    out.parent.mkdir(exist_ok=True)
    code = (f"import json, sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]; import chip_smoke as c; "
            "from repro_torch.configs import get_config; "
            f"r = c.{call}; open({str(out)!r}, 'w').write(json.dumps(r))")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    return json.loads(out.read_text())


def int8_path(cases):
    """``ops.matmul_int8`` at every Swin-T matmul shape, each as often as
    a fused forward runs it, with the launch counts set to 0 just before
    and read just after."""
    import torch
    from repro_torch.kernels import ops
    swin = [c for c in cases if c.counts["fused"]]

    def drive():
        outs = []
        for case in swin:
            o, kw = case.op, case.op["ops"]
            for _ in range(case.counts["fused"]):
                outs.append(ops.matmul_int8(
                    o["x"], o["w"], kw["x_scale"], kw["w_scale"],
                    bias=kw["bias"], activation=kw["activation"],
                    residual=kw["residual"]))
        return outs
    outs, counts = counted(drive)
    want = {"rowwise_matmul": sum(c.counts["fused"] for c in swin),
            "flash_attention": 0, "layernorm": 0, "wkv": 0}
    finite = all(torch.isfinite(o).all().item() for o in outs)
    # the path's device time by matmul design, from the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drive()
        torch.cuda.synchronize()
    device_ms = {}
    for evt in prof.key_averages():
        if "rowwise_matmul_kernel" in evt.key:
            design = ("skinny" if "skinny" in evt.key else
                      "wgmma" if "wgmma" in evt.key else "ffma")
            device_ms[design] = device_ms.get(design, 0.0) + getattr(
                evt, "self_device_time_total",
                getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
    say("int8-path", f"ops.matmul_int8 at every Swin-T matmul shape, B=8: "
                     f"launches {counts}, outputs finite: {finite}, device "
                     "ms by design " + ", ".join(
                         f"{k} {v:.4f}" for k, v in device_ms.items()))
    if counts != want or not finite:
        raise AssertionError(f"int8 path: launches {counts}, want {want}")
    return counts, device_ms


def run_cases(cases, dtype_name, tol, timed=True):
    from repro_torch.launch.profile import kernel_us
    rows = []
    for case in cases:
        out, want = case.run(), case.check()
        if not isinstance(out, tuple):          # wkv: (y, final state)
            out, want = (out,), (want,)
        errs = [err_ok(o, w, tol) for o, w in zip(out, want)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        row = {"kernel": case.kernel, "case": case.name, "dtype": dtype_name,
               **case.counts, "max_abs_err": err, "tol": tol,
               "design": case.design}
        if len(errs) > 1:
            row["errs"] = [e for e, _ in errs]
        b_ms, b_by = bound(case.flops, case.nbytes, dtype_name)
        row.update(flops=case.flops, bytes=case.nbytes, bound_ms=b_ms,
                   bound_by=b_by)
        if timed:
            row.update(ms=cuda_time(case.run), plain_ms=cuda_time(case.plain),
                       library_ms=(cuda_time(case.library) if case.library
                                   else None))
        if timed and case.kernel == "layernorm":
            # a norm call is short, so its event time is mostly host: the
            # profiler's device time, the kernel's and F.layer_norm's (one
            # kernel a call at these widths)
            row.update(device_ms=kernel_us(case.run, "layernorm_kernel")
                       / 1e3,
                       library_device_ms=kernel_us(case.library, None)
                       / 1e3)
        elif timed and any(case.counts[k] for k in ("vit", "gprefill",
                                                     "gdecode", "wprefill",
                                                     "wdecode")):
            # the device ms of the ViT-B/16 attention and of every kernel
            # call of the gemma3-27b and whisper-base paths
            row["device_ms"] = kernel_us(
                case.run, "attention_kernel" if case.kernel ==
                "flash_attention" else "rowwise_matmul_kernel",
                5 if case.flops > 1e12 else 20) / 1e3
        say("kernels", " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else
            f"{k}={'none' if v is None else v}"
            for k, v in row.items() if k not in ("flops", "bytes", "tol")))
        if not ok:
            raise AssertionError(f"{case.kernel} {case.name} {dtype_name}: "
                                 f"max abs err {err} over tolerance {tol}")
        rows.append(row)
    return rows


# ------------------------------ model phases ----------------------------


def launches():
    from repro_torch.kernels.flash_attention import flash_attention_p
    from repro_torch.kernels.layernorm import layernorm_p
    from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
    from repro_torch.kernels.wkv import wkv_p
    return {"rowwise_matmul": rowwise_matmul_p,
            "flash_attention": flash_attention_p, "layernorm": layernorm_p,
            "wkv": wkv_p}


def counted(fn):
    """Run fn with every launch count (and the attention's counts by
    mode, :func:`attention_modes`) set to 0 just before; return its
    result and the counts just after."""
    import torch
    for k in launches().values():
        k.launches = 0
    launches()["flash_attention"].modes.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in launches().items()}


def attention_modes():
    """The attention launches by mode (``flash_attention.mode_of``) since
    the last :func:`counted` began."""
    return dict(launches()["flash_attention"].modes)


def jitter(params, gen):
    """Random vector parameters (biases, norm gains, rel-pos tables)
    around the initializer's constants, so the forward checks exercise
    them."""
    import torch
    for value in (params.values() if isinstance(params, dict) else params):
        if isinstance(value, (dict, list)):
            jitter(value, gen)
        elif isinstance(value, torch.Tensor) and value.dim() == 1:
            value.add_(_rand(gen, value.shape, value.dtype, value.device, 0.1))


def check_forward(phase, model, images, want_counts, tol):
    import torch
    from repro_torch.core import runtime
    with torch.no_grad():
        logits, counts = counted(lambda: model(images))
        with runtime.use_impl("ref"):
            want = model(images)
    err, ok = err_ok(logits, want, tol)
    say(phase, f"logits {tuple(logits.shape)} max|logit|="
               f"{want.abs().max().item():.4g} max_abs_err={err:.4g} "
               f"tol={tol}*max(1,max|logit|) launches={counts}")
    if logits.shape != (images.shape[0], model.cfg.num_classes) or not ok:
        raise AssertionError(f"{phase}: logits disagree with the plain path")
    if counts != want_counts:
        raise AssertionError(f"{phase}: launches {counts}, want {want_counts}")
    return logits, counts


def images_per_s(model, images, iters=10):
    import torch
    with torch.no_grad():
        model(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(images)
        torch.cuda.synchronize()
    return images.shape[0] * iters / (time.perf_counter() - t0)


# ------------------------------ RWKV6-3B --------------------------------


def jitter_rwkv(tree, gen):
    """Spread the initializer's constant leaves so the checks exercise
    them: ``w0`` uniform over [-16, 2] (with the decay LoRA, -exp(w0 +
    lora) then reaches both clamp ends, -3.5 and -1e-6), the LoRA's
    zero ``w_lora_b``, the token-shift mixes, ``u`` and every norm."""
    import torch

    def rand(t):
        return torch.rand(t.shape, generator=gen, device=gen.device).to(t)

    for stage in tree["stages"]:
        for blk in stage["stacked"].values():
            tm, ffn = blk["tmix"], blk["ffn"]
            tm["w0"].copy_(rand(tm["w0"]) * 18 - 16)
            for t in (tm["mu"], ffn["mu_k"], ffn["mu_r"]):
                t.copy_(rand(t))
            tm["u"].add_(_rand(gen, tm["u"].shape, tm["u"].dtype,
                               tm["u"].device, 0.5))
            for t in (tm["w_lora_b"], tm["ln_g"], tm["ln_b"],
                      *blk["norm1"].values(), *blk["norm2"].values()):
                t.add_(_rand(gen, t.shape, t.dtype, t.device, 0.1))
    for t in tree["final_norm"].values():
        t.add_(_rand(gen, t.shape, t.dtype, t.device, 0.1))


def to_bf16(tree, key=None):
    """The tree in bf16 but for the fp32 leaves of the JAX package's bf16
    RWKV6 model (``u``, ``w0``)."""
    import torch
    if isinstance(tree, dict):
        return {k: to_bf16(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_bf16(v) for v in tree]
    return tree if key in ("u", "w0") else tree.to(torch.bfloat16)


def rwkv_state(cache):
    """The final WKV states of an RWKV6 cache (its first layer's)."""
    return [cache[0]["0"]["rwkv_t"]["wkv"]]


def kv_state(cache):
    """The K and V leaves of a dense cache, every layer."""
    return list(cache[0]["0"]["kv"])


def check_serving(phase, model, prompts, n_steps, tol, want_counts,
                  state=rwkv_state, want_decode=None, extra=None):
    """Greedy serving of a batch: the plain path on the card picks the
    tokens (prefill into a cache of S + ``n_steps``, then ``n_steps``
    decode steps); the kernel path runs teacher-forced on them, on a
    cache of its own. Its logits at prefill and at every step must sit
    within tol * max(1, max|logit|) of the plain path's, its greedy
    picks must equal the plain path's (a top-2 gap below the tolerance
    is reported, not failed), its final ``state`` leaves must agree,
    and each prefill must launch ``want_counts`` and each step
    ``want_decode`` (default the same). Then ``greedy`` on the kernels
    must give the plain path's stream up to each row's first near-tie.
    With ``tol=None`` the logits, picks, states and stream are
    readings, held only to be finite. ``extra``: the encoder's frames of
    an encoder-decoder model, given to each prefill."""
    import torch
    from repro_torch.core import runtime
    b, s = prompts.shape
    want_decode = want_decode or want_counts
    with torch.no_grad():
        with runtime.use_impl("ref"):
            lg, cache = model.prefill(prompts, alloc=s + n_steps,
                                      extra=extra)
            want, toks = [lg], [lg.argmax(-1)]
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=prompts.device)
            for i in range(n_steps):
                lg, cache = model.decode_step(cache, toks[-1][:, None],
                                              lengths + i)
                want.append(lg)
                toks.append(lg.argmax(-1))
        want_states = state(cache)
        got_lg, counts = counted(lambda: model.prefill(
            prompts, alloc=s + n_steps, extra=extra))
        modes = attention_modes()
        got, cache = [got_lg[0]], got_lg[1]
        all_counts = [counts]
        for i in range(n_steps):
            (lg, cache), counts = counted(
                lambda i=i: model.decode_step(cache, toks[i][:, None],
                                              lengths + i))
            got.append(lg)
            all_counts.append(counts)
        # the stream as a user asks for it: ``greedy`` on the kernels
        stream, greedy_counts = counted(
            lambda: model.greedy(prompts, n_steps + 1, extra=extra))
    limit = float("inf") if tol is None else tol
    # the real vocabulary's columns: the pad columns of a vocabulary
    # padded to 256 hold -1e30 on both paths, and would set the scale
    vocab = model.cfg.vocab
    got, want = ([t[..., :vocab] for t in ts] for ts in (got, want))
    ties, scale, step_errs = 0, 1.0, []
    first_tie = [n_steps + 1] * b     # per row, its first near-tie step
    for i, (g, w) in enumerate(zip(got, want)):
        err, ok = err_ok(g, w, limit)
        step_errs.append(err)
        scale = max(scale, w.abs().max().item())
        top2 = w.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        for row, gap in enumerate(gaps):
            if gap <= limit * max(1.0, w.abs().max().item()):
                first_tie[row] = min(first_tie[row], i)
        if g.shape != w.shape or not ok:
            raise AssertionError(f"{phase}: logits at step {i} off by {err}")
        picked = g.argmax(-1)
        for row in torch.nonzero(picked != toks[i]).flatten().tolist():
            top2 = w[row].topk(2).values
            gap = (top2[0] - top2[1]).item()
            if gap > limit * max(1.0, w.abs().max().item()):
                raise AssertionError(f"{phase}: step {i} row {row} picks "
                                     f"{picked[row].item()}, plain path "
                                     f"{toks[i][row].item()} (gap {gap})")
            ties += 1
    s_errs = [err_ok(g, w, limit) for g, w in zip(state(cache),
                                                  want_states)]
    s_err, s_ok = max(e for e, _ in s_errs), all(o for _, o in s_errs)
    bad = [c for c, w in zip(all_counts, [want_counts]
                             + [want_decode] * n_steps) if c != w]
    want_greedy = {k: want_counts[k] + n_steps * want_decode[k]
                   for k in want_counts}
    plain_stream = torch.stack(toks, 1)
    # greedy feeds its own picks back: it must give the plain path's
    # stream up to each row's first near-tie
    diverged = [row for row in range(b) if any(
        stream[row, :first_tie[row]] != plain_stream[row, :first_tie[row]])]
    same = (stream == plain_stream).float().mean().item()
    worst = max(step_errs)
    held = ("readings only; greedy picks differ at " if tol is None else
            f"tol={tol}*max(1,max|logit|); greedy picks equal but for ")
    say(phase, f"B={b} S={s} + {n_steps} steps: logits max|logit|="
               f"{scale:.4g} max_abs_err={worst:.4g} (prefill "
               f"{step_errs[0]:.4g}, last step {step_errs[-1]:.4g}) "
               f"{held}{ties} rows; final {state.__name__} "
               f"max_abs_err={s_err:.4g}; launches per prefill "
               f"{all_counts[0]} (attention by mode {modes}), per step "
               f"{all_counts[-1]}; greedy "
               f"stream on the kernels: {same:.3f} of its tokens equal "
               f"the plain path's, launches {greedy_counts}")
    if not s_ok:
        raise AssertionError(f"{phase}: final {state.__name__} off by "
                             f"{s_err}")
    if bad:
        raise AssertionError(f"{phase}: launches {bad[0]}, want "
                             f"{want_counts} per prefill, {want_decode} "
                             "per step")
    if greedy_counts != want_greedy:
        raise AssertionError(f"{phase}: greedy launches {greedy_counts}, "
                             f"want {want_greedy}")
    if tol is not None and diverged:
        raise AssertionError(f"{phase}: the greedy stream leaves the plain "
                             f"path's before a near-tie in rows {diverged}")
    return {"max_abs_err": worst, "step_errs": step_errs,
            "greedy_same": same,
            "max_logit": scale, "near_ties": ties,
            "state_err": s_err, "counts": all_counts[0],
            "prefill_modes": modes, "decode_counts": all_counts[-1],
            "tokens": torch.stack(toks, 1).tolist()}


def bf16_layers(phase, model16, prompts, frames=None):
    """Each layer of the bf16 model at prefill, run on the plain bf16
    path's input to it (so no error carries from layer to layer), against
    the same layer in fp32 on the same weights and input, as rms(err) /
    rms(out): the kernel path (held to ``BF16_LAYER_TOL``; fused or not
    as ``runtime.pipeline_fusion`` says), the plain bf16 path
    (bf16's own rounding, for scale) and a control in lower precision.
    ``frames``: an encoder-decoder's, whose encoder layers run first
    (windowless, as ``lm.encode`` runs them) and whose plain bf16 output
    every decoder layer's cross-attention reads (the fp32 layer its fp32
    copy). Returns the worst reading over layers of each path and the
    control's least."""
    import torch
    from repro_torch.core import runtime
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, lm, rope
    cfg, tree = model16.cfg, model16.params.tree()
    reads = {"kernels": [], "plain": [], "control": []}

    def layers(stages, tree_stages, x, positions, enc_out=None,
               window_override=None):
        for stage, sp in zip(stages, tree_stages):
            for rep in range(stage.repeat):
                for i, blk in enumerate(stage.body):
                    key = str(i)
                    bp = (lm._tree_map(lambda a, r=rep: a[r],
                                       sp["stacked"][key])
                          if key in sp["stacked"] else sp["shared"][key])

                    def run(params, inp, enc, blk=blk):
                        return blocks.apply_block(
                            blk, params, inp, cfg=cfg, mode="prefill",
                            positions=positions, enc_out=enc,
                            window_override=window_override)[0]
                    enc32 = None if enc_out is None else enc_out.float()
                    with runtime.use_impl("ref"):
                        plain = run(bp, x, enc_out)
                        want = run(lm._tree_map(lambda a: a.float(), bp),
                                   x.float(), enc32)
                    ways = {"kernels": run(bp, x, enc_out), "plain": plain,
                            "control": plain.to(torch.float8_e5m2)}
                    for way, o in ways.items():
                        d = o.float() - want
                        if not torch.isfinite(d).all():
                            raise AssertionError(f"bf16 layer {rep}: {way} "
                                                 "output not finite")
                        reads[way].append((d.square().mean().sqrt()
                                           / want.square().mean().sqrt())
                                          .item())
                    x = plain
        return x

    with torch.no_grad():
        enc_out = None
        if frames is not None:
            x = frames + rope.sinusoidal_embedding(
                frames.shape[1], cfg.d_model, frames.device).to(
                    frames.dtype)[None]
            x = layers(cfg.enc_stages(), tree["enc"]["stages"], x, None,
                       window_override=0)
            fn = tree["enc"]["final_norm"]
            with runtime.use_impl("ref"):
                enc_out = ops.layernorm(x, fn["g"], fn.get("b"),
                                        kind=cfg.norm)
        x = lm._add_positions(lm.embed(tree, prompts, cfg), cfg)
        layers(cfg.stages(), tree["stages"], x, lm._positions(prompts),
               enc_out)
    out = {"kernels_max": max(reads["kernels"]),
           "plain_max": max(reads["plain"]),
           "control_min": min(reads["control"]), "per_layer": reads}
    say(phase, "each layer on the plain bf16 input, against the same "
               "layer in fp32, rms(err)/rms(out): kernels max "
               f"{out['kernels_max']:.4g}, plain bf16 max "
               f"{out['plain_max']:.4g}, control (plain bf16 output in "
               f"float8_e5m2) min {out['control_min']:.4g}; tol "
               f"{BF16_LAYER_TOL}")
    if out["kernels_max"] > BF16_LAYER_TOL:
        raise AssertionError(f"{phase} layers: kernel path reads "
                             f"{out['kernels_max']}")
    if out["control_min"] <= BF16_LAYER_TOL:
        raise AssertionError(f"{phase} layers: the control passes the "
                             "limit")
    return out


def lm_rates(model, prompts, steps=8, extra=None):
    """Prefill tokens/s of the batch (an encoder-decoder's with its
    encoder over ``extra``'s frames) and decode tokens/s at its batch
    size (host clock around synchronised calls, after the checks have
    warmed every path)."""
    import torch
    b, s = prompts.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(prompts, alloc=s + steps, extra=extra)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        tok = lg.argmax(-1)[:, None]
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=prompts.device)
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = model.decode_step(cache, tok, lengths + i)
            tok = lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    return b * s / t_pre, b * steps / t_dec


# the skinny design's norm boundaries the decode A/B sets: the norm
# split from the matmul at deepseek-7b's and gemma3-27b's K (4096,
# 5376), and kept in the prologue there
SKINNY_AB_KS = (1024, 8192)


def skinny_norm_ab(name, models, prompts, smi, steps=16, rounds=3):
    """Decode tokens/s end to end (host clock around synchronised steps)
    of each of ``models`` ({label: model}) after a prefill of
    ``prompts``, with ``rowwise_matmul.SKINNY_NORM_MAX_K`` at each of
    :data:`SKINNY_AB_KS`, in ABBA order ``rounds`` times; every run
    decodes the same ``steps`` positions of one cache. The committed
    boundary is restored after."""
    import torch
    from repro_torch.kernels import rowwise_matmul as rm
    b, s = prompts.shape
    lengths = torch.full((b,), s, dtype=torch.int32, device=prompts.device)

    def rate(model, cache, tok):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = model.decode_step(cache, tok, lengths + i)
            tok = lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        return b * steps / (time.perf_counter() - t0)

    saved = rm.SKINNY_NORM_MAX_K
    out = {label: {str(k): [] for k in SKINNY_AB_KS} for label in models}
    try:
        with torch.no_grad():
            runs = {}
            for label, model in models.items():
                lg, cache = model.prefill(prompts, alloc=s + steps)
                runs[label] = (model, cache, lg.argmax(-1)[:, None])
                rate(*runs[label])          # a warm-up, not kept
            for _ in range(rounds):
                for k in SKINNY_AB_KS + SKINNY_AB_KS[::-1]:
                    rm.SKINNY_NORM_MAX_K = k
                    for label, run in runs.items():
                        out[label][str(k)].append(rate(*run))
    finally:
        rm.SKINNY_NORM_MAX_K = saved
    for label, by_k in out.items():
        med = {k: sorted(v)[len(v) // 2] for k, v in by_k.items()}
        kept, split = (med[str(k)] for k in SKINNY_AB_KS[::-1])
        say("threshold", f"skinny norm prologue end to end, {name} {label} "
            f"decode tokens/s at B={b} after {s} tokens ({steps} steps a "
            "run, ABBA): " + ", ".join(
                f"SKINNY_NORM_MAX_K={k} median {med[k]:.2f} of "
                + "/".join(f"{x:.2f}" for x in v) for k, v in by_k.items())
            + f"; kept / split {kept / split:.4f} (committed "
            f"{saved}) | {smi}")
    return out


def rwkv_phase(smi):
    """RWKV6-3B at full width and depth on the card: serving checks in
    fp32 and bf16, then prefill and decode rates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = get_config("rwkv6-3b")
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_rwkv(model.params.tree(),
                    torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    say("rwkv", f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
                f"{cfg.d_model // cfg.rwkv.head_dim} heads of "
                f"{cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
                f"{n_params / 1e9:.3f} B parameters, fp32, built in "
                f"{time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                            device="cuda")
    prompt1 = torch.randint(0, cfg.vocab, (1, 333), generator=gen,
                            device="cuda")
    counts = {"rowwise_matmul": 321, "flash_attention": 0, "layernorm": 97,
              "wkv": 32}
    out = {"params": n_params,
           "fp32_b4": check_serving("rwkv-fp32", model, prompts, 32,
                                    LOGIT_TOL, counts),
           "fp32_b1": check_serving("rwkv-fp32", model, prompt1, 8,
                                    LOGIT_TOL, counts)}
    model16 = lm.LanguageModel(cfg, to_bf16(model.params.tree()),
                               device="cuda")
    # at full depth bf16's rounding, carried through 32 layers, reads
    # within 13% of the kernel path's error (PERF.md), so no limit on the
    # logits tells a fault from rounding: readings here, and the bf16
    # path is held layer by layer
    out["bf16_b4"] = check_serving("rwkv-bf16", model16, prompts, 8, None,
                                   counts)
    out["bf16_layers"] = bf16_layers("rwkv-bf16", model16, prompts)
    # what bf16 alone does to the same prefill, kernels left out: the
    # scale of the full-depth readings
    with torch.no_grad(), runtime.use_impl("ref"):
        out["bf16_rounding"] = err_ok(model16.prefill(prompts)[0],
                                      model.prefill(prompts)[0], BF16_TOL)[0]
    say("rwkv-bf16", "plain bf16 against plain fp32 (same weights rounded)"
                     f", prefill logits: max_abs_err="
                     f"{out['bf16_rounding']:.4g}")
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32": lm_rates(model, prompts),
             "bf16": lm_rates(model16, prompts)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_impl("ref"):
        rates["plain_fp32"] = lm_rates(model, prompts)
    out.update(rates=rates, peak_memory_gib=peak_gb,
               seconds=time.perf_counter() - t_phase)
    say("throughput", "RWKV6-3B prefill tokens/s at B=4 x 512: " + ", ".join(
        f"{k} {v[0]:.1f}" for k, v in rates.items()) + "; decode tokens/s "
        "at B=4: " + ", ".join(f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {peak_gb:.2f} GiB (kernels, fp32 and bf16 models "
        f"resident) | {smi}")
    say("rwkv", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------ paged serving ---------------------------


def dense_oracle(model, prompt, n_new, tol):
    """The dense path's greedy stream of one prompt on the card, as
    ``lm.greedy`` runs it (prefill into a cache of plen + ``n_new``,
    then ``n_new`` - 1 steps feeding back the argmax). Its
    tokens, its first-token logits (the real vocabulary), each step's
    near-tie flag (top-2 gap within tol * max(1, max|logit|), the rule
    of :func:`check_serving`) and its final cache."""
    import torch
    vocab, plen = model.cfg.vocab, prompt.shape[0]
    toks, gaps, scales = [], [], []
    with torch.no_grad():
        lg, cache = model.prefill(prompt[None], alloc=plen + n_new)
        first = lg[0, :vocab].clone()
        lengths = torch.full((1,), plen, dtype=torch.int32,
                             device=prompt.device)
        for i in range(n_new):
            row = lg[0, :vocab]
            top2 = row.topk(2).values
            gaps.append(top2[0] - top2[1])
            scales.append(row.abs().max())
            toks.append(row.argmax())
            if i < n_new - 1:
                lg, cache = model.decode_step(cache, toks[-1].view(1, 1),
                                              lengths + i)
    ties = (torch.stack(gaps) <= tol * torch.stack(scales).clamp(min=1.0))
    return {"tokens": torch.stack(toks).tolist(), "first": first,
            "ties": ties.tolist(), "cache": cache}


class PagedServing:
    """Paged serving on the card, replayed on the host as the JAX
    engine's step programs run it (``src/repro/serve/engine.py``:
    ``admit_fn``, ``chunk_fn``, ``step_fn``, ``spec_fn``; tables shipped
    as ``_ship_tables`` ships them): a ``serve.paging.PagePool`` hands
    out pages; each step admits requests into free slots (bucketed
    one-shot prefill + ``insert_prefill``, or a chunk schedule), runs one
    chunk of each mid-prefill slot, then one lockstep paged decode step
    (or, once, a speculative verify over a panel of 1 + ``K_DRAFT``
    tokens and ``insert_verify`` with a fixed accept pattern), and
    retires finished slots, whose pages the next admissions reuse. Every
    call is counted and held to its launches; every request's greedy
    stream, first-token logits and pool rows are held to the dense
    path's (:func:`dense_oracle`)."""

    K_DRAFT = 3

    def __init__(self, phase, model, prompts, *, chunked, slots, page_size,
                 max_len, chunk, n_new, tol, want, accept, cow=False):
        import numpy as np
        import torch
        from repro_torch.models import lm
        from repro_torch.serve import paging
        self.np, self.torch, self.lm, self.paging = np, torch, lm, paging
        self.phase, self.model, self.prompts = phase, model, prompts
        self.cfg, self.tree = model.cfg, model.params.tree()
        self.chunked, self.slots, self.ps = chunked, slots, page_size
        self.chunk, self.n_new, self.tol, self.want = chunk, n_new, tol, want
        self.accept, self.do_cow = accept, cow
        t0 = time.perf_counter()
        self.oracle = [dense_oracle(model, p, n_new, tol) for p in prompts]
        self.oracle_s = time.perf_counter() - t0
        max_pages = -(-max_len // page_size)
        self.pool = paging.PagePool(slots * max_pages, page_size, slots,
                                    max_pages)
        self.buckets = paging.default_buckets(max_len)
        with torch.no_grad():
            self.cache = lm.init_paged_cache(
                self.cfg, slots, max_len, page_size=page_size,
                dtype=self.tree["embed"].dtype, device="cuda")
        self.slot_req = [None] * slots
        self.lengths = [0] * slots
        self.chunks = {}
        self.out = {i: [] for i in range(len(prompts))}
        self.counts = {"prefill": [], "chunk": [], "step": [], "verify": [],
                       "insert_verify": [], "cow_copy": []}
        self.first_errs, self.pool_errs = {}, {}
        self.tables_key, self.tables = None, None
        self.cow_pages = None

    # -- host side ------------------------------------------------------

    def ship(self):
        """The block tables on the card (int32), re-sent when they
        changed; mid-prefill slots' rows point at their scratch page, so
        the lockstep decode write lands there."""
        key = (self.pool.version, frozenset(self.chunks))
        if key != self.tables_key:
            tables = self.pool.tables.copy()
            for s in self.chunks:
                tables[s, :] = self.pool.scratch[s]
            self.tables = self.torch.from_numpy(tables).to("cuda")
            self.tables_key = key
        return self.tables

    def active(self):
        return [s for s in range(self.slots) if self.slot_req[s] is not None
                and s not in self.chunks]

    def call(self, kind, fn, rows=None):
        """fn() counted and held to its kind's launches."""
        with self.torch.no_grad():
            result, c = counted(fn)
        want = self.want[kind]
        want = want(rows) if callable(want) else want
        self.counts[kind].append(c)
        if c != want:
            raise AssertionError(f"{self.phase}: {kind} launches {c}, want "
                                 f"{want}")
        return result

    def first_token(self, i, logits):
        row = logits[:self.cfg.vocab]
        err, ok = err_ok(row, self.oracle[i]["first"], self.tol)
        self.first_errs[i] = err
        if not ok:
            raise AssertionError(f"{self.phase}: request {i} first-token "
                                 f"logits off by {err} (tol {self.tol})")
        self.out[i].append(int(row.argmax()))

    # -- the step programs ----------------------------------------------

    def admit(self, s, i):
        torch, lm = self.torch, self.lm
        p = self.prompts[i]
        plen = p.shape[0]
        self.pool.admit(s, plen + self.n_new)
        self.slot_req[s] = i
        if i in self.chunked:
            self.chunks[s] = self.paging.chunk_schedule(plen, self.chunk,
                                                        self.buckets)
            return
        self.pool.ensure(s, plen)
        bucket = self.paging.bucket_for(plen, self.buckets)
        toks = torch.zeros((1, bucket), dtype=p.dtype, device="cuda")
        toks[0, :plen] = p
        row = torch.from_numpy(self.pool.tables[s]).to("cuda")

        def run():
            lg, st = lm.prefill_states(self.tree, toks, self.cfg,
                                       last_pos=plen)
            return lg, lm.insert_prefill(self.cfg, self.cache, st, slot=s,
                                         pages=row, plen=plen,
                                         page_size=self.ps)
        lg, self.cache = self.call("prefill", run, bucket)
        self.first_token(i, lg[0])
        self.lengths[s] = plen

    def run_chunk(self, s):
        torch = self.torch
        i = self.slot_req[s]
        off, clen, shape = self.chunks[s].pop(0)
        self.pool.ensure(s, off + clen)
        toks = torch.zeros((1, shape), dtype=self.prompts[i].dtype,
                           device="cuda")
        toks[0, :clen] = self.prompts[i][off:off + clen]
        row = torch.from_numpy(self.pool.tables[s][None]).to("cuda")
        lg, self.cache = self.call("chunk", lambda: self.lm.prefill_chunk(
            self.tree, self.cache, toks, self.cfg, offset=off,
            chunk_len=clen, pages=row), shape)
        if not self.chunks[s]:
            del self.chunks[s]
            self.first_token(i, lg[0])
            self.lengths[s] = off + clen

    def decode(self):
        torch = self.torch
        act = self.active()
        for s in act:
            self.pool.ensure(s, self.lengths[s] + 1)
        tables = self.ship()
        toks = torch.tensor([[self.out[self.slot_req[s]][-1] if s in act
                              else 0] for s in range(self.slots)],
                            device="cuda")
        lens = torch.tensor([self.lengths[s] if s in act else 0
                             for s in range(self.slots)], dtype=torch.int32,
                            device="cuda")
        lg, self.cache = self.call("step", lambda: self.lm.decode_step(
            self.tree, self.cache, toks, lens, self.cfg, pages=tables),
            self.slots)
        picks = lg[:, :self.cfg.vocab].argmax(-1).tolist()
        for s in act:
            self.out[self.slot_req[s]].append(picks[s])
            self.lengths[s] += 1

    def ready_to_verify(self):
        return (len(self.active()) == self.slots and all(
            self.n_new - len(self.out[i]) >= self.K_DRAFT + 2
            for i in self.slot_req))

    def verify(self):
        """One speculative step: each slot's last token and the next
        ``K_DRAFT`` tokens of the dense stream as drafts; ``accept[s]``
        of them kept (the panel's argmax must agree with them but at a
        near-tie), then the panel's pick after them."""
        torch, k = self.torch, self.K_DRAFT
        panel, starts = [], []
        for s in range(self.slots):
            i = self.slot_req[s]
            j = len(self.out[i])
            starts.append(j)
            panel.append([self.out[i][-1]]
                         + self.oracle[i]["tokens"][j:j + k])
        self.pool.begin()
        for s in range(self.slots):
            self.pool.ensure(s, self.lengths[s] + 1 + k)
        self.pool.commit()
        tables = self.ship()
        panel_t = torch.tensor(panel, device="cuda")
        offset = torch.tensor(self.lengths, dtype=torch.int32, device="cuda")
        clen = torch.full((self.slots,), 1 + k, dtype=torch.int32,
                          device="cuda")
        lg, states = self.call("verify", lambda: self.lm.verify_states(
            self.tree, self.cache, panel_t, self.cfg, offset=offset,
            chunk_len=clen, pages=tables), self.slots * (1 + k))
        amax = lg[..., :self.cfg.vocab].argmax(-1).tolist()
        for s, n_acc in enumerate(self.accept):
            i = self.slot_req[s]
            for r in range(n_acc):
                if (amax[s][r] != panel[s][1 + r]
                        and not self.oracle[i]["ties"][starts[s] + r]):
                    raise AssertionError(
                        f"{self.phase}: verify row {r} of slot {s} picks "
                        f"{amax[s][r]}, the dense stream {panel[s][1 + r]}")
        n_keep = torch.tensor([1 + a for a in self.accept], dtype=torch.int32,
                              device="cuda")
        self.cache = self.call("insert_verify", lambda: self.lm.insert_verify(
            self.cfg, self.cache, states, pages=tables, offset=offset,
            n_keep=n_keep))
        for s, n_acc in enumerate(self.accept):
            self.out[self.slot_req[s]] += (panel[s][1:1 + n_acc]
                                           + [amax[s][n_acc]])
            self.lengths[s] += 1 + n_acc
            self.pool.rollback_tail(s, self.lengths[s])

    def cow(self):
        """Slot 0's first page, shared (a prefix cache's reference),
        copied on write into a free page: every pool's copy equal to its
        source; the source's last reference dropped."""
        from repro_torch.models.attention import PagedKVCache
        src = int(self.pool.tables[0, 0])
        self.pool.ref_page(src)
        src, dst = self.pool.cow(0, 0)
        if src == dst:
            raise AssertionError(f"{self.phase}: cow drew no page")
        self.cache = self.call("cow_copy", lambda: self.lm.cow_copy(
            self.cache, src, dst))
        for sc in self.cache:
            for c in sc.values():
                kv = c.get("kv")
                if isinstance(kv, PagedKVCache) and not (
                        self.torch.equal(kv.k[:, dst], kv.k[:, src])
                        and self.torch.equal(kv.v[:, dst], kv.v[:, src])):
                    raise AssertionError(f"{self.phase}: page {dst} is not "
                                         f"a copy of page {src}")
        if not self.pool.deref(src):
            raise AssertionError(f"{self.phase}: page {src} still held")
        self.cow_pages = (src, dst)

    def agree(self, i):
        """How many leading tokens of request i's stream equal the dense
        stream's; a difference before the dense stream's first near-tie
        raises."""
        got, want = self.out[i][:self.n_new], self.oracle[i]["tokens"]
        j = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(got))
        if j < len(got) and not any(self.oracle[i]["ties"][:j + 1]):
            raise AssertionError(f"{self.phase}: request {i} leaves the "
                                 f"dense stream at token {j} before a "
                                 "near-tie")
        return j

    def check_pool(self, s, i):
        """Slot s's pool rows against request i's dense cache at every
        written position whose token both streams share: a global
        layer's at position p, a windowed layer's ring slots (the last
        ``window`` positions) at p % window in the pool and p % slots in
        the dense ring; every layer, K and V."""
        from repro_torch.models.attention import PagedKVCache
        torch = self.torch
        plen = self.prompts[i].shape[0]
        written = self.lengths[s]
        upto = min(written, plen + self.agree(i))
        table = torch.from_numpy(self.pool.tables[s]).to("cuda").long()
        worst, ok = 0.0, True
        for stage, sc, dc in zip(self.cfg.stages(), self.cache,
                                 self.oracle[i]["cache"]):
            for key, c in sc.items():
                if not isinstance(c.get("kv"), PagedKVCache):
                    continue
                w = stage.body[int(key)].window
                lo = max(0, written - w) if w else 0
                pos = torch.arange(lo, upto, device="cuda")
                r = pos % w if w else pos
                pid, off = table[r // self.ps], r % self.ps
                for pool_t, dense_t in zip(c["kv"], dc[key]["kv"]):
                    err, good = err_ok(pool_t[:, pid, off],
                                       dense_t[:, 0, pos % dense_t.shape[2]],
                                       self.tol)
                    worst, ok = max(worst, err), ok and good
        self.pool_errs[i] = worst
        if not ok:
            raise AssertionError(f"{self.phase}: request {i}'s pool rows "
                                 f"off the dense cache's by {worst}")

    def retire(self):
        for s in self.active():
            i = self.slot_req[s]
            if len(self.out[i]) >= self.n_new:
                self.check_pool(s, i)
                self.pool.release(s)
                self.slot_req[s], self.lengths[s] = None, 0

    def run(self):
        t0 = time.perf_counter()
        queue = list(range(len(self.prompts)))
        verified = False
        while queue or any(r is not None for r in self.slot_req):
            for s in range(self.slots):
                if self.slot_req[s] is None and queue:
                    self.admit(s, queue.pop(0))
            for s in list(self.chunks):
                self.run_chunk(s)
            if not verified and self.accept and self.ready_to_verify():
                self.verify()
                verified = True
                if self.do_cow:
                    self.cow()
            elif self.active():
                self.decode()
            self.retire()
        self.pool.check_conservation()
        if self.accept and not verified:
            raise AssertionError(f"{self.phase}: the verify step never ran")
        same = [self.agree(i) for i in self.out]
        res = {"first_token_err": max(self.first_errs.values()),
               "max_logit": max(o["first"].abs().max().item()
                                for o in self.oracle),
               "pool_err": max(self.pool_errs.values()),
               "tokens_equal_dense": [j / self.n_new for j in same],
               "calls": {k: len(v) for k, v in self.counts.items()},
               "launches": {k: v[0] for k, v in self.counts.items() if v},
               "cow_pages": self.cow_pages, "accept": list(self.accept),
               "oracle_s": self.oracle_s,
               "seconds": time.perf_counter() - t0,
               "tokens": [self.out[i][:self.n_new] for i in self.out]}
        say(self.phase, f"paged serving of {len(self.prompts)} requests "
            f"(prompts {[p.shape[0] for p in self.prompts]}, chunked "
            f"{sorted(self.chunked)} at {self.chunk}) on {self.slots} slots "
            f"of pages of {self.ps}, {self.n_new} tokens each: calls "
            f"{res['calls']}, launches {res['launches']} (a bucketed "
            "prefill as the dense prefill at its length, a chunk and a "
            "verify with no attention launch, a step as the dense step); "
            f"first-token logits max_abs_err {res['first_token_err']:.4g} "
            f"(max|logit| {res['max_logit']:.4g}), "
            f"pool rows against the dense caches {res['pool_err']:.4g} "
            f"(tol={self.tol}*max(1,max|ref|)); verify kept "
            f"{list(self.accept)} drafts; cow pages {self.cow_pages}; "
            "tokens equal to the dense greedy stream: "
            f"{[round(x, 3) for x in res['tokens_equal_dense']]} (a "
            f"difference only after a near-tie); {res['seconds']:.1f} s "
            f"(dense oracle {self.oracle_s:.1f} s)")
        return res


def paged_rates(phase, model, prompts, long_prompt, *, chunk, max_len,
                page_size, smi, steps=8):
    """Readings on the card: paged decode tokens/s against dense decode
    tokens/s at the batch and lengths of ``prompts`` (host clock around
    ``steps`` synchronised steps, after a warm-up), the profile of a
    paged step (``launch/profile.py::profile_call``: wall, device busy,
    idle share, "other"), the chunked prefill of
    ``long_prompt`` at ``chunk`` against its bucketed one-shot prefill
    (tokens/s), and the profile of one chunk."""
    import torch
    from repro_torch.launch.profile import profile_call
    from repro_torch.models import lm
    from repro_torch.serve import paging
    cfg, tree = model.cfg, model.params.tree()
    dt = tree["embed"].dtype
    b, s = prompts.shape
    buckets = paging.default_buckets(max_len)
    max_pages = -(-max_len // page_size)
    out = {}
    # when each part ended, seconds from the start
    seconds = out["seconds"] = {}
    t0 = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def decode_loop(cache, tok, lengths, pages=None):
        for i in range(steps):
            lg, cache = lm.decode_step(tree, cache, tok, lengths + i, cfg,
                                       pages=pages)
            tok = lg.argmax(-1)[:, None]
        return cache

    def admit_one_shot(cache, pool, slot, p):
        plen = p.shape[0]
        pool.admit(slot, plen + steps)
        pool.ensure(slot, plen + steps)
        toks = torch.zeros((1, paging.bucket_for(plen, buckets)),
                           dtype=p.dtype, device="cuda")
        toks[0, :plen] = p
        lg, st = lm.prefill_states(tree, toks, cfg, last_pos=plen)
        return lg, lm.insert_prefill(
            cfg, cache, st, slot=slot,
            pages=torch.from_numpy(pool.tables[slot]).to("cuda"), plen=plen,
            page_size=page_size)

    with torch.no_grad():
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
        lg, dense = model.prefill(prompts, alloc=s + steps)
        tok = lg.argmax(-1)[:, None]
        decode_loop(dense, tok, lengths)                  # warm-up
        _, t_dense = timed(lambda: decode_loop(dense, tok, lengths))
        pool = paging.PagePool(b * max_pages, page_size, b, max_pages)
        paged = lm.init_paged_cache(cfg, b, max_len, page_size=page_size,
                                    dtype=dt, device="cuda")
        for r in range(b):
            _, paged = admit_one_shot(paged, pool, r, prompts[r])
        tables = torch.from_numpy(pool.tables).to("cuda")
        decode_loop(paged, tok, lengths, tables)
        _, t_paged = timed(lambda: decode_loop(paged, tok, lengths, tables))
        out["decode_tokens_per_s"] = {"paged": b * steps / t_paged,
                                      "dense": b * steps / t_dense}
        seconds["decode"] = time.perf_counter() - t0
        # one call a profile: a profile of thousands of launches takes
        # seconds to read
        out["step_profile"] = profile_call(lambda: lm.decode_step(
            tree, paged, tok, lengths + steps - 1, cfg, pages=tables), b,
            iters=1)
        seconds["step_profile"] = time.perf_counter() - t0
        del dense, paged
        # the long prompt, chunked and one-shot, into slot 0 of one pool
        plen = long_prompt.shape[0]
        pool = paging.PagePool(max_pages, page_size, 1, max_pages)
        one = lm.init_paged_cache(cfg, 1, max_len, page_size=page_size,
                                  dtype=dt, device="cuda")
        pool.admit(0, plen)
        pool.ensure(0, plen)
        row = torch.from_numpy(pool.tables[0][None]).to("cuda")
        sched = paging.chunk_schedule(plen, chunk, buckets)
        pieces = []
        for off, clen, shape in sched:
            toks = torch.zeros((1, shape), dtype=long_prompt.dtype,
                               device="cuda")
            toks[0, :clen] = long_prompt[off:off + clen]
            pieces.append((toks, off, clen))

        def chunked():
            for toks, off, clen in pieces:
                lm.prefill_chunk(tree, one, toks, cfg, offset=off,
                                 chunk_len=clen, pages=row)

        def one_shot():
            toks = torch.zeros((1, paging.bucket_for(plen, buckets)),
                               dtype=long_prompt.dtype, device="cuda")
            toks[0, :plen] = long_prompt
            _, st = lm.prefill_states(tree, toks, cfg, last_pos=plen)
            lm.insert_prefill(cfg, one, st, slot=0, pages=row[0], plen=plen,
                              page_size=page_size)
        for fn in (chunked, one_shot):
            fn()                                          # warm-up
        out["prefill_tokens_per_s"] = {
            name: plen / timed(fn)[1] for name, fn in
            (("chunked", chunked), ("one_shot", one_shot))}
        seconds["prefill"] = time.perf_counter() - t0
        toks, off, clen = pieces[min(2, len(pieces) - 1)]
        out["chunk_profile"] = profile_call(lambda: lm.prefill_chunk(
            tree, one, toks, cfg, offset=off, chunk_len=clen, pages=row),
            clen, iters=1)
        seconds["chunk_profile"] = time.perf_counter() - t0
        del one
    dec, pre = out["decode_tokens_per_s"], out["prefill_tokens_per_s"]
    say("throughput", f"{cfg.name} {phase} paged decode tokens/s at B={b} "
        f"after {s} tokens: paged {dec['paged']:.2f}, dense "
        f"{dec['dense']:.2f} ({steps} steps, host clock); prefill of "
        f"{plen} tokens, chunked at {chunk} / one-shot in bucket "
        f"{paging.bucket_for(plen, buckets)}: {pre['chunked']:.1f} / "
        f"{pre['one_shot']:.1f} tokens/s; seconds at the end of each part "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f" | {smi}")
    for name, prof in (("paged step", out["step_profile"]),
                       (f"chunk of {clen} at {off}", out["chunk_profile"])):
        say("profile", f"{cfg.name} {phase} {name}: wall "
            f"{prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, own kernels " + ", ".join(
                f"{k} {v:.3f}" for k, v in prof["own_kernels_ms"].items())
            + f", other device {prof['other_device_ms']:.3f} ms | {smi}")
    return out


# ------------------------------ deepseek-7b -----------------------------


def jitter_norms(tree, gen):
    """Spread every norm gain (and bias) of an LM tree by 0.1 around the
    initializer's constants, so the checks exercise them."""
    norms = [tree["final_norm"]] + [
        blk[n] for stage in tree["stages"] for blk in stage["stacked"].values()
        for n in ("norm1", "norm2")]
    for norm in norms:
        for t in norm.values():
            t.add_(_rand(gen, t.shape, t.dtype, t.device, 0.1))


def dense_phase(smi):
    """deepseek-7b at full width and depth on the card: serving checks in
    fp32 (fused and unfused) and bf16, then prefill and decode rates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("deepseek-7b")
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_norms(model.params.tree(),
                     torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    say("dense", f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
                 f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} "
                 f"kv), d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
                 f"{n_params / 1e9:.3f} B parameters, fp32, built in "
                 f"{time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                            device="cuda")
    prompt1 = torch.randint(0, cfg.vocab, (1, 333), generator=gen,
                            device="cuda")
    layers = cfg.n_layers
    out = {"params": n_params}
    for key, p, steps in (("fp32_b4", prompts, 32), ("fp32_b1", prompt1, 8)):
        b, s = p.shape
        out[key] = check_serving(
            "dense-fp32", model, p, steps, LOGIT_TOL,
            want_launches("deepseek-7b prefill", lm_counts(
                cfg, b * s, torch.float32, attention=True)),
            state=kv_state,
            want_decode=want_launches("deepseek-7b step", lm_counts(
                cfg, b, torch.float32, attention=False)))
    # unfused: 7 matmuls a layer (q, k, v, wo, gate, up, down) + the
    # head, 2 norms a layer + the final one
    with torch.no_grad():
        fused, _ = model.prefill(prompts)
        with runtime.use_pipeline_fusion(False):
            (unfused, _), ucounts = counted(lambda: model.prefill(prompts))
    want = {"rowwise_matmul": 7 * layers + 1, "flash_attention": layers,
            "layernorm": 2 * layers + 1, "wkv": 0}
    err, ok = err_ok(unfused, fused, LOGIT_TOL)
    say("dense-unfused", f"B=4 S=512 prefill logits against fused: "
                         f"max_abs_err={err:.4g} tol={LOGIT_TOL}*max(1,"
                         f"max|logit|); launches {ucounts}")
    if not ok or ucounts != want:
        raise AssertionError(f"dense unfused prefill: err {err}, launches "
                             f"{ucounts}, want {want}")
    out["unfused"] = {"max_abs_err": err, "counts": ucounts}
    del fused, unfused
    model16 = lm.LanguageModel(cfg, to_bf16(model.params.tree()),
                               device="cuda")
    out["bf16_b4"] = check_serving(
        "dense-bf16", model16, prompts, 8, None,
        want_launches("deepseek-7b prefill", lm_counts(
            cfg, 4 * 512, torch.bfloat16, attention=True)),
        state=kv_state,
        want_decode=want_launches("deepseek-7b step", lm_counts(
            cfg, 4, torch.bfloat16, attention=False)))
    out["bf16_layers"] = bf16_layers("dense-bf16", model16, prompts)
    # the unfused bf16 path: the same layer check, its launches, and its
    # full-depth logits against the fused ones as a reading
    with runtime.use_pipeline_fusion(False):
        out["bf16_unfused_layers"] = bf16_layers("dense-bf16-unfused",
                                                 model16, prompts)
    with torch.no_grad():
        fused16, _ = model16.prefill(prompts)
        with runtime.use_pipeline_fusion(False):
            (unfused16, _), ucounts16 = counted(
                lambda: model16.prefill(prompts))
    err16 = (unfused16.float() - fused16.float()).abs().max().item()
    say("dense-bf16-unfused", f"B=4 S=512 prefill logits against fused "
                              f"bf16 (a reading): max_abs_err={err16:.4g}; "
                              f"launches {ucounts16}")
    if ucounts16 != want or not torch.isfinite(unfused16).all():
        raise AssertionError(f"dense bf16 unfused prefill: launches "
                             f"{ucounts16}, want {want}, or logits not "
                             "finite")
    out["bf16_unfused"] = {"max_abs_err_to_fused": err16,
                           "counts": ucounts16}
    del fused16, unfused16
    with torch.no_grad(), runtime.use_impl("ref"):
        out["bf16_rounding"] = err_ok(model16.prefill(prompts)[0],
                                      model.prefill(prompts)[0], BF16_TOL)[0]
    say("dense-bf16", "plain bf16 against plain fp32 (same weights rounded)"
                      f", prefill logits: max_abs_err="
                      f"{out['bf16_rounding']:.4g}")
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32": lm_rates(model, prompts),
             "bf16": lm_rates(model16, prompts)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # unfused, the matmuls take no norm prologue
    with runtime.use_pipeline_fusion(False):
        rates["bf16_unfused"] = lm_rates(model16, prompts)
    with runtime.use_impl("ref"):
        rates["plain_fp32"] = lm_rates(model, prompts)
    out["skinny_norm_ab"] = skinny_norm_ab(
        "deepseek-7b", {"fp32": model, "bf16": model16}, prompts, smi)
    # paged serving: six requests on four slots in fp32 (the checks),
    # then the bf16 readings
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 333, 512, 700, 64, 900)]
    out["paged_fp32"] = PagedServing(
        "dense-paged", model, reqs, chunked={3, 5}, slots=4, page_size=16,
        max_len=1024, chunk=256, n_new=32, tol=LOGIT_TOL,
        want=paged_launches("deepseek-7b", cfg, torch.float32),
        accept=(3, 2, 1, 0), cow=True).run()
    out["paged_bf16"] = paged_rates("bf16", model16, prompts, reqs[5],
                                    chunk=256, max_len=1024, page_size=16,
                                    smi=smi)
    out.update(rates=rates, peak_memory_gib=peak_gb,
               seconds=time.perf_counter() - t_phase)
    say("throughput", "deepseek-7b prefill tokens/s at B=4 x 512: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=4: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {peak_gb:.2f} GiB (kernels, fp32 and bf16 models "
        f"resident) | {smi}")
    say("dense", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------ gemma3-27b ------------------------------


def gemma_state(cache):
    """The K and V of a gemma3 cache: the first local layer's ring, the
    first global layer's cache and the local tail's ring."""
    return [*cache[0]["0"]["kv"], *cache[0]["5"]["kv"], *cache[1]["0"]["kv"]]


def lm_counts(cfg, rows, dtype, *, attention, matmuls_per_layer=4,
              extra_norms=0):
    """Launches of a fused dense prefill (``attention`` True) or decode
    step of ``rows`` rows: 4 matmuls a layer and the head, one attention
    a layer at prefill, the final norm and the norms of the qkv and
    gate|up panels where their prologue splits."""
    layers = cfg.n_layers
    return {"rowwise_matmul": matmuls_per_layer * layers + 1,
            "flash_attention": layers if attention else 0,
            "layernorm": 1 + extra_norms + prologue_splits(
                rows, cfg.d_model, dtype, 2 * layers),
            "wkv": 0}


def paged_launches(key, cfg, dtype):
    """The launches each paged call is held to, by kind (a callable of
    the call's rows): the literals of ``LAUNCHES`` under ``key``, each
    checked against the count the config and the split rule give."""
    def held(kind, attention):
        return lambda rows: want_launches(f"{key} {kind}", lm_counts(
            cfg, rows, dtype, attention=attention))
    return {"prefill": held("prefill", True), "chunk": held("chunk", False),
            "step": held("step", False), "verify": held("verify", False),
            "insert_verify": NO_LAUNCHES, "cow_copy": NO_LAUNCHES}


def tied_head_copy(model, name):
    """The tied head's per-call transpose of the embedding table (the
    copy ``lm.unembed`` makes each prefill and step): ms a call, its
    bound (the table read once and its copy written once) and the bytes
    it allocates. The calls run back to back and each takes
    milliseconds, so the host runs ahead and the stream never idles: the
    events' time is the device's. The profiler is not asked, since it
    drops some of this copy's kernel records (a bf16 reading under the
    byte bound) and in one run all of them (PERF.md)."""
    table = model.params.tree()["embed"]
    ms = cuda_time(lambda: table.t().contiguous())
    copy_bytes = table.numel() * table.element_size()
    bound_ms, _ = bound(0, 2 * copy_bytes, name)
    gib = copy_bytes / 2 ** 30
    say("gemma", f"tied head transpose, {name} ({tuple(table.shape)}): "
                 f"{ms:.4f} ms a call on the device (events), bound "
                 f"{bound_ms:.4f} ms by bytes, {gib:.3f} GiB a copy")
    return {"ms": ms, "bound_ms": bound_ms, "gib": gib}


def gemma_phase(smi):
    """gemma3-27b at full width: 8 layers (one 5:1 group and the 2-layer
    local tail) in fp32, teacher-forced against the plain path (two
    batches, one whose ring wraps during decode) and unfused; then the
    fp32 model freed and all 62 layers in bf16 (its fp32 tree would not
    fit the card), layer by layer against fp32 beside the float8
    control, its full-depth logits as readings; prefill and decode
    rates, peak memory, the tied head's transpose."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full, n_layers=8)
    f32 = torch.float32
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=f32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_norms(model.params.tree(),
                     torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    say("gemma", f"{cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
                 f"({[st.repeat for st in cfg.stages()]} repeats of "
                 f"{[len(st.body) for st in cfg.stages()]}-layer stages), d "
                 f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} "
                 f"({cfg.n_kv_heads} kv), window {cfg.local_window}, d_ff "
                 f"{cfg.d_ff} (GeGLU), vocab {cfg.vocab} (tied): "
                 f"{n_params / 1e9:.3f} B parameters, fp32, built in "
                 f"{time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (2, 2048), generator=gen,
                            device="cuda")
    # 1020 tokens: the ring of 1024 fills at the fourth step and wraps
    # from the fifth on
    prompt1 = torch.randint(0, cfg.vocab, (1, 1020), generator=gen,
                            device="cuda")
    out = {"params_fp32": n_params}
    for key, p, steps in (("fp32_b2", prompts, 16), ("fp32_b1", prompt1,
                                                     12)):
        b, s = p.shape
        out[key] = check_serving(
            "gemma-fp32", model, p, steps, LOGIT_TOL,
            want_launches("gemma3-27b/8 prefill",
                          lm_counts(cfg, b * s, f32, attention=True)),
            state=gemma_state,
            want_decode=want_launches("gemma3-27b/8 step", lm_counts(
                cfg, b, f32, attention=False)))
    # unfused: 7 matmuls a layer (q, k, v, wo, gate, up, down) and the
    # head, 2 norms a layer and the final one
    with torch.no_grad():
        fused, _ = model.prefill(prompts)
        with runtime.use_pipeline_fusion(False):
            (unfused, _), ucounts = counted(lambda: model.prefill(prompts))
    want = {"rowwise_matmul": 7 * cfg.n_layers + 1,
            "flash_attention": cfg.n_layers,
            "layernorm": 2 * cfg.n_layers + 1, "wkv": 0}
    err, ok = err_ok(unfused, fused, LOGIT_TOL)
    say("gemma-unfused", f"B=2 S=2048 prefill logits against fused: "
                         f"max_abs_err={err:.4g} tol={LOGIT_TOL}*max(1,"
                         f"max|logit|); launches {ucounts}")
    if not ok or ucounts != want:
        raise AssertionError(f"gemma unfused prefill: err {err}, launches "
                             f"{ucounts}, want {want}")
    out["unfused"] = {"max_abs_err": err, "counts": ucounts}
    del fused, unfused
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32_8_layers": lm_rates(model, prompts)}
    with runtime.use_impl("ref"):
        rates["plain_fp32_8_layers"] = lm_rates(model, prompts)
    out["peak_memory_fp32_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["tied_head_fp32"] = tied_head_copy(model, "fp32")
    # paged serving: a 1500-token prompt chunked at 512 (its chunks cross
    # the 1024 window: the ring pages wrap mid-prompt) and a 300-token
    # one-shot on two slots, held to the dense path in fp32 here and in
    # bf16 at full depth below
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (1500, 300)]
    paged = dict(chunked={0}, slots=2, page_size=16, max_len=2048, chunk=512,
                 n_new=17, accept=(3, 1))
    out["paged_fp32_8_layers"] = PagedServing(
        "gemma-paged-fp32", model, reqs, tol=LOGIT_TOL,
        want=paged_launches("gemma3-27b/8", cfg, f32), **paged).run()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model16 = lm.LanguageModel(
        full, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_norms(model16.params.tree(),
                     torch.Generator(device="cuda").manual_seed(1))
    out["params_bf16"] = sum(p.numel() for p in model16.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model16.parameters()) / 2 ** 30
    say("gemma", f"{full.name}: all {full.n_layers} layers, "
                 f"{out['params_bf16'] / 1e9:.3f} B parameters, bf16, "
                 f"{gib:.2f} GiB of weights, built in "
                 f"{time.perf_counter() - t0:.1f} s")
    bf = torch.bfloat16
    out["bf16_b2"] = check_serving(
        "gemma-bf16", model16, prompts, 8, None,
        want_launches("gemma3-27b prefill",
                      lm_counts(full, 2 * 2048, bf, attention=True)),
        state=gemma_state,
        want_decode=want_launches("gemma3-27b step", lm_counts(
            full, 2, bf, attention=False)))
    out["bf16_layers"] = bf16_layers("gemma-bf16", model16, prompts)
    torch.cuda.reset_peak_memory_stats()
    rates["bf16"] = lm_rates(model16, prompts)
    out["peak_memory_bf16_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_pipeline_fusion(False):
        rates["bf16_unfused"] = lm_rates(model16, prompts)
    with runtime.use_impl("ref"):
        rates["plain_bf16"] = lm_rates(model16, prompts)
    out["skinny_norm_ab"] = skinny_norm_ab(
        "gemma3-27b", {"bf16, 62 layers": model16}, prompts, smi)
    out["paged_bf16"] = PagedServing(
        "gemma-paged-bf16", model16, reqs, tol=BF16_TOL,
        want=paged_launches("gemma3-27b", full, bf), **paged).run()
    out["paged_rates_bf16"] = paged_rates(
        "bf16, 62 layers", model16, prompts[:, :1024], reqs[0], chunk=512,
        max_len=2048, page_size=16, smi=smi)
    out["tied_head_bf16"] = tied_head_copy(model16, "bf16")
    out.update(rates=rates, seconds=time.perf_counter() - t_phase)
    say("throughput", "gemma3-27b prefill tokens/s at B=2 x 2048: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=2: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {out['peak_memory_fp32_gib']:.2f} GiB (fp32, 8 "
        f"layers), {out['peak_memory_bf16_gib']:.2f} GiB (bf16, 62 layers) "
        f"| {smi}")
    say("gemma", f"phase took {out['seconds']:.1f} s")
    del model16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------ whisper-base -----------------------------


def whisper_state(cache):
    """The self K/V and the cross K/V of a whisper cache's first layer."""
    c = cache[0]["0"]
    return [*c["kv"], *c["cross_kv"]]


def whisper_counts(cfg, batch, s, dtype, *, prefill):
    """Launches of a fused whisper prefill of ``batch`` x ``s`` tokens
    (its encoder over the frames included) or decode step: the encoder's
    4 matmuls and 1 attention a layer and its final norm; the decoder's
    7 matmuls a layer at prefill (qkv, wo, wq, wkv, the cross wo, mlp1,
    mlp2; 6 at decode, no wkv), 2 attention at prefill, the cross norm;
    the head and the final norm; and the norms of the qkv and mlp1
    panels where their prologue splits."""
    d, enc, dec = cfg.d_model, cfg.n_enc_layers, cfg.n_layers
    rows = batch * s if prefill else batch
    counts = {"rowwise_matmul": 6 * dec + 1, "flash_attention": 0,
              "layernorm": dec + 1 + prologue_splits(rows, d, dtype,
                                                     2 * dec),
              "wkv": 0}
    if prefill:
        counts["rowwise_matmul"] += 4 * enc + dec
        counts["flash_attention"] = enc + 2 * dec
        counts["layernorm"] += 1 + prologue_splits(batch * cfg.cross_len, d,
                                                   dtype, 2 * enc)
    return counts


def whisper_phase(smi):
    """whisper-base at full width and depth on seeded frames: fp32
    teacher-forced against the plain path (self and cross caches), the
    encoder's and the unfused prefill's launches, bf16 layer by layer
    (encoder and decoder) against fp32 beside the float8 control and as
    readings; prefill and decode rates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = get_config("whisper-base")
    f32 = torch.float32
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=f32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        tree = model.params.tree()
        jitter_norms(tree, torch.Generator(device="cuda").manual_seed(1))
        jitter_norms({"final_norm": tree["enc"]["final_norm"],
                      "stages": tree["enc"]["stages"]},
                     torch.Generator(device="cuda").manual_seed(3))
        xgen = torch.Generator(device="cuda").manual_seed(4)
        for stage in tree["stages"]:
            for blk in stage["stacked"].values():
                for t in blk["norm_x"].values():
                    t.add_(_rand(xgen, t.shape, t.dtype, t.device, 0.1))
    n_params = sum(p.numel() for p in model.parameters())
    say("whisper", f"{cfg.name}: {cfg.n_enc_layers} encoder + "
                   f"{cfg.n_layers} decoder layers, d {cfg.d_model}, "
                   f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff},"
                   f" vocab {cfg.vocab} (tied), {cfg.cross_len} frames: "
                   f"{n_params / 1e6:.2f} M parameters, fp32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = _rand(gen, (4, cfg.cross_len, cfg.d_model), f32, "cuda")
    prompts = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                            device="cuda")
    prompt1 = torch.randint(0, cfg.vocab, (1, 16), generator=gen,
                            device="cuda")
    out = {"params": n_params}
    with torch.no_grad():
        _, ecounts = counted(lambda: lm.encode(tree, frames, cfg))
        emodes = attention_modes()
    want = want_launches("whisper-base encoder", {
        "rowwise_matmul": 4 * cfg.n_enc_layers,
        "flash_attention": cfg.n_enc_layers,
        "layernorm": 1 + prologue_splits(4 * cfg.cross_len, cfg.d_model,
                                         f32, 2 * cfg.n_enc_layers),
        "wkv": 0})
    say("whisper", f"encoder over B=4 x {cfg.cross_len} frames: launches "
                   f"{ecounts}, attention by mode {emodes}")
    if ecounts != want:
        raise AssertionError(f"whisper encoder: launches {ecounts}, want "
                             f"{want}")
    out["encoder_counts"], out["encoder_modes"] = ecounts, emodes
    for key, p, steps, fr, name in (
            ("fp32_b4", prompts, 32, frames, "whisper-base prefill"),
            ("fp32_b1", prompt1, 8, frames[:1], "whisper-base prefill 1x16")):
        b, s = p.shape
        out[key] = check_serving(
            "whisper-fp32", model, p, steps, LOGIT_TOL,
            want_launches(name, whisper_counts(cfg, b, s, f32,
                                               prefill=True)),
            state=whisper_state,
            want_decode=want_launches("whisper-base step", whisper_counts(
                cfg, b, s, f32, prefill=False)),
            extra={"frames": fr})
    extra = {"frames": frames}
    # unfused: 6 matmuls an encoder layer (q, k, v, wo, mlp1, mlp2), 10
    # a decoder layer (with wq, wk, wv and the cross wo) and the head; 2
    # norms an encoder layer, 3 a decoder layer and the two final ones
    with torch.no_grad():
        fused, _ = model.prefill(prompts, extra=extra)
        with runtime.use_pipeline_fusion(False):
            (unfused, _), ucounts = counted(
                lambda: model.prefill(prompts, extra=extra))
    enc, dec = cfg.n_enc_layers, cfg.n_layers
    want = {"rowwise_matmul": 6 * enc + 10 * dec + 1,
            "flash_attention": enc + 2 * dec,
            "layernorm": 2 * enc + 3 * dec + 2, "wkv": 0}
    err, ok = err_ok(unfused[..., :cfg.vocab], fused[..., :cfg.vocab],
                     LOGIT_TOL)
    say("whisper-unfused", f"B=4 S=64 prefill logits against fused: "
                           f"max_abs_err={err:.4g}; launches {ucounts}")
    if not ok or ucounts != want:
        raise AssertionError(f"whisper unfused prefill: err {err}, "
                             f"launches {ucounts}, want {want}")
    out["unfused"] = {"max_abs_err": err, "counts": ucounts}
    model16 = lm.LanguageModel(cfg, to_bf16(tree), device="cuda")
    bf = torch.bfloat16
    extra16 = {"frames": frames.to(bf)}
    out["bf16_b4"] = check_serving(
        "whisper-bf16", model16, prompts, 8, None,
        want_launches("whisper-base prefill",
                      whisper_counts(cfg, 4, 64, bf, prefill=True)),
        state=whisper_state,
        want_decode=want_launches("whisper-base step", whisper_counts(
            cfg, 4, 64, bf, prefill=False)),
        extra=extra16)
    out["bf16_layers"] = bf16_layers("whisper-bf16", model16, prompts,
                                     frames=extra16["frames"])
    rates = {"fp32": lm_rates(model, prompts, extra=extra),
             "bf16": lm_rates(model16, prompts, extra=extra16)}
    with runtime.use_pipeline_fusion(False):
        rates["bf16_unfused"] = lm_rates(model16, prompts, extra=extra16)
    with runtime.use_impl("ref"):
        rates["plain_fp32"] = lm_rates(model, prompts, extra=extra)
    out.update(rates=rates, seconds=time.perf_counter() - t_phase)
    say("throughput", "whisper-base prefill tokens/s at B=4 x 64 (the "
        "encoder over 1500 frames included): " + ", ".join(
            f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=4: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items()) + f" | {smi}")
    say("whisper", f"phase took {out['seconds']:.1f} s")
    return out


def kernel_line(rows, name, key, launches, path, dtype="fp32",
                label=None, source=None):
    """One kernel's entry of the kernels JSON line: its ``dtype`` cases
    summed over the calls of one ``key`` run (``fused``: a Swin-T forward,
    ``prefill``: an RWKV6-3B prefill), each times its launches there, and
    the largest error of those cases."""
    per = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype
           and r[key]]

    def total(k):
        return sum(r[key] * r[k] for r in per)

    b_ops = total("flops") / PEAK_FLOPS[dtype]
    b_bytes = total("bytes") / PEAK_BYTES
    return {"name": label or name, "route": "cuda",
            "source": source or SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in per),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": (None if any(r["library_ms"] is None for r in per)
                           else total("library_ms")),
            "path": path}


def check_listed(tabs, key, counts):
    """The launches the ``key`` cases of an LM table list, per dtype,
    against the model's run ``counts`` ({"fp32": ..., "bf16": ...})."""
    for dt in ("fp32", "bf16"):
        listed = {name: tabs.get(f"{key} {dt} {name}", {}).get(
            "launches", 0) for name in REPLACES}
        # the bf16 RWKV6 model runs WKV in fp32: no bf16 wkv cases
        if dt == "bf16" and key in ("prefill", "decode"):
            listed["wkv"] = counts[dt]["wkv"]
        if listed != counts[dt]:
            raise AssertionError(f"the {key} {dt} cases list {listed} "
                                 f"launches, the model ran {counts[dt]}")


def check_modes(rows, key, dtype, run, cases):
    """The attention launches by mode of one model's prefill (``run``:
    mode -> launches) against the ``key`` cases that list them (``cases``:
    mode -> the names of its cases), each case times its launches."""
    listed = {mode: sum(r[key] for r in rows
                        if r["kernel"] == "flash_attention"
                        and r["dtype"] == dtype
                        and any(r["case"].startswith(n + " q=")
                                for n in names))
              for mode, names in cases.items()}
    say("modes", f"{key} {dtype}: attention launches by mode, the model's "
                 f"run {run}, its cases {listed}")
    if listed != run:
        raise AssertionError(f"the {key} {dtype} attention cases list "
                             f"{listed} launches by mode, the model ran "
                             f"{run}")


def design_tables(rows):
    """Each kernel per design, per dtype, summed over one run of each
    path (``fused``: a Swin-T forward at B=8, ``fused64``: its attention
    at B=64, ``vit``: a ViT-B/16 forward at B=8, ``prefill`` /
    ``decode``: an RWKV6-3B prefill at B=4 x 512 / decode step at B=4,
    ``dprefill`` / ``ddecode``: the same of deepseek-7b, ``dunfused``:
    its unfused prefill; the int8 cases
    over their Swin-T shapes, as the int8 path runs them):
    launches and event / plain / library ms and the bound, each case
    times its launches."""
    out = {}
    for key in ("fused", "fused64", "vit", "prefill", "decode", "dprefill",
                "ddecode", "dunfused", "gprefill", "gdecode", "wprefill",
                "wdecode"):
        for dt in ("fp32", "bf16", "int8"):
            for kernel in REPLACES:
                mine = [r for r in rows if r["kernel"] == kernel and r[key]
                        and r["dtype"] == dt and r["design"]]
                for design in sorted({r["design"] for r in mine}):
                    per = [r for r in mine if r["design"] == design]

                    def total(k, per=per):
                        if any(r.get(k) is None for r in per):
                            return None
                        return sum(r[key] * r[k] for r in per)
                    out[f"{key} {dt} {kernel} {design}"] = {
                        "launches": sum(r[key] for r in per),
                        **{k: total(k) for k in (
                            "ms", "device_ms", "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms", "flops",
                            "bytes")}}
    for k, v in out.items():
        say("design-table", f"{k}: " + " ".join(
            f"{a}={b:.4g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in v.items() if b is not None))
    return out


def lm_tables(rows, keys, label):
    """Per kernel, per LM prefill and per decode step (the count ``keys``:
    RWKV6-3B's or deepseek-7b's, B=4 x 512 and B=4, and deepseek-7b's
    unfused prefill), fp32 and bf16:
    launches and the summed event / plain / library ms and bound of its
    cases. The bf16 RWKV6 model runs its recurrence in fp32, so its bf16
    tables have no wkv row: the fp32 one holds."""
    out = {}
    for key in keys:
        for dt in ("fp32", "bf16"):
            for name in REPLACES:
                per = [r for r in rows if r["kernel"] == name and r[key]
                       and r["dtype"] == dt]
                if not per:
                    continue

                def total(k, per=per):
                    if any(r.get(k) is None for r in per):
                        return None
                    return sum(r[key] * r[k] for r in per)

                out[f"{key} {dt} {name}"] = {
                    "launches": sum(r[key] for r in per),
                    **{k: total(k) for k in ("ms", "device_ms", "plain_ms",
                                             "library_ms",
                                             "library_device_ms",
                                             "bound_ms")}}
    for k, v in out.items():
        say(label, f"{k}: " + " ".join(
            f"{a}={b:.4g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in v.items() if b is not None))
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.swin_t import CONFIG, VIT_CONFIG
    from repro_torch.core import runtime
    from repro_torch.kernels import _build
    from repro_torch.models.vision import SwinTransformer, VisionTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("card", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"
                f" | {torch.cuda.get_device_name(0)} | tf32 off")

    # 2. the build
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    log = (_build.BUILD_DIR / "ptxas.log").read_text()
    spills, fn = [], None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        fn = found.group(1) if found else fn
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found and found.groups() != ("0", "0"):
            spills.append((fn, *found.groups()))
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines()
            if "Used " in ln and " registers" in ln]
    say("build", f"{_build.LIBRARY.relative_to(ROOT)} in "
                 f"{time.perf_counter() - t0:.1f} s; {len(regs)} kernels, "
                 f"max {max(regs, default=0)} registers, "
                 f"{len(spills)} with spills")
    mma = tensor_core_counts(_build.LIBRARY)
    for kernel, ops_ in mma.items():
        say("build", f"tensor-core instructions in {kernel}: "
                     + (", ".join(f"{k} {v}" for k, v in ops_.items())
                        or "none (CUDA cores)"))
    # held at the end, so that a run with a spilling kernel still reports
    # every phase
    build_faults = [f"kernels spill registers: {spills}"] if spills else []
    if not all(mma[k] for k in mma if "wgmma" in k):
        build_faults.append("a wgmma kernel holds no tensor-core "
                            "instruction")
    if not [k for k in mma if "attention_kernel_mma" in k] or not all(
            mma[k].get("HMMA") for k in mma if "attention_kernel_mma" in k):
        build_faults.append("a bf16 attention kernel holds no HMMA")
    for fault in build_faults:
        say("build", f"FAULT: {fault}")

    # 3. each kernel against its plain version
    gen = torch.Generator().manual_seed(0)
    rows = run_cases(swin_cases(CONFIG, 8, torch.float32, gen, dev),
                     "fp32", FP32_TOL)
    rows += run_cases(swin_cases(CONFIG, 8, torch.bfloat16, gen, dev),
                      "bf16", BF16_TOL)
    # the RWKV6-3B operands (~0.5 G normals) come from a CUDA generator
    rwkv_cfg, gen = get_config("rwkv6-3b"), torch.Generator(
        device=dev).manual_seed(3)
    rows += run_cases(rwkv_cases(rwkv_cfg, torch.float32, gen, dev), "fp32",
                      FP32_TOL)
    rows += run_cases(rwkv_cases(rwkv_cfg, torch.bfloat16, gen, dev), "bf16",
                      BF16_TOL)
    dense_cfg = get_config("deepseek-7b")
    rows += run_cases(dense_cases(dense_cfg, torch.float32, gen, dev), "fp32",
                      FP32_TOL)
    rows += run_cases(dense_cases(dense_cfg, torch.bfloat16, gen, dev),
                      "bf16", BF16_TOL)
    gemma_cfg, whisper_cfg = get_config("gemma3-27b"), get_config(
        "whisper-base")
    for dt, name, tol in ((torch.float32, "fp32", FP32_TOL),
                          (torch.bfloat16, "bf16", BF16_TOL)):
        rows += run_cases(gemma_cases(gemma_cfg, dt, gen, dev), name, tol)
        rows += run_cases(whisper_cases(whisper_cfg, dt, gen, dev), name,
                          tol)
    # attention off the B=8 Swin-T forward: ViT-B/16 at B=8, and every
    # Swin-T stage at B=64 (the throughput batch)
    for dt, name, tol in ((torch.float32, "fp32", FP32_TOL),
                          (torch.bfloat16, "bf16", BF16_TOL)):
        agen = torch.Generator().manual_seed(7)
        vt = (VIT_CONFIG.img_size // VIT_CONFIG.patch) ** 2 + 1
        heads = VIT_CONFIG.num_heads
        rows += run_cases(
            [attention_case("vit-b16", (8, vt, VIT_CONFIG.embed_dim // heads),
                            heads, heads, dt, agen, dev, vit=VIT_CONFIG.depth)]
            + swin_attention_cases(CONFIG, 64, dt, agen, dev, "fused64"),
            name, tol)
    i8_cases = int8_cases(CONFIG, rwkv_cfg, 8, torch.Generator().manual_seed(5),
                          dev)
    rows += run_cases(i8_cases, "int8", INT8_TOL)
    lib8 = [r for r in rows if r["dtype"] == "int8" and r["fused"]
            and r["library_ms"] is not None]
    say("kernels", f"int8 library (torch._int_mm, dequant, epilogue) over "
        f"{sum(r['fused'] for r in lib8)} launches of a Swin-T forward: "
        f"{sum(r['fused'] * r['library_ms'] for r in lib8):.4f} ms against "
        f"the kernel's {sum(r['fused'] * r['ms'] for r in lib8):.4f} ms; "
        "the head (M=8) has no _int_mm")
    overheads = launch_overheads(dev)
    # the host's speed varies from machine to machine; the ratio to the
    # library call is the steadier reading
    say("kernels", "host µs per call (wrapper / library): " + ", ".join(
        f"{k} {a:.1f} / " + ("none" if b is None else f"{b:.1f} "
                             f"({a / b:.2f}x)")
        for k, (a, b) in overheads.items()))

    # 4./5. full-width Swin-T, fused and unfused
    rng = np.random.default_rng(0)
    model = SwinTransformer(CONFIG, device=dev,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        jitter(model.params.tree(), torch.Generator().manual_seed(1))
    images = torch.from_numpy(rng.standard_normal(
        (8, CONFIG.img_size, CONFIG.img_size, 3)).astype(np.float32)).to(dev)
    fused, main_counts = check_forward(
        "swin-fused", model, images,
        want_launches("swin-t", swin_counts(CONFIG, 8, torch.float32)),
        LOGIT_TOL)
    with runtime.use_pipeline_fusion(False):
        unfused, _ = check_forward(
            "swin-unfused", model, images,
            {"rowwise_matmul": 53, "flash_attention": 0, "layernorm": 25,
             "wkv": 0},
            LOGIT_TOL)
    err, ok = err_ok(unfused, fused, LOGIT_TOL)
    say("swin-unfused", f"against fused: max_abs_err={err:.4g}")
    if not ok:
        raise AssertionError("unfused logits disagree with fused")

    # 6. ViT-B/16
    vit = VisionTransformer(VIT_CONFIG, device=dev,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        jitter(vit.params.tree(), torch.Generator().manual_seed(1))
    vimages = torch.from_numpy(rng.standard_normal(
        (8, VIT_CONFIG.img_size, VIT_CONFIG.img_size, 3))
        .astype(np.float32)).to(dev)
    vit_rows = 8 * ((VIT_CONFIG.img_size // VIT_CONFIG.patch) ** 2 + 1)
    check_forward("vit-b16", vit, vimages,
                  want_launches("vit-b16", {
                      "rowwise_matmul": 50, "flash_attention": 12,
                      "layernorm": 1 + prologue_splits(
                          vit_rows, VIT_CONFIG.embed_dim, torch.float32,
                          2 * VIT_CONFIG.depth), "wkv": 0}), LOGIT_TOL)

    # 7. bf16 forward, then throughput at B=64
    model16 = SwinTransformer(CONFIG, device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        jitter(model16.params.tree(), torch.Generator().manual_seed(1))
    # bf16 kernel path against the bf16 plain path on the card
    check_forward("swin-bf16", model16, images.to(torch.bfloat16),
                  want_launches("swin-t",
                                swin_counts(CONFIG, 8, torch.bfloat16)),
                  BF16_TOL)
    with runtime.use_pipeline_fusion(False):
        check_forward("swin-bf16-unfused", model16, images.to(torch.bfloat16),
                      {"rowwise_matmul": 53, "flash_attention": 0,
                       "layernorm": 25, "wkv": 0}, BF16_TOL)
    big = torch.from_numpy(rng.standard_normal(
        (64, CONFIG.img_size, CONFIG.img_size, 3)).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    thr = {"fp32": images_per_s(model, big),
           "bf16": images_per_s(model16, big.to(torch.bfloat16))}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_impl("ref"):
        thr["plain_fp32"] = images_per_s(model, big, iters=3)
    say("throughput", f"Swin-T B=64 images/s: kernels fp32 {thr['fp32']:.1f}"
                      f", kernels bf16 {thr['bf16']:.1f}, plain fp32 "
                      f"{thr['plain_fp32']:.1f}; peak memory {peak_gb:.2f} "
                      f"GiB | {smi}")

    # 8. RWKV6-3B at full width and depth
    rwkv = rwkv_phase(smi)
    tables = lm_tables(rows, ("prefill", "decode"), "rwkv-table")

    # 9. deepseek-7b at full width and depth
    dense = dense_phase(smi)
    dense_tables = lm_tables(rows, ("dprefill", "ddecode", "dunfused"),
                             "dense-table")

    # 10. gemma3-27b (8 layers in fp32, all 62 in bf16) and whisper-base
    gemma = gemma_phase(smi)
    gemma_tables = lm_tables(rows, ("gprefill", "gdecode"), "gemma-table")
    whisper = whisper_phase(smi)
    whisper_tables = lm_tables(rows, ("wprefill", "wdecode"),
                               "whisper-table")

    def both(run, batch, key="counts"):
        """A phase's launches per run of its largest batch, by dtype."""
        return {dt: run[f"{dt}_{batch}"][key] for dt in ("fp32", "bf16")}
    for tabs, key, counts in (
            (tables, "prefill", both(rwkv, "b4")),
            (tables, "decode", both(rwkv, "b4", "decode_counts")),
            (dense_tables, "dprefill", both(dense, "b4")),
            (dense_tables, "ddecode", both(dense, "b4", "decode_counts")),
            (dense_tables, "dunfused", {"fp32": dense["unfused"]["counts"],
                                        "bf16": dense["bf16_unfused"][
                                            "counts"]}),
            (gemma_tables, "gprefill", both(gemma, "b2")),
            (gemma_tables, "gdecode", both(gemma, "b2", "decode_counts")),
            (whisper_tables, "wprefill", both(whisper, "b4")),
            (whisper_tables, "wdecode", both(whisper, "b4",
                                             "decode_counts"))):
        check_listed(tabs, key, counts)
    # the Swin-T cases against the fused forward's launches
    listed = {name: sum(r["fused"] for r in rows if r["kernel"] == name
                        and r["dtype"] == "fp32") for name in REPLACES}
    if listed != main_counts:
        raise AssertionError(f"the Swin-T cases list {listed} launches, "
                             f"the forward ran {main_counts}")

    # 11. the int8 path
    i8_counts, i8_device_ms = int8_path(i8_cases)
    threshold = readings_apart("skinny_threshold",
                               "threshold_readings('cuda')")
    threshold_prologue = readings_apart(
        "prologue_threshold", "prologue_threshold_readings('cuda')")
    threshold_wkv = readings_apart(
        "wkv_threshold",
        "wkv_threshold_readings(get_config('rwkv6-3b'), 'cuda')")
    threshold_ln = readings_apart("layernorm_threshold",
                                  "layernorm_threshold_readings('cuda')")
    designs = design_tables(rows)

    # 12. the kernels line and the result
    swin = "one fused Swin-T forward, B=8, fp32"
    kernels = [kernel_line(rows, name, "fused", main_counts[name], swin)
               for name in ("rowwise_matmul", "flash_attention")]
    # layernorm once per design: the final norm of the fused Swin-T
    # forward (rows) and the 97 norms of an RWKV6-3B decode step (cta)
    for key, counts, path in (
            ("fused", main_counts, swin),
            ("decode", rwkv["fp32_b4"]["decode_counts"],
             "one RWKV6-3B decode step, B=4, fp32")):
        design = "+".join(sorted({
            r["design"] for r in rows if r["kernel"] == "layernorm"
            and r["dtype"] == "fp32" and r[key]}))
        kernels.append(kernel_line(rows, "layernorm", key,
                                   counts["layernorm"], path,
                                   label=f"layernorm {design}"))
    kernels.append(kernel_line(rows, "wkv", "prefill",
                               rwkv["fp32_b4"]["counts"]["wkv"],
                               "one RWKV6-3B prefill, B=4 x 512, fp32"))
    kernels.append(kernel_line(
        rows, "flash_attention", "dprefill",
        dense["fp32_b4"]["counts"]["flash_attention"],
        "one deepseek-7b prefill, B=4 x 512, fp32",
        label="flash_attention causal"))
    # the attention modes of gemma3-27b and whisper-base: the cases of
    # each mode against the launches the model's prefill counted in it
    # (its encoder's apart), and a kernels entry for each new mode, over
    # the calls of one fp32 prefill that take it
    enc = whisper["encoder_modes"].get("causal", 0)
    for dt in ("fp32", "bf16"):
        check_modes(rows, "gprefill", dt, gemma[f"{dt}_b2"]["prefill_modes"],
                    {"causal+window": ["gemma.prefill causal+window"],
                     "causal": ["gemma.prefill causal"]})
        run = dict(whisper[f"{dt}_b4"]["prefill_modes"])
        cases = {"full Sq!=Skv": ["whisper.prefill cross"],
                 "causal": ["whisper.encoder causal",
                            "whisper.prefill causal"]}
        if dt == "fp32":
            # the encoder's causal launches apart, counted in its own run
            run["causal"] = run.get("causal", 0) - enc
            run["encoder causal"] = enc
            cases["causal"] = ["whisper.prefill causal"]
            cases["encoder causal"] = ["whisper.encoder causal"]
        check_modes(rows, "wprefill", dt, run, cases)
    for key, case, launches_, label, path in (
            ("gprefill", "gemma.prefill causal+window",
             gemma["fp32_b2"]["prefill_modes"].get("causal+window", 0),
             "flash_attention causal+window",
             "the local layers of one gemma3-27b prefill (8 layers), "
             "B=2 x 2048, fp32"),
            ("wprefill", "whisper.encoder causal", enc,
             "flash_attention causal S=1500",
             "the encoder layers of one whisper-base prefill, B=4, fp32"),
            ("wprefill", "whisper.prefill cross",
             whisper["fp32_b4"]["prefill_modes"].get("full Sq!=Skv", 0),
             "flash_attention cross Sq!=Skv",
             "the cross-attention of one whisper-base prefill, B=4 x 64 "
             "over 1500 frames, fp32")):
        mine = [r for r in rows if r["kernel"] == "flash_attention"
                and r["dtype"] == "fp32" and r[key]
                and r["case"].startswith(case + " q=")]
        kernels.append(kernel_line(mine, "flash_attention", key, launches_,
                                   path, label=label))
    kernels.append(kernel_line(
        rows, "rowwise_matmul", "fused", i8_counts["rowwise_matmul"],
        "ops.matmul_int8 at every Swin-T matmul shape, B=8", dtype="int8",
        label="rowwise_matmul int8 W8A8",
        source="src/repro_torch/csrc/rowwise_matmul_wgmma.cu"))
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": smi, "cases": rows,
                               "host_us_per_call": overheads,
                               "tensor_core_instructions": mma,
                               "throughput_images_per_s": thr,
                               "peak_memory_gib": peak_gb,
                               "rwkv": rwkv, "rwkv_tables": tables,
                               "dense": dense,
                               "dense_tables": dense_tables,
                               "gemma": gemma, "gemma_tables": gemma_tables,
                               "whisper": whisper,
                               "whisper_tables": whisper_tables,
                               "prologue_threshold_us": threshold_prologue,
                               "design_tables": designs,
                               "int8_path_device_ms": i8_device_ms,
                               "skinny_threshold_us": threshold,
                               "wkv_threshold_us": threshold_wkv,
                               "layernorm_threshold_us": threshold_ln,
                               "kernels": kernels}, indent=1))
    if build_faults:
        raise AssertionError("; ".join(build_faults))
    say("done", f"{time.perf_counter() - t_start:.1f} s in all; "
                f"per-case details in {OUT.relative_to(ROOT)}; kernel ms "
                f"below are sums over {swin} (the wkv row: over one "
                "RWKV6-3B prefill at B=4 x 512, fp32; the layernorm cta "
                "row: over one decode step at B=4, fp32; the "
                "flash_attention causal row: over one deepseek-7b prefill "
                "at B=4 x 512, fp32; the gemma3-27b and whisper-base "
                "attention rows: over the calls of one prefill that take "
                "that mode)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
