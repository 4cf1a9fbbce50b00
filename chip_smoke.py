#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of ``src/repro_torch/csrc`` into ``build/repro_torch``:
   registers and spills from ``ptxas.log``, and the count of tensor-core
   instructions (``HGMMA`` / ``IGMMA`` / ``IMMA`` / ``HMMA``) in each
   matmul kernel from ``cuobjdump -sass``;
3. each kernel against its plain version at every distinct Swin-T shape
   and mode (B=8), in fp32 and in bf16, plus a gated matmul and an
   LM-style attention (causal + window + GQA + q_offset): error beside
   its tolerance, kernel / plain / library ms (CUDA events, after
   warm-up; calls of M <= 16 rows rotate copies of their weights past
   the 50 MB L2, so each reads its weights from HBM as the model does),
   the bound, and the matmul design the call took (skinny, wgmma or
   ffma); then the int8 W8A8 leg at every distinct Swin-T matmul shape
   and at RWKV6-3B's widths at M=2048 and M=4, held against the exact
   plain version (float64 products on the card), ``torch._int_mm`` as
   its library yardstick where that takes the shape; host µs per
   wrapper call;
4. full-width Swin-T, fused, B=8 fp32: kernel path against
   ``use_impl("ref")`` on the card, launch counts 53 / 12 / 1;
5. the same unfused: counts 53 / 0 / 25, and agreement with fused;
6. ViT-B/16, B=8, kernel path against plain;
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
9. the int8 path: ``ops.matmul_int8`` at every Swin-T matmul shape
   (B=8), as often as a fused forward runs each (53 launches, counted),
   and its device time by matmul design (profiler);
10. the matmul per design and dtype, summed over a Swin-T forward, an
   RWKV6-3B prefill and a decode step (``design-table`` lines); one JSON
   line of the kernels (the int8 leg a row of its own), then the last
   line ``{"ok": true, "device": {...}}``. Before the tables: the skinny
   design against the M > 16 design of each dtype at M = 4 .. 16
   (``threshold`` line, device µs from the profiler).

Phase 3 also holds every RWKV6-3B kernel call (M=2048 prefill and M=4
decode matmuls and norms, the WKV recurrence at B=4 x 512, B=1 x 333
and the B=4 decode step with a starting state) against its plain
version, and sums them per prefill and per decode step.

Details of every case go to ``chiprun_out/chip_smoke.json``. Any
mismatch, wrong count or failed phase raises, and the script exits
non-zero with no result line. It exits non-zero at once where
``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

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
# float8_e5m2 (2 mantissa bits) (PERF.md, PR 12 findings).
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
    ``IMMA``) in each matmul kernel of the library, from
    ``cuobjdump -sass``, keyed by the kernel's mangled name from its stem
    ``rowwise_matmul_kernel`` on."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : \S*?(rowwise_matmul_kernel\w*?)E*v",
                          line)
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


COUNTS = ("fused", "unfused", "prefill", "decode")


class Case:
    """One kernel call at one shape: how to run the kernel, its plain
    version, the reference its output is checked against, and the
    library call that computes the same function."""

    def __init__(self, kernel, name, run, plain, check, library,
                 flops, nbytes_, **counts):
        self.kernel, self.name = kernel, name
        self.run, self.plain, self.check, self.library = (
            run, plain, check, library)
        self.flops, self.nbytes = flops, nbytes_
        # launches per Swin-T forward (fused, unfused) and per RWKV6-3B
        # prefill at B=4 x 512 and decode step at B=4
        self.counts = {k: counts.get(k, 0) for k in COUNTS}
        self.op = None


def _rand(gen, shape, dtype, device, scale=1.0):
    import torch
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return t.to(device=device, dtype=dtype)


def matmul_case(name, m, k, n, dtype, gen, device, *, bias=True, act=None,
                norm=None, beta=True, residual=False, gated=False,
                out_f32=False, **counts):
    """One matmul call. int8: W8A8 operands (x and w int8 from the
    quantizers, fp32 scales and vectors); its plain version multiplies
    in float64, exact. M <= COLD_M: the kernel, plain and library calls
    each take the next of enough weight copies to pass the L2."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p

    int8 = dtype == torch.int8
    vec = torch.float32 if int8 else dtype
    x = _rand(gen, (m, k), vec, device)
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
        x, scales["x_scale"] = quant.quantize_per_row(x)
        w, scales["w_scale"] = quant.quantize_per_channel(w)
        if gated:
            wg, scales["wg_scale"] = quant.quantize_per_channel(wg)
    ops = dict(bias=b, activation=act, bias_gate=bg, residual=res, **scales)
    weights = [(w, wg)]
    if m <= COLD_M:
        size = sum(t.numel() * t.element_size() for t in (w, wg)
                   if t is not None)
        weights += [tuple(None if t is None else t.clone() for t in (w, wg))
                    for _ in range(int(-(-COLD_BYTES // size)) - 1)]
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
        if int8:
            return torch._int_mm(x, wt)
        xin = x
        if norm == "layer":
            xin = F.layer_norm(x, (k,), g, be, 1e-6)
        elif norm == "rms":
            xin = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * g
            xin = xin + be if be is not None else xin
        h = torch.addmm(b, xin, wt) if b is not None else xin @ wt
        if gated:
            gg = torch.addmm(bg, xin, wgt) if bg is not None else xin @ wgt
            h = act_fn(gg) * h
        else:
            h = act_fn(h)
        return h + res if res is not None else h

    # torch._int_mm, the int8 yardstick (the product alone), takes
    # M > 16 and K, N multiples of 8
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
        **counts)
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
    from repro_torch.kernels.flash_attention import flash_attention_p

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
    mask = torch.zeros((t, skv), dtype=dtype, device=device).masked_fill(
        ~allowed, float("-inf"))
    if bias is not None:
        nb = bias.shape[0]
        mask = (bias.to(dtype)[None].expand(nw // nb, *bias.shape)
                .reshape(nw, heads, t, skv) + mask)

    return Case(
        "flash_attention", f"{name} q={tuple(q.shape)} kv={tuple(k.shape)}",
        lambda: flash_attention_p(q, k, v, **kw), plain_on(None),
        plain_on(torch.float32 if dtype != torch.float32 else None),
        lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
        4 * nw * heads * hd * int(allowed.sum().item()),
        nbytes(q, k, v, bias, out=(q.numel(), dtype)), **counts)


def layernorm_case(name, m, d, dtype, gen, device, **counts):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.layernorm import layernorm_p

    x = _rand(gen, (m, d), dtype, device)
    g = 1 + _rand(gen, (d,), dtype, device, 0.1)
    b = _rand(gen, (d,), dtype, device, 0.1)

    def plain_on(cast):
        c = (lambda z: z.to(cast)) if cast else (lambda z: z)
        return lambda: ref.layernorm_ref(c(x), c(g), c(b))

    return Case(
        "layernorm", f"{name} M={m} D={d}",
        lambda: layernorm_p(x, g, b), plain_on(None),
        plain_on(torch.float32 if dtype != torch.float32 else None),
        lambda: F.layer_norm(x, (d,), g, b, 1e-6), 7 * m * d,
        nbytes(x, g, b, out=(x.numel(), dtype)), **counts)


def swin_cases(cfg, batch, dtype, gen, device):
    """Every distinct kernel call of a Swin forward, with its launches
    per fused and per unfused forward, plus the extra modes."""
    import torch
    from repro_torch.models import vision

    cases = []
    res = cfg.img_size // cfg.patch
    c = cfg.embed_dim
    w = cfg.window
    t = w * w
    cases.append(matmul_case(
        "patch", batch * res * res, cfg.patch ** 2 * cfg.in_chans, c, dtype,
        gen, device, fused=1, unfused=1))
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        m = batch * res * res
        s = f"s{si + 1}"
        nw_img = (res // w) ** 2
        shifted = depth // 2 if res > w else 0
        cases += [
            matmul_case(f"{s}.qkv+ln", m, c, 3 * c, dtype, gen, device,
                        norm="layer", fused=depth),
            matmul_case(f"{s}.proj+res", m, c, c, dtype, gen, device,
                        residual=True, fused=depth),
            matmul_case(f"{s}.mlp1+ln+gelu", m, c, 4 * c, dtype, gen, device,
                        norm="layer", act="gelu", fused=depth),
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
        blk = {"rel_bias": _rand(gen, ((2 * w - 1) ** 2, heads), dtype,
                                 device, 0.02)}
        rel_idx = vision._rel_pos_index(w, torch.device(device))
        mask = (vision._shift_mask(res, res, w, w // 2, torch.device(device))
                if res > w else None)
        nw = batch * nw_img
        hd = c // heads
        cases.append(attention_case(
            f"{s}.window", (nw, t, hd), heads, heads, dtype, gen, device,
            bias=vision._rel_bias(blk, rel_idx, heads, 0, mask),
            fused=depth - shifted))
        if shifted:
            cases.append(attention_case(
                f"{s}.shifted", (nw, t, hd), heads, heads, dtype, gen,
                device, bias=vision._rel_bias(blk, rel_idx, heads, w // 2,
                                              mask), fused=shifted))
        if si < len(cfg.depths) - 1:
            cases.append(matmul_case(
                f"{s}.merge", m // 4, 4 * c, 2 * c, dtype, gen, device,
                bias=False, fused=1, unfused=1))
            res //= 2
            c *= 2
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


def wkv_case(name, b, s, cfg, dtype, gen, device, *, with_s0=False,
             **counts):
    """The WKV recurrence at the config's heads (RWKV6-3B: 40 of 64),
    r/k/v/lw in ``dtype`` (the model feeds fp32), decays spread over
    both clamp ends; checked against the plain chunked scan on fp32
    copies of the same inputs, y and the final state each."""
    import torch
    from repro_torch.kernels.wkv import wkv_p
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
        **counts)


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
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import rowwise_matmul as rm
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
                    run()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(5):
                            run()
                        torch.cuda.synchronize()
                finally:
                    rm.SKINNY_PICK_M[dt] = pick
                us = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages()
                         if "rowwise_matmul_kernel" in e.key)
                out[f"{dt} M={m} {design}"] = us / (5 * len(ws))
    say("threshold", "device µs per call, M x 2560 x 2560, weights cold: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


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
    from repro_torch.kernels.rowwise_matmul import pick_design
    rows = []
    for case in cases:
        out, want = case.run(), case.check()
        if not isinstance(out, tuple):          # wkv: (y, final state)
            out, want = (out,), (want,)
        errs = [err_ok(o, w, tol) for o, w in zip(out, want)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        row = {"kernel": case.kernel, "case": case.name, "dtype": dtype_name,
               **case.counts, "max_abs_err": err, "tol": tol}
        if case.kernel == "rowwise_matmul":
            row["design"] = pick_design(case.op["x"].shape[0],
                                        case.op["x"].dtype)
        if len(errs) > 1:
            row["errs"] = [e for e, _ in errs]
        b_ms, b_by = bound(case.flops, case.nbytes, dtype_name)
        row.update(flops=case.flops, bytes=case.nbytes, bound_ms=b_ms,
                   bound_by=b_by)
        if timed:
            row.update(ms=cuda_time(case.run), plain_ms=cuda_time(case.plain),
                       library_ms=(cuda_time(case.library) if case.library
                                   else None))
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
    """Run fn with every launch count set to 0 just before; return its
    result and the counts just after."""
    import torch
    for k in launches().values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in launches().items()}


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


def check_serving(phase, model, prompts, n_steps, tol, want_counts):
    """Greedy serving of a batch: the plain path on the card picks the
    tokens (prefill, then ``n_steps`` decode steps); the kernel path runs
    teacher-forced on them. Its logits at prefill and at every step must
    sit within tol * max(1, max|logit|) of the plain path's, its greedy
    picks must equal the plain path's (a top-2 gap below the tolerance
    is reported, not failed), its final WKV states must agree, and each
    prefill and step must launch ``want_counts``. With ``tol=None`` the
    logits, picks and states are readings, held only to be finite."""
    import torch
    from repro_torch.core import runtime
    b, s = prompts.shape
    with torch.no_grad():
        with runtime.use_impl("ref"):
            lg, cache = model.prefill(prompts)
            want, toks = [lg], [lg.argmax(-1)]
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=prompts.device)
            for i in range(n_steps):
                lg, cache = model.decode_step(cache, toks[-1][:, None],
                                              lengths + i)
                want.append(lg)
                toks.append(lg.argmax(-1))
        want_states = cache
        got_lg, counts = counted(lambda: model.prefill(prompts))
        got, cache = [got_lg[0]], got_lg[1]
        all_counts = [counts]
        for i in range(n_steps):
            (lg, cache), counts = counted(
                lambda i=i: model.decode_step(cache, toks[i][:, None],
                                              lengths + i))
            got.append(lg)
            all_counts.append(counts)
    limit = float("inf") if tol is None else tol
    ties, scale, step_errs = 0, 1.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        err, ok = err_ok(g, w, limit)
        step_errs.append(err)
        scale = max(scale, w.abs().max().item())
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
    s_err, s_ok = err_ok(cache[0]["0"]["rwkv_t"]["wkv"],
                         want_states[0]["0"]["rwkv_t"]["wkv"], limit)
    bad = [c for c in all_counts if c != want_counts]
    worst = max(step_errs)
    held = ("readings only; greedy picks differ at " if tol is None else
            f"tol={tol}*max(1,max|logit|); greedy picks equal but for ")
    say(phase, f"B={b} S={s} + {n_steps} steps: logits max|logit|="
               f"{scale:.4g} max_abs_err={worst:.4g} (prefill "
               f"{step_errs[0]:.4g}, last step {step_errs[-1]:.4g}) "
               f"{held}{ties} rows; final wkv states max_abs_err="
               f"{s_err:.4g}; launches per prefill {all_counts[0]}, per "
               f"step {all_counts[-1]}")
    if not s_ok:
        raise AssertionError(f"{phase}: final WKV states off by {s_err}")
    if bad:
        raise AssertionError(f"{phase}: launches {bad[0]}, want "
                             f"{want_counts}")
    return {"max_abs_err": worst, "step_errs": step_errs,
            "max_logit": scale, "near_ties": ties,
            "state_err": s_err, "counts": all_counts[0],
            "decode_counts": all_counts[-1],
            "tokens": torch.stack(toks, 1).tolist()}


def bf16_layers(model16, prompts):
    """Each layer of the bf16 model at prefill, run on the plain bf16
    path's input to it (so no error carries from layer to layer), against
    the same layer in fp32 on the same weights and input, as rms(err) /
    rms(out): the kernel path (held to ``BF16_LAYER_TOL``), the plain
    bf16 path (bf16's own rounding, for scale) and a control in lower
    precision. Returns the worst reading over layers of each path and
    the control's least."""
    import torch
    from repro_torch.core import runtime
    from repro_torch.models import blocks, lm
    cfg, tree = model16.cfg, model16.params.tree()
    reads = {"kernels": [], "plain": [], "control": []}
    with torch.no_grad():
        x = lm._add_positions(lm.embed(tree, prompts, cfg), cfg)
        for stage, sp in zip(cfg.stages(), tree["stages"]):
            for rep in range(stage.repeat):
                for i, blk in enumerate(stage.body):
                    key = str(i)
                    bp = (lm._tree_map(lambda a, r=rep: a[r],
                                       sp["stacked"][key])
                          if key in sp["stacked"] else sp["shared"][key])

                    def run(params, inp, blk=blk):
                        return blocks.apply_block(blk, params, inp, cfg=cfg,
                                                  mode="prefill")[0]
                    with runtime.use_impl("ref"):
                        plain = run(bp, x)
                        want = run(lm._tree_map(lambda a: a.float(), bp),
                                   x.float())
                    ways = {"kernels": run(bp, x), "plain": plain,
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
    out = {"kernels_max": max(reads["kernels"]),
           "plain_max": max(reads["plain"]),
           "control_min": min(reads["control"]), "per_layer": reads}
    say("rwkv-bf16", "each layer on the plain bf16 input, against the same "
                     "layer in fp32, rms(err)/rms(out): kernels max "
                     f"{out['kernels_max']:.4g}, plain bf16 max "
                     f"{out['plain_max']:.4g}, control (plain bf16 output "
                     f"in float8_e5m2) min {out['control_min']:.4g}; tol "
                     f"{BF16_LAYER_TOL}")
    if out["kernels_max"] > BF16_LAYER_TOL:
        raise AssertionError(f"bf16 layers: kernel path reads "
                             f"{out['kernels_max']}")
    if out["control_min"] <= BF16_LAYER_TOL:
        raise AssertionError("bf16 layers: the control passes the limit")
    return out


def lm_rates(model, prompts, steps=8):
    """Prefill tokens/s of the batch and decode tokens/s at its batch
    size (host clock around synchronised calls, after the checks have
    warmed every path)."""
    import torch
    b, s = prompts.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(prompts)
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
    out["bf16_layers"] = bf16_layers(model16, prompts)
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


def kernel_line(rows, name, key, launches, path, dtype="fp32",
                label=None, source=None):
    """One kernel's entry of the kernels JSON line: its ``dtype`` cases
    summed over the calls of one ``key`` run (``fused``: a Swin-T forward,
    ``prefill``: an RWKV6-3B prefill), each times its launches there."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype]
    per = [r for r in mine if r[key]]

    def total(k):
        return sum(r[key] * r[k] for r in per)

    b_ops = total("flops") / PEAK_FLOPS[dtype]
    b_bytes = total("bytes") / PEAK_BYTES
    return {"name": label or name, "route": "cuda",
            "source": source or SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": (None if any(r["library_ms"] is None for r in per)
                           else total("library_ms")),
            "path": path}


def design_tables(rows):
    """The matmul per design, per dtype, summed over one run of each
    path (``fused``: a Swin-T forward at B=8, ``prefill`` / ``decode``:
    an RWKV6-3B prefill at B=4 x 512 / decode step at B=4; the int8
    cases over their Swin-T shapes, as the int8 path runs them): launches
    and event / plain / library ms and the bound, each case times its
    launches."""
    out = {}
    for key in ("fused", "prefill", "decode"):
        for dt in ("fp32", "bf16", "int8"):
            for design in ("skinny", "wgmma", "ffma"):
                per = [r for r in rows if r["kernel"] == "rowwise_matmul"
                       and r[key] and r["dtype"] == dt
                       and r.get("design") == design]
                if not per:
                    continue

                def total(k, per=per):
                    if any(r[k] is None for r in per):
                        return None
                    return sum(r[key] * r[k] for r in per)
                out[f"{key} {dt} {design}"] = {
                    "launches": sum(r[key] for r in per),
                    **{k: total(k) for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "flops", "bytes")}}
    for k, v in out.items():
        say("design-table", f"{k}: " + " ".join(
            f"{a}={b:.4g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in v.items()))
    return out


def rwkv_tables(rows):
    """Per kernel, per RWKV6-3B prefill (B=4 x 512) and per decode step
    (B=4), fp32 and bf16: launches and the summed event / plain / library
    ms and bound of its cases. The bf16 model runs its recurrence in
    fp32, so the bf16 tables have no wkv row: the fp32 one holds."""
    out = {}
    for key in ("prefill", "decode"):
        for dt in ("fp32", "bf16"):
            for name in REPLACES:
                per = [r for r in rows if r["kernel"] == name and r[key]
                       and r["dtype"] == dt]
                if not per:
                    continue

                def total(k, per=per):
                    if any(r[k] is None for r in per):
                        return None
                    return sum(r[key] * r[k] for r in per)

                out[f"{key} {dt} {name}"] = {
                    "launches": sum(r[key] for r in per),
                    **{k: total(k) for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms")}}
    for k, v in out.items():
        say("rwkv-table", f"{k}: " + " ".join(
            f"{a}={b:.4g}" if isinstance(b, float) else f"{a}={b}"
            for a, b in v.items()))
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
    i8_cases = int8_cases(CONFIG, rwkv_cfg, 8, torch.Generator().manual_seed(5),
                          dev)
    rows += run_cases(i8_cases, "int8", INT8_TOL)
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
        {"rowwise_matmul": 53, "flash_attention": 12, "layernorm": 1,
         "wkv": 0},
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
    check_forward("vit-b16", vit, vimages,
                  {"rowwise_matmul": 50, "flash_attention": 12,
                   "layernorm": 1, "wkv": 0}, LOGIT_TOL)

    # 7. bf16 forward, then throughput at B=64
    model16 = SwinTransformer(CONFIG, device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        jitter(model16.params.tree(), torch.Generator().manual_seed(1))
    # bf16 kernel path against the bf16 plain path on the card
    check_forward("swin-bf16", model16, images.to(torch.bfloat16),
                  {"rowwise_matmul": 53, "flash_attention": 12,
                   "layernorm": 1, "wkv": 0}, BF16_TOL)
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
    tables = rwkv_tables(rows)
    for key, counts in (("prefill", rwkv["fp32_b4"]["counts"]),
                        ("decode", rwkv["fp32_b4"]["decode_counts"])):
        listed = {name: tables.get(f"{key} fp32 {name}", {}).get(
            "launches", 0) for name in REPLACES}
        if listed != counts:
            raise AssertionError(f"the {key} cases list {listed} launches, "
                                 f"the model ran {counts}")

    # 9. the int8 path
    i8_counts, i8_device_ms = int8_path(i8_cases)
    threshold = threshold_readings(dev)
    designs = design_tables(rows)

    # 10. the kernels line and the result
    swin = "one fused Swin-T forward, B=8, fp32"
    kernels = [kernel_line(rows, name, "fused", main_counts[name], swin)
               for name in ("rowwise_matmul", "flash_attention",
                            "layernorm")]
    kernels.append(kernel_line(rows, "wkv", "prefill",
                               rwkv["fp32_b4"]["counts"]["wkv"],
                               "one RWKV6-3B prefill, B=4 x 512, fp32"))
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
                               "design_tables": designs,
                               "int8_path_device_ms": i8_device_ms,
                               "skinny_threshold_us": threshold,
                               "kernels": kernels}, indent=1))
    if build_faults:
        raise AssertionError("; ".join(build_faults))
    say("done", f"{time.perf_counter() - t_start:.1f} s in all; "
                f"per-case details in {OUT.relative_to(ROOT)}; kernel ms "
                f"below are sums over {swin} (the wkv row: over one "
                "RWKV6-3B prefill at B=4 x 512, fp32)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
