"""Where the time of a forward goes on the card.

Runs the full-width Swin-T fused forward (random weights from seed 0,
images from numpy seed 0), or an RWKV6-3B or deepseek-7b prefill of 512
tokens per sequence and one decode step after it (random weights from a
CUDA generator with seed 0, tokens from seed 1), under ``torch.profiler``
and reports, per call: wall time (host clock around synchronised calls),
device busy time, the device's idle share, and device time by kernel
name and by design (the matmul's skinny / wgmma / ffma, attention's
mma / ffma, WKV's chunk / step, layernorm's cta / rows).

    PYTHONPATH=src python -m repro_torch.launch.profile \
        --batch 8 64 --dtype fp32 bf16 --impl auto ref --out chiprun_out/profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile --model rwkv6-3b \
        --batch 4
    PYTHONPATH=src python -m repro_torch.launch.profile --model deepseek-7b \
        --batch 4 --dtype fp32 bf16
    PYTHONPATH=src python -m repro_torch.launch.profile --model layernorm \
        --dtype fp32 bf16

``--model layernorm`` times ``layernorm_p`` alone at each shape
``chip_smoke.py`` holds it at (Swin-T's norms at B=8, RWKV6-3B's at
prefill and decode): device µs per call from the profiler, the CUDA-event
µs of back-to-back calls, ``F.layer_norm``'s beside both, and the host µs
per call of each on 64 x 64. Another tree's kernel (the parent commit's,
from ``git archive``) is timed the same way: copy this file into that
tree's ``repro_torch/launch/`` (naming the tree's one design in place of
``ln.pick_design(m, d, dt)`` where it has no picker) and run it with that
tree's ``src`` on the path.

``--impl ref`` profiles the plain PyTorch path on the card. A card is
required: without one it raises.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.swin_t import CONFIG
from repro_torch.core import runtime
from repro_torch.models.lm import LanguageModel
from repro_torch.models.vision import SwinTransformer

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# prompt tokens per sequence of an LM prefill
LM_SEQ = 512
# names of the port's own kernels in the profiler's trace
OWN = {"rowwise_matmul_kernel": "rowwise_matmul",
       "attention_kernel": "flash_attention",
       "layernorm_kernel": "layernorm",
       "wkv_kernel": "wkv"}
# each kernel's designs by kernel name (the first stem that matches)
DESIGNS = {"rowwise_matmul_kernel_skinny": "rowwise_matmul skinny",
           "rowwise_matmul_kernel_wgmma": "rowwise_matmul wgmma",
           "rowwise_matmul_kernel": "rowwise_matmul ffma",
           "attention_kernel_mma": "flash_attention mma",
           "attention_kernel_ffma": "flash_attention ffma",
           "wkv_kernel_chunk": "wkv chunk",
           "wkv_kernel_step": "wkv step",
           "layernorm_kernel_cta": "layernorm cta",
           "layernorm_kernel_rows": "layernorm rows"}
# the layernorm calls of chip_smoke.py: Swin-T's four stages and final
# norm at B=8, RWKV6-3B's norms at prefill (B=4 x 512) and decode (B=4)
LN_SHAPES = ((25088, 96), (6272, 192), (1568, 384), (392, 768),
             (2048, 2560), (4, 2560))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_call(fn, items: int, iters: int = 3) -> dict:
    """Profile ``fn()``; ``items`` (images or tokens) per call give the
    rate."""
    with torch.no_grad():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key][0] += us / 1e3 / iters
            by_name[evt.key][1] += evt.count / iters
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    own, designs = defaultdict(float), defaultdict(float)
    for name, (ms, _) in by_name.items():
        for tag, kernel in OWN.items():
            if tag in name:
                own[kernel] += ms
        design = next((d for tag, d in DESIGNS.items() if tag in name), None)
        if design:
            designs[design] += ms
    rows = sorted(([name, ms, calls] for name, (ms, calls) in
                   by_name.items()), key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "items_per_s": items / wall_ms * 1e3,
            "own_kernels_ms": dict(own),
            "designs_ms": dict(designs),
            "other_device_ms": busy - sum(own.values()),
            "top": rows[:15]}


def _report(res, what):
    print(f"[profile] {res['card']} {what}: wall {res['wall_ms']:.3f} ms "
          f"({res['items_per_s']:.1f} {res['unit']}/s), device busy "
          f"{res['device_busy_ms']:.3f} ms, idle share "
          f"{res['idle_share']:.3f}, own kernels "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      res["own_kernels_ms"].items())
          + f", other device {res['other_device_ms']:.3f} ms; by design "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      res["designs_ms"].items()),
          flush=True)
    for row_name, ms, calls in res["top"][:8]:
        print(f"    {ms:8.3f} ms  {calls:6.1f}x  {row_name[:90]}")


def profile_lm(args, dev, card):
    """An LM prefill at (batch, LM_SEQ) into a cache of LM_SEQ + 1 and
    one decode step after it, per dtype, batch and impl (the step writes
    its token's KV at the same position each call)."""
    cfg = get_config(args.model)
    results = []
    for name in args.dtype:
        model = LanguageModel(
            cfg, device=dev, dtype=DTYPES[name],
            generator=torch.Generator(device=dev).manual_seed(0))
        for batch, impl in itertools.product(args.batch, args.impl):
            tokens = torch.randint(
                0, cfg.vocab, (batch, LM_SEQ), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
            with runtime.use_impl(impl), torch.no_grad():
                _, cache = model.prefill(tokens, alloc=LM_SEQ + 1)
                lengths = torch.full((batch,), LM_SEQ, dtype=torch.int32,
                                     device=dev)
                step = tokens[:, -1:]
                for phase, fn, items in (
                        ("prefill", lambda: model.prefill(tokens),
                         batch * LM_SEQ),
                        ("decode", lambda: model.decode_step(cache, step,
                                                             lengths),
                         batch)):
                    res = profile_call(fn, items)
                    res.update(card=card, model=cfg.name, phase=phase,
                               batch=batch, seq=LM_SEQ, dtype=name,
                               impl=impl, unit="tokens")
                    results.append(res)
                    _report(res, f"{cfg.name} {phase} B={batch} "
                                 f"S={LM_SEQ} {name} impl={impl}")
            del cache
        del model
        torch.cuda.empty_cache()
    return results


def kernel_us(fn, tag=None, calls=20, sessions=3) -> float:
    """Device µs of one kernel whose name holds ``tag`` (any kernel for
    ``tag=None``) over ``calls`` calls of ``fn`` under the profiler, after
    a warm-up: the median over ``sessions`` profiles of each one's median
    kernel record with a time. The profiler drops some records, keeps
    some without a time, and can read a whole profile up to 2x off, so no
    one record or profile decides (a profile that kept none is taken
    again)."""
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(sessions + 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [us for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (tag is None or tag in e.key)
                 and (us := _device_us(e)) > 0]
        if times:
            readings.append(statistics.median(times))
            if len(readings) == sessions:
                return statistics.median(readings)
    raise RuntimeError(f"the profiler recorded no kernel of {tag!r}")


def _event_us(fn, calls=50):
    """CUDA-event µs per call of ``calls`` back-to-back calls of ``fn``."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def _host_us(fn, calls=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def profile_layernorm(args, dev, card):
    """``layernorm_p`` and ``F.layer_norm`` at each of LN_SHAPES per
    dtype (x * 3 + 1, gamma and beta in x's dtype), then their host cost
    per call on 64 x 64."""
    import torch.nn.functional as F

    from repro_torch.kernels import layernorm as ln
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for name in args.dtype:
        dt = DTYPES[name]
        for m, d in LN_SHAPES:
            x = (torch.randn(m, d, device=dev, generator=gen) * 3 + 1).to(dt)
            g = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(dt)
            b = (0.1 * torch.randn(d, device=dev, generator=gen)).to(dt)

            def norm():
                return ln.layernorm_p(x, g, b)

            def library():
                return F.layer_norm(x, (d,), g, b, 1e-6)
            k_dev, k_event = kernel_us(norm, calls=50), _event_us(norm)
            f_dev, f_event = kernel_us(library, calls=50), _event_us(library)
            design = ln.pick_design(m, d, dt)
            res = dict(card=card, dtype=name, m=m, d=d, design=design,
                       device_us=k_dev, event_us=k_event,
                       library_device_us=f_dev, library_event_us=f_event)
            results.append(res)
            print(f"[profile] {card} layernorm {name} M={m} D={d} "
                  f"{design}: device {k_dev:.3f} µs, event {k_event:.3f} "
                  f"µs; F.layer_norm device {f_dev:.3f} µs, event "
                  f"{f_event:.3f} µs", flush=True)
    x, b = torch.randn(64, 64, device=dev), torch.randn(64, device=dev)
    host = {"layernorm_p": _host_us(lambda: ln.layernorm_p(x, b, b)),
            "F.layer_norm": _host_us(
                lambda: F.layer_norm(x, (64,), b, b, 1e-6))}
    results.append(dict(card=card, host_us_per_call=host))
    print(f"[profile] {card} layernorm host µs per call on 64 x 64: "
          f"layernorm_p {host['layernorm_p']:.2f}, F.layer_norm "
          f"{host['F.layer_norm']:.2f}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="swin-t",
                    choices=["swin-t", "rwkv6-3b", "deepseek-7b",
                             "layernorm"])
    ap.add_argument("--batch", type=int, nargs="+", default=[64])
    ap.add_argument("--dtype", nargs="+", default=["fp32"],
                    choices=sorted(DTYPES))
    ap.add_argument("--impl", nargs="+", default=["auto"],
                    choices=["auto", "ref"])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = runtime.resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    if args.model != "swin-t":
        results = (profile_layernorm if args.model == "layernorm" else
                   profile_lm)(args, dev, card)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(results, indent=1))
        return
    results = []
    for name in args.dtype:
        model = SwinTransformer(CONFIG, device=dev, dtype=DTYPES[name],
                                generator=torch.Generator().manual_seed(0))
        for batch, impl in itertools.product(args.batch, args.impl):
            images = torch.from_numpy(
                np.random.default_rng(0).standard_normal(
                    (batch, CONFIG.img_size, CONFIG.img_size, 3))
                .astype(np.float32)).to(dev, DTYPES[name])
            with runtime.use_impl(impl):
                res = profile_call(lambda: model(images), batch)
            res.update(card=card, batch=batch, dtype=name, impl=impl,
                       unit="images")
            results.append(res)
            _report(res, f"Swin-T B={batch} {name} impl={impl} fused")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
