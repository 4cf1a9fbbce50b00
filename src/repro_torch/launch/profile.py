"""Where the time of a forward goes on the card.

Runs the full-width Swin-T fused forward (random weights from seed 0,
images from numpy seed 0), or an RWKV6-3B prefill of 512 tokens per
sequence and one decode step after it (random weights from a CUDA
generator with seed 0, tokens from seed 1), under ``torch.profiler``
and reports, per call: wall time (host clock around synchronised calls),
device busy time, the device's idle share, and device time by kernel
name and by design (the matmul's skinny / wgmma / ffma, attention's
mma / ffma, WKV's chunk / step).

    PYTHONPATH=src python -m repro_torch.launch.profile \
        --batch 8 64 --dtype fp32 bf16 --impl auto ref --out chiprun_out/profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile --model rwkv6-3b \
        --batch 4

``--impl ref`` profiles the plain PyTorch path on the card. A card is
required: without one it raises.
"""
from __future__ import annotations

import argparse
import itertools
import json
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
# names of the port's own kernels in the profiler's trace
# prompt tokens per sequence of the RWKV6-3B prefill
RWKV_SEQ = 512
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
           "wkv_kernel_step": "wkv step"}


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


def profile_rwkv(args, dev, card):
    """An RWKV6-3B prefill at (batch, RWKV_SEQ) and one decode step
    after it, per dtype, batch and impl."""
    cfg = get_config("rwkv6-3b")
    results = []
    for name in args.dtype:
        model = LanguageModel(
            cfg, device=dev, dtype=DTYPES[name],
            generator=torch.Generator(device=dev).manual_seed(0))
        for batch, impl in itertools.product(args.batch, args.impl):
            tokens = torch.randint(
                0, cfg.vocab, (batch, RWKV_SEQ), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
            with runtime.use_impl(impl), torch.no_grad():
                _, cache = model.prefill(tokens)
                lengths = torch.full((batch,), RWKV_SEQ, dtype=torch.int32,
                                     device=dev)
                step = tokens[:, -1:]
                for phase, fn, items in (
                        ("prefill", lambda: model.prefill(tokens),
                         batch * RWKV_SEQ),
                        ("decode", lambda: model.decode_step(cache, step,
                                                             lengths),
                         batch)):
                    res = profile_call(fn, items)
                    res.update(card=card, model=cfg.name, phase=phase,
                               batch=batch, seq=RWKV_SEQ, dtype=name,
                               impl=impl, unit="tokens")
                    results.append(res)
                    _report(res, f"{cfg.name} {phase} B={batch} "
                                 f"S={RWKV_SEQ} {name} impl={impl}")
        del model
        torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="swin-t",
                    choices=["swin-t", "rwkv6-3b"])
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
    if args.model == "rwkv6-3b":
        results = profile_rwkv(args, dev, card)
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
