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
   the bound, and the design the call took (matmul: skinny, wgmma,
   persistent or ffma; attention: mma or ffma; WKV: chunk or step; layernorm: cta or
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
   prefill and decode tokens/s; then the serving engine
   (``serve/engine.py``, :func:`serve_engine`) in fp32 on 4 slots at
   exact lengths: 4 requests of 97, 333, 64 and 200 tokens, 16 new
   tokens each, every call 321 / 0 / 97 / 32 launches (the engine's
   path through WKV), every stream held to its dense stream;
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
   bucket 1024; then the serving engine as a user drives it (submit,
   ``run``; :func:`serve_engine`) in fp32 on 4 slots (max_len 1024,
   pages of 16, chunks of 256, the prefix cache, speculation k=3): the
   six requests, one sharing the 700-token prompt's first 520 tokens (a
   prefix hit ending mid-page: a copy-on-write) and one of 200 whose
   tail repeats an earlier 24-token span, 32 tokens each; every call's
   launches exact (as above, the inserts none), every stream equal to
   its dense stream up to a near-tie, the pool conserved, the shapes
   within ``n_buckets + n_chunk_shapes + 1 + len(spec_ladder(3))``,
   prefix hits, copies on write, verify steps and accepted drafts all
   seen; the run under ``torch.cuda.set_sync_debug_mode("warn")``,
   whose warnings must be the engine's own reads (``Engine._fetch``):
   one after each decode step, verify step, admission and final chunk,
   none after an intermediate chunk or an insert; then four requests
   under the fault plan ``alloc@2,nan@4.1,exc@6`` (no speculation): the
   poisoned slot's request failed, one recovery from the injected
   exception only, the others exact; in bf16, the engine's decode
   tokens/s at B=4 after 512 against the bare paged loop's (its host
   cost a step), TTFT and inter-token latency p50 / p95, and accepted
   tokens a slot-step of the repeated-span request;
10. gemma3-27b at full width (jittered norms): 8 layers (one 5:1 group
   and the 2-layer local tail) in fp32, 2 prompts of 2048 tokens then 16
   greedy steps and 1 prompt of 1020 then 12 (its ring wraps from the
   fifth step), teacher-forced on the plain path's tokens (logits, picks,
   the final ring and global caches), 33 / 8 / 17 / 0 launches a
   prefill and 33 / 0 / 17 / 0 a step, and unfused (57 / 8 / 17 / 0);
   then, the fp32 model freed, 20 layers in bf16 (three groups and the
   tail; ``GEMMA_BF16_LAYERS``, cut from 62 to keep the run's time),
   81 / 20 / 41 / 0 and 81 / 0 / 41 / 0, layer by layer against fp32
   beside the float8
   control, its logits as readings; prefill and decode tokens/s
   (fused, unfused, plain), peak memory, the tied head's per-call
   transpose; paged serving of a 1500-token prompt chunked at 512 (its
   chunks cross the 1024 window: the ring pages wrap mid-prompt) and a
   300-token one-shot on 2 slots (max_len 2048), 17 tokens each with
   one verify step (3 / 1 drafts kept), held to the dense path as for
   deepseek-7b at 8 fp32 layers (33 / 8 / 17 / 0 a bucketed prefill,
   33 / 0 / 17 / 0 a chunk, verify and step) and at 20 bf16 layers
   (81 / 20 / 41 / 0, 81 / 0 / 41 / 0; logits and pool rows within
   the bf16 tolerance 3e-2), and the bf16 readings at B=2 after 1024
   tokens and for the 1500-token prompt chunked at 512; the serving
   engine on the same two requests at both depths (2 slots, max_len
   2048, chunks of 512, speculation k=3; the prefix cache asked for and
   left out, as a windowed arch opts out), held as for deepseek-7b;
   whisper-base at
   full width and depth on seeded frames (B=4 x 1500 x 512): the
   encoder's launches, 4 prompts of 64 tokens then 32 steps and 1 of 16
   then 8, fp32 teacher-forced (logits, picks,
   self and cross caches), the unfused prefill, bf16 layer by layer
   (encoder and decoder) and as readings; tokens/s;
11. zamba2-1.2b at full width and depth (38 layers: 32 Mamba2 and 6
   repeats of one shared attention block; Mamba2 vectors spread over
   Mamba2's own init ranges): 4 prompts of 512 tokens then 32 greedy
   steps and 1 of 333 then 8, fp32 teacher-forced (logits, picks, the
   Mamba2 conv and SSM states and the shared block's KV per repeat),
   89 / 6 / 77 / 0 launches a prefill and 89 / 0 / 77 / 0 a step; bf16
   layer by layer against fp32 beside the float8 control and at full
   depth as readings; the engine at exact lengths (4 slots: 97, 333, 64
   and 200 tokens, 16 new each; its cache holds the shared block's page
   pools and the Mamba2 layers' per-slot state) held as RWKV6-3B's; the
   weight-only int8 tree (the tied embedding and head, the shared
   block's projections) in fp32, its first-token logits through
   ``lm.forward`` and the engine against the plain path; tokens/s;
   then qwen2-moe-a2.7b at full depth (24 layers, 60 experts padded to
   64, top-4, 4 shared) and phi3.5-moe-42b-a6.6b cut to 8 layers (16
   experts top-2, LayerNorm with beta, GQA 32 over 8): 4 prompts of 256
   then 16 steps and 1 of 97 then 8 in fp32 (49 / 24 / 49 / 0 and
   49 / 0 / 49 / 0; 17 / 8 / 17 / 0 and 17 / 0 / 17 / 0), each layer's
   routing against fp32 (:func:`moe_layers`: no flip in fp32, bf16
   flips only below ``MOE_FLIP_MARGIN``), the fp32 model freed and the
   bf16 one built (readings at full depth, layers held), qwen2-moe's
   engine in bf16 (4 requests at exact lengths, 8 tokens); tokens/s;
12. qwen2-vl-2b at full width and depth (28 layers, 1.544 B parameters,
   M-RoPE, 12 query heads over 2 KV heads): 4 prompts of 512 tokens
   whose first 128 rows are patch embeddings on an 8 x 16 (t=0, h, w)
   grid, then 32 greedy steps, and 1 text prompt of 333 then 8, fp32
   teacher-forced (logits, picks, the KV cache), 113 / 28 / 57 / 0
   launches a prefill and 113 / 0 / 57 / 0 a step; bf16 layer by layer
   and as readings; the engine at exact lengths (97 / 333 / 64 / 200,
   16 tokens, text only); rates;
13. the gradients of the four ops through ``ops`` (``ops.KernelOp``:
   the kernels forward, the plain versions' gradient backward), fp32
   and bf16, against the plain path's at qwen2-vl-2b's shapes (the
   matmul with bias, residual, silu and gelu gated panels and split
   norms; group-6 attention, causal and windowed; RMS and LayerNorm
   with beta) and RWKV6-3B's WKV, within the kernel limits, the forward
   launching once and the backward never;
14. qwen2-vl-2b trained at full width and depth in fp32 (B=4 x 512,
   ``SyntheticLM``): step 0's ``lm.loss_fn`` and gradients on a batch
   with patch embeddings against the plain path (``TRAIN_LOSS_TOL``,
   ``TRAIN_GRAD_TOL``; the gradient reaching ``vis_embeds``), 20 steps
   of ``make_train_step`` (225 / 56 / 113 / 0 launches each with remat,
   no synchronising call, the loss falling by ``TRAIN_MARGIN``),
   tokens/s, forward and backward time, peak memory, idle share; then
   at ``RESUME_LAYERS`` = 2 layers: 10 steps straight against 6, a
   checkpoint, a restore and 4 more (within 1e-6), and
   ``launch/train.py`` stopped by SIGTERM in its fifth step and resumed
   from the checkpoint its hook wrote;
15. tensor-parallel serving (``serve/placement.py``, :func:`tp_phase`):
   deepseek-7b at full depth in fp32 and bf16, its weight-only int8
   tree in fp32, and gemma3-27b cut to 12 layers (two global layers,
   the window, the tied head) in bf16, each first on one device
   (``SingleDevice``, the reference), deepseek-7b fp32 then as
   ``TensorParallel(1)`` on a one-rank NCCL group, then every config at
   t = 2 as two processes sharing the card over gloo (NCCL refuses two
   ranks on one device; gloo stages each collective through host
   memory, so its step time is no TP speed): a dense prefill of a probe
   batch and a step (launches as one device's, fp32 first-token logits
   within 1e-3 x max(1, max|logit|) of one device's), decode steps
   timed, then the engine on 4 slots (six requests: two chunked at
   256, one prefix hit, one with a deadline): every rank's completions
   identical, equal to one device's exactly in fp32 and to the dense
   stream up to a near-tie in bf16, each call's launches one device's
   at the local shapes, 2 all-reduces a layer and one all-gather a
   model call of the untied head; each rank's peak memory; then
   ``launch/serve.py`` at ``--mesh-shape model=2`` (2 layers) against
   the same CLI on one device;
16. the training mesh (:func:`mesh_phase`): (a) qwen2-vl-2b at full
   width and depth, fp32, B=4 x 512, one device and then the sharded
   step on a (1,1,1) mesh over a one-rank NCCL group: 3 steps, losses,
   step-0 gradients and parameters bitwise one device's, launches one
   device's, collectives as the spec tree derives them, no synchronising
   call; then a world of two processes on the card over gloo: (b)
   data=2 and (c) pod=2 (the compressed step against the exact one, the
   int32 sum of the int8 payloads) on qwen2-vl-2b cut to
   ``MESH_VL_LAYERS``, (d) model=2 expert-parallel qwen2-moe-a2.7b at
   ``MESH_MOE_LAYERS`` (logits, aux loss, routing and gradient blocks
   against one device's), (e) the sequence-sharded decode of
   deepseek-7b at ``MESH_DECODE_LAYERS`` (logits and stream against the
   unsharded decode, half the cache a rank); (f) ``launch/train.py
   --mesh host`` (eight ranks), its elastic restore on one device and
   ``--compress-pods``;
17. the auditor and the cost models (:func:`audit_phase`): (a) the audit
   CLI on the card (``python -m repro_torch.analysis.audit --device
   cuda``, the reduced deepseek-7b engine): exit 0, every pass checked
   something, 0 host reads in each entry point by the dispatch recorder
   and by ``torch.cuda.set_sync_debug_mode("error")``, the engine's
   ``_fetch`` sites the allowlist's; (b) every built kernel (the
   library's ``rk_query_*`` and ``ptxas.log``) against its shared-memory
   model byte for byte, the H100's 232,448 bytes a block and 65,536
   registers an SM, no spill, and a seeded over-budget kernel firing
   RWA401; (c) the roofline (``launch/roofline.py``) of the launch
   records of one deepseek-7b bf16 prefill (B=4 x 512) and decode step
   (B=4) against PERF.md's bounds (25.14 ms for the 120 persistent launches,
   3.88 ms for the 121 skinny ones, within 0.5%), each kernel's share of
   its bound beside its device ms; (d) ``core/rowwise.py``'s tile
   constants against the library's; (e) a deepseek-7b bf16 engine run
   with the recording switch off and on (the same streams and launches),
   and the engine's entry points at full width (no host read, every
   cache leaf in place, a decode step's peak memory under a pool leaf);
18. the tooling (``tooling_phase``): (a) the op walk
   (``launch/op_cost.py``) of one deepseek-7b bf16 prefill (B=4 x 512)
   and one qwen2-moe-a2.7b bf16 prefill (B=4 x 256) on the card, each
   beside the profiler: the whole call's bound (kernels and glue) beside
   its busy ms, the glue's bound beside the "other" device ms, the
   walk's FLOPs equal to the same call's dry walk on ``meta`` tensors,
   and the 120 persistent launches' bound PERF.md's 25.1444 ms within 0.5%;
   (b) the dry-run CLI (``launch/dryrun.py``, on the CPU: a fake world)
   for deepseek-7b train_4k on the multipod mesh and gemma3-27b
   decode_32k on the pod mesh, exit 0 and every key in each JSON, and
   the dry run's ``HBM_BYTES`` the card's memory within 1%; (c)
   ``examples/torch_quickstart.py`` and ``torch_vit_rowwise.py`` with
   ``--device cuda``;
19. the int8 path: ``ops.matmul_int8`` at every Swin-T matmul shape
   (B=8), as often as a fused forward runs each (53 launches, counted),
   and its device time by matmul design (profiler);
20. the matmul, attention and WKV per design and dtype, summed over a
   Swin-T forward (B=8 and, for attention, B=64), a ViT-B/16 forward,
   each LM's prefill and decode step
   (``design-table`` lines); one JSON
   line of the kernels (the int8 leg a row of its own), then the last
   line ``{"ok": true, "device": {...}}``. Before the tables, the norm
   prologue's boundary (a ``threshold`` line, device µs from the
   profiler): each matmul design's norm prologue against the standalone
   norm and a prologue-free matmul at K = 64 .. 8192, each design's
   boundary beside the rule's; and the bf16 route's sweep (``persistent``
   lines, :func:`persistent_readings`): the wgmma and persistent designs'
   device µs at every projection shape of the benchmark's two cells,
   beside the bound, the library's ms and the route's pick. The other
   pickers' sweeps
   (:func:`threshold_readings`, :func:`wkv_threshold_readings`,
   :func:`layernorm_threshold_readings`), the zamba2 / qwen2-moe
   profiles (:func:`lm_profile`) and the ``SKINNY_NORM_MAX_K`` ABBA
   readings (:func:`skinny_norm_ab`) are readings of earlier slices,
   cut from the run for its time (``cut`` lines); each runs by hand.
   The kernels line gives layernorm once per design: over the fused
   Swin-T forward (rows) and over an RWKV6-3B decode step (cta), and
   attention a second time over a deepseek-7b prefill (causal), and
   once per new mode: gemma3-27b's windowed layers, whisper-base's
   encoder (S = 1500) and its cross-attention; and each of matmul,
   attention and layernorm over an fp32 prefill of zamba2-1.2b, of
   qwen2-moe-a2.7b and of qwen2-vl-2b, and over a qwen2-vl-2b train
   step, and over one tensor-parallel rank's deepseek-7b prefill at
   t = 2, and over one rank's train step on the training mesh at
   data=2 (``mesh-table`` lines), and over the bf16 prefills the tooling
   phase walks (their launches counted in the walk).

Phase 3 also holds every RWKV6-3B kernel call (M=2048 prefill and M=4
decode matmuls and norms, the WKV recurrence at B=4 x 512, B=1 x 333
and the B=4 decode step with a starting state) and every deepseek-7b
kernel call (its four matmul panels at M=2048 and M=4, the head at
N=102400 with fp32 out, causal attention at B=4 x 32 heads x 512 x 128
with ``F.scaled_dot_product_attention(is_causal=True)`` as the
yardstick, the final RMSNorm) against its plain version, and sums them
per prefill and per decode step of each model (``rwkv-table`` and
``dense-table`` lines); a windowed or cross attention case's yardstick
is SDPA with a boolean mask. So too every kernel call of a zamba2-1.2b
prefill (B=4 x 512) and step (B=4: in_proj at N = 8384 on every
matmul design, the gated RMS norm at D = 4096, the shared block's
attention at hd 64) and of the MoE archs' (B=4 x 256, B=4), in
``zamba2-table`` and ``moe-table`` lines; and of a qwen2-vl-2b prefill
(B=4 x 512: its group-6 attention), step (B=4) and fp32 train step
(each layer's calls twice, the head over 2048 rows), in ``vl-table``
lines; and every kernel call of one tensor-parallel rank's prefill and
step at its local shapes (deepseek-7b at t = 2 and t = 4, gemma3-27b at
12 layers and t = 2: the column panels at N / t, the row panels at
K / t with no residual, the vocab-sharded head at N / t, attention over
the rank's heads), in ``tp-table`` lines.

Details of every case go to ``chiprun_out/chip_smoke.json``. Any
mismatch, wrong count or failed phase raises, and the script exits
non-zero with no result line. It exits non-zero at once where
``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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

REPLACES = {
    "rowwise_matmul": "src/repro/kernels/rowwise_matmul.py:142",
    "flash_attention": "src/repro/kernels/flash_attention.py:101",
    "layernorm": "src/repro/kernels/layernorm.py:58",
    "wkv": "src/repro/kernels/wkv.py:66",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
# the kernels whose launches each run counts: the four above, then the
# SSD scan (csrc/ssd.cu), which replaces no TPU kernel (the JAX package
# scans in jnp): two launches a Mamba2 layer, its chunks' C B^T and the
# scan
KERNELS = (*REPLACES, "ssd")
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
        # the persistent design (M = 64) encodes its TMA maps per call
        "rowwise_matmul persistent bf16": (host_us(lambda: rowwise_matmul_p(
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
    """The least time of a call (``launch/roofline.py``: the H100 SXM's
    peaks, NVIDIA's data sheet, dense), in ms, and what bounds it."""
    from repro_torch.launch.roofline import bound as roofline_bound
    return roofline_bound(flops, nbytes, dtype_name)


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
# (8 layers in fp32, 32 in bf16), and per whisper-base prefill at B=4 x
# 64 (its encoder over 1500 frames included) and decode step at B=4, per
# zamba2-1.2b prefill at B=4 x 512 and decode step at B=4, per
# qwen2-moe-a2.7b prefill at B=4 x 256 and decode step at B=4, and per
# phi3.5-moe prefill (8 layers) at B=4 x 256 and decode step at B=4, and
# per prefill and step of one tensor-parallel rank (deepseek-7b at t = 2
# and t = 4, B=4 x 512 and B=4; gemma3-27b at 12 layers and t = 2, B=2 x
# 2048 and B=2)
COUNTS = ("fused", "unfused", "prefill", "decode", "vit", "fused64",
          "dprefill", "ddecode", "dunfused", "gprefill", "gdecode",
          "wprefill", "wdecode", "zprefill", "zdecode", "qprefill",
          "qdecode", "pprefill", "pdecode", "vprefill", "vdecode", "vtrain",
          "tprefill", "tdecode", "t4prefill", "t4decode", "tgprefill",
          "tgdecode", "mtrain")
# the count keys of the LM paths whose cases also read device ms
DEVICE_MS_KEYS = ("vit", "gprefill", "gdecode", "wprefill", "wdecode",
                  "zprefill", "zdecode", "qprefill", "qdecode", "pprefill",
                  "pdecode", "vprefill", "vdecode", "vtrain")
# the exact launches (rowwise_matmul, flash_attention, layernorm, wkv,
# ssd) of each fused run the model phases check, restated by hand as
# PERF.md §2 lists them; :func:`want_launches` also holds each against
# the count the config and ``rowwise_matmul.norm_prologue_fits`` give. A norm
# panel splits (one more layernorm launch) on the designs of many rows,
# and on the skinny design past SKINNY_NORM_MAX_K
LAUNCHES = {
    "swin-t": (53, 12, 25, 0, 0),                # B=8, fp32 and bf16
    "vit-b16": (50, 12, 25, 0, 0),               # B=8
    "deepseek-7b prefill": (121, 30, 61, 0, 0),  # 4 x 512 and 1 x 333
    "deepseek-7b step": (121, 0, 61, 0, 0),      # B=4 and B=1, K = 4096
    "gemma3-27b/8 prefill": (33, 8, 17, 0, 0),   # fp32, 8 layers
    "gemma3-27b/8 step": (33, 0, 17, 0, 0),      # K = 5376
    "gemma3-27b/20 prefill": (81, 20, 41, 0, 0),  # bf16, 20 layers
    "gemma3-27b/20 step": (81, 0, 41, 0, 0),
    "whisper-base encoder": (24, 6, 13, 0, 0),   # 4 x 1500 frames
    "whisper-base prefill": (67, 18, 32, 0, 0),  # 4 x 64, the encoder's too
    "whisper-base prefill 1x16": (67, 18, 20, 0, 0),  # 16 rows: skinny fp32
    "whisper-base step": (37, 0, 7, 0, 0),       # K = 512: the norm stays
    # paged serving: a bucketed prefill launches as the dense prefill at
    # its bucket ("... prefill"), a paged step as the dense step; a
    # chunk (256 or 512 rows) and a verify panel (16 or 8 rows) attend
    # in torch ops, as JAX does in jnp: no attention launch
    "deepseek-7b chunk": (121, 0, 61, 0, 0),
    "deepseek-7b verify": (121, 0, 61, 0, 0),
    "gemma3-27b/8 chunk": (33, 0, 17, 0, 0),
    "gemma3-27b/8 verify": (33, 0, 17, 0, 0),
    "gemma3-27b/20 chunk": (81, 0, 41, 0, 0),
    "gemma3-27b/20 verify": (81, 0, 41, 0, 0),
    # tensor-parallel serving: gemma3-27b cut to 12 layers (bf16), each
    # rank's calls as one device's, the norms split at K = 5376
    "gemma3-27b/12 prefill": (49, 12, 25, 0, 0),
    "gemma3-27b/12 chunk": (49, 0, 25, 0, 0),
    "gemma3-27b/12 verify": (49, 0, 25, 0, 0),
    "gemma3-27b/12 step": (49, 0, 25, 0, 0),
    # RWKV6-3B: a prefill (4 x 512, 1 x 333, the engine's exact lengths)
    # and a step (B=4, B=1): 10 matmuls, 3 norms and the recurrence a
    # layer, the head and the final norm
    "rwkv6-3b prefill": (321, 0, 97, 32, 0),
    "rwkv6-3b step": (321, 0, 97, 32, 0),
    # zamba2-1.2b: a Mamba2 layer 2 / 0 / 2 / 0 / 2 (in_proj, out_proj;
    # norm1, the gated RMS norm; the SSD scan's cb and scan launches, at
    # decode too), a shared-block repeat 4 / 1 / 2 (its qkv and mlp1 norms
    # split at K = 2048 on every design), the head 1 / 0 / 1
    "zamba2-1.2b prefill": (89, 6, 77, 0, 64),   # 4 x 512, 1 x 333, engine
    "zamba2-1.2b step": (89, 0, 77, 0, 64),      # B=4, B=2 and B=1
    # MoE: a layer 2 / 1 / 2 (qkv with its norm split, wo; norm2 before
    # the experts, which launch no kernel), the head 1 / 0 / 1
    "qwen2-moe-a2.7b prefill": (49, 24, 49, 0, 0),  # 24 layers
    "qwen2-moe-a2.7b step": (49, 0, 49, 0, 0),
    "phi3.5-moe/8 prefill": (17, 8, 17, 0, 0),   # 8 layers
    "phi3.5-moe/8 step": (17, 0, 17, 0, 0),
    # qwen2-vl-2b: a layer 4 / 1 / 2 (its qkv and gate|up norms split at
    # K = 1536 on every design), the head 1 / 0 / 1; a train step at B=4
    # x 512 with remat: the forward's, then each layer's once more as
    # the backward recomputes it (the head and final norm are not
    # recomputed); the backward itself launches no kernel
    "qwen2-vl-2b prefill": (113, 28, 57, 0, 0),  # 4 x 512, 1 x 333, engine
    "qwen2-vl-2b step": (113, 0, 57, 0, 0),
    "qwen2-vl-2b train step": (225, 56, 113, 0, 0),
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


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
    from repro_torch.kernels.rowwise_matmul import (call_design,
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
        design=call_design(x, w, wg, norm), **counts)
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
    want = dict(zip(KERNELS, LAUNCHES[key]))
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
            "wkv": 0, "ssd": 0}


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


# gemma3-27b's depth in bf16 here: three 5:1 groups and the 2-layer
# local tail of the 62 (cut to keep the script's time)
GEMMA_BF16_LAYERS = 20


def gemma_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a gemma3-27b prefill at B=2 x 2048
    (M=4096) and of a decode step at B=2 (M=2), with its launches per
    prefill and per step of the model the phase runs in ``dtype`` (fp32:
    8 layers, 7 local and 1 global; bf16: 20, 17 local and 3
    global). Per layer: the qkv panel (32 q and 2 x 16 kv heads of 128)
    and the gate|up panel (GeGLU) with the RMS norm (split or not:
    :func:`norm_matmul_cases`), wo and down with the residual; causal
    attention at prefill, with the 1024-token window on the local layers
    (GQA 32 over 16, head dim 128; decode attends in torch ops); the
    tied head (N = 262144, fp32 out) and the final norm on the last
    position only."""
    import torch
    from repro_torch.models import attention, lm
    n_layers = 8 if dtype == torch.float32 else GEMMA_BF16_LAYERS
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


def zamba2_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a zamba2-1.2b prefill at B=4 x 512
    (M=2048) and of a decode step at B=4 (M=4), with its launches per
    prefill and per step. A Mamba2 layer (32): norm1 (RMS, D = 2048),
    in_proj (N = 8384 = 2 d_inner + 2 d_state + heads: an odd multiple
    of 64, on the skinny design at decode and on ffma / wgmma at
    prefill), the gated RMS norm over y * silu(z) (D = d_inner = 4096),
    out_proj. The shared block (6 repeats of one weight copy): the qkv
    and GELU mlp1 panels with the RMS norm (split or not:
    :func:`norm_matmul_cases`), wo and mlp2 with the residual, causal
    attention at prefill (32 heads of 64). The tied head (N = 32000, fp32
    out) and the final norm on the last position."""
    from repro_torch.models import lm, mamba2
    s, d_in, heads, _ = mamba2._dims(cfg)
    d, f = cfg.d_model, cfg.d_ff
    n_mamba = sum(st.repeat for st in cfg.stages() for b in st.body
                  if b.mixer == "mamba2")
    n_attn = sum(st.repeat for st in cfg.stages() for b in st.body
                 if b.mixer == "attn")
    proj = 2 * d_in + 2 * s.d_state + heads
    cases = []
    for m, key in ((4 * 512, "zprefill"), (4, "zdecode")):
        tag = f"zamba2.{'prefill' if m > 4 else 'decode'}"
        cases += [
            layernorm_case(f"{tag} norm1", m, d, dtype, gen, device,
                           kind="rms", **{key: n_mamba}),
            matmul_case(f"{tag} in_proj", m, d, proj, dtype, gen, device,
                        bias=False, **{key: n_mamba}),
            layernorm_case(f"{tag} gated norm", m, d_in, dtype, gen,
                           device, kind="rms", **{key: n_mamba}),
            matmul_case(f"{tag} out_proj", m, d_in, d, dtype, gen, device,
                        bias=False, **{key: n_mamba}),
            matmul_case(f"{tag} shared wo+res", m, d, d, dtype, gen, device,
                        bias=False, residual=True, **{key: n_attn}),
            matmul_case(f"{tag} shared mlp2+res", m, f, d, dtype, gen,
                        device, bias=False, residual=True, **{key: n_attn}),
        ]
        cases += norm_matmul_cases(f"{tag} shared qkv", m, d, 3 * d, dtype,
                                   gen, device, norm="rms", bias=False,
                                   **{key: n_attn})
        cases += norm_matmul_cases(f"{tag} shared mlp1+gelu", m, d, f,
                                   dtype, gen, device, norm="rms",
                                   bias=False, act="gelu", **{key: n_attn})
    cases += [
        attention_case("zamba2.prefill causal", (4, 512, cfg.head_dim),
                       cfg.n_heads, cfg.n_kv_heads, dtype, gen, device,
                       causal=True, zprefill=n_attn),
        matmul_case("zamba2 tied head fp32-out", 4, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True,
                    zprefill=1, zdecode=1),
        layernorm_case("zamba2 final_norm", 4, d, dtype, gen, device,
                       kind="rms", zprefill=1, zdecode=1),
    ]
    return cases


def moe_cases(cfg, dtype, gen, device, keys):
    """Every distinct kernel call of an MoE LM's prefill at B=4 x 256
    (M=1024) and decode step at B=4 (M=4), with its launches per prefill
    and per step under ``keys`` (prefill, decode): per layer the qkv
    panel with the pre-norm (split or not: :func:`norm_matmul_cases`;
    qwen2-moe RMS, phi3.5-moe LayerNorm with beta), wo with the
    residual, the standalone norm2 before the experts (whose router,
    dispatch and einsums are torch ops, as in JAX), causal attention at
    prefill (qwen2-moe 16 heads of 128; phi3.5-moe GQA 32 over 8); the
    head (fp32 out) and the final norm on the last position."""
    from repro_torch.models import attention, lm
    d, layers = cfg.d_model, cfg.n_layers
    qkv, ho = sum(attention.proj_splits(cfg)), cfg.n_heads * cfg.head_dim
    name = cfg.name.split("-")[0]
    cases = []
    for m, key in ((4 * 256, keys[0]), (4, keys[1])):
        tag = f"{name}.{'prefill' if m > 4 else 'decode'}"
        cases += norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen,
                                   device, norm=cfg.norm, bias=False,
                                   **{key: layers})
        cases += [
            matmul_case(f"{tag} wo+res", m, ho, d, dtype, gen, device,
                        bias=False, residual=True, **{key: layers}),
            layernorm_case(f"{tag} norm2", m, d, dtype, gen, device,
                           kind=cfg.norm, **{key: layers}),
        ]
    cases += [
        attention_case(f"{name}.prefill causal", (4, 256, cfg.head_dim),
                       cfg.n_heads, cfg.n_kv_heads, dtype, gen, device,
                       causal=True, **{keys[0]: layers}),
        matmul_case(f"{name} lm_head fp32-out", 4, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True,
                    **{keys[0]: 1, keys[1]: 1}),
        layernorm_case(f"{name} final_norm", 4, d, dtype, gen, device,
                       kind=cfg.norm, **{keys[0]: 1, keys[1]: 1}),
    ]
    return cases


def vl_cases(cfg, dtype, gen, device):
    """Every distinct kernel call of a qwen2-vl-2b prefill at B=4 x 512
    (M=2048) and decode step at B=4 (M=4), with its launches per prefill
    and per step (``vprefill`` / ``vdecode``), and in fp32 per train step
    at B=4 x 512 (``vtrain``: each layer's calls twice, the forward's and
    the recomputation's, the head and final norm at M=2048 once): per
    layer the qkv panel (q 1536, k and v 256 each) and the gate|up panel
    with the RMS norm (split at K = 1536), wo and down with the
    residual, causal attention of 12 query heads over 2 KV heads (a
    group of 6) at head dim 128; the tied head (N = 152064 padded to
    152064) with fp32 out."""
    import torch
    from repro_torch.models import attention, lm
    d, f, n_layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    qkv, ho = sum(attention.proj_splits(cfg)), cfg.n_heads * cfg.head_dim
    train = dtype == torch.float32
    cases = []
    for m, key in ((4 * 512, "vprefill"), (4, "vdecode")):
        tag = f"vl.{'prefill' if m > 4 else 'decode'}"
        counts = {key: n_layers}
        if m > 4 and train:
            counts["vtrain"] = 2 * n_layers
        cases += norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen,
                                   device, norm="rms", bias=False, **counts)
        cases += norm_matmul_cases(f"{tag} gate|up+silu", m, d, f, dtype,
                                   gen, device, norm="rms", bias=False,
                                   act="silu", gated=True, panel=(2 * f, 0),
                                   **counts)
        cases += [
            matmul_case(f"{tag} wo+res", m, ho, d, dtype, gen, device,
                        bias=False, residual=True, **counts),
            matmul_case(f"{tag} down+res", m, f, d, dtype, gen, device,
                        bias=False, residual=True, **counts),
        ]
    vp = lm.padded_vocab(cfg)
    cases += [
        attention_case("vl.prefill causal", (4, 512, cfg.head_dim),
                       cfg.n_heads, cfg.n_kv_heads, dtype, gen, device,
                       causal=True, vprefill=n_layers,
                       **({"vtrain": 2 * n_layers} if train else {})),
        matmul_case("vl lm_head fp32-out", 4, d, vp, dtype, gen, device,
                    bias=False, out_f32=True, vprefill=1, vdecode=1),
        layernorm_case("vl final_norm", 4, d, dtype, gen, device,
                       kind="rms", vprefill=1, vdecode=1),
    ]
    if train:
        cases += [
            matmul_case("vl.train lm_head fp32-out", 4 * 512, d, vp, dtype,
                        gen, device, bias=False, out_f32=True, vtrain=1),
            layernorm_case("vl.train final_norm", 4 * 512, d, dtype, gen,
                           device, kind="rms", vtrain=1),
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
# the K of every Swin-T stage and ViT-B/16, the skinny boundary and the
# point above it, and the LM widths (deepseek-7b 4096, gemma3-27b 5376);
# 128, 256, 320 and 512 were cut for the script's time (PERF.md keeps
# their last readings)
PROLOGUE_KS = (64, 96, 192, 384, 768, 1024, 2048, 4096, 5376, 8192)


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
                assert rm.pick_design(m, dt, n, k, prologue=True) == design
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
                # a call of the M = 2048 / 4096 panels takes up to 0.1 s:
                # 3 a profile, for the script's time
                calls = 3 if design != "skinny" else 10
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


# the bf16 route's sweep: deepseek-7b's prefill at the benchmark mix's
# least, a middle and its largest rows (B=4 x 407, 1771, 4096 tokens),
# its projections at few rows (decode steps and verify panels of 8 to 32
# slots: the route's boundary in M) and Swin-T's forward at the
# benchmark's batch
PERSISTENT_LM_M = (1628, 7084, 16384)
PERSISTENT_FEW_M = (8, 16, 32)
PERSISTENT_SWIN_BATCH = 64


def persistent_shapes(swin, dense):
    """(name, M, K, N, matmul_case options) of every projection of the
    benchmark's two cells: deepseek-7b's qkv, wo with its residual, the
    gated gate|up panel (SwiGLU) and down with its residual at each M of
    :data:`PERSISTENT_LM_M` (and of :data:`PERSISTENT_FEW_M`, off the
    cells); Swin-T's patch embedding, each stage's qkv,
    mlp1 (GELU), proj and mlp2 with their residuals, the merges and the
    head (fp32 out), at B = :data:`PERSISTENT_SWIN_BATCH`."""
    d, f = dense.d_model, dense.d_ff
    out = []
    for m in PERSISTENT_LM_M + PERSISTENT_FEW_M:
        out += [("deepseek qkv", m, d, 3 * d, dict(bias=False)),
                ("deepseek wo+res", m, d, d, dict(bias=False,
                                                  residual=True)),
                ("deepseek gate|up+silu", m, d, f, dict(
                    bias=False, act="silu", gated=True, panel=(2 * f, 0))),
                ("deepseek down+res", m, f, d, dict(bias=False,
                                                    residual=True))]
    b, res, c = PERSISTENT_SWIN_BATCH, swin.img_size // swin.patch, \
        swin.embed_dim
    out.append(("swin patch", b * res * res, swin.patch ** 2 *
                swin.in_chans, c, {}))
    for si in range(len(swin.depths)):
        m, s = b * res * res, f"swin s{si + 1}"
        out += [(f"{s}.qkv", m, c, 3 * c, {}),
                (f"{s}.mlp1+gelu", m, c, 4 * c, dict(act="gelu")),
                (f"{s}.proj+res", m, c, c, dict(residual=True)),
                (f"{s}.mlp2+res", m, 4 * c, c, dict(residual=True))]
        if si < len(swin.depths) - 1:
            out.append((f"{s}.merge", m // 4, 4 * c, 2 * c,
                        dict(bias=False)))
            res, c = res // 2, c * 2
    out.append(("swin head", b, c, swin.num_classes, dict(out_f32=True)))
    return out


def persistent_readings(device):
    """Device µs per call of the wgmma and persistent designs (the route
    forced each way) at every shape of :func:`persistent_shapes`, each
    output held against the plain version in fp32, beside the bound,
    the library's event ms (``torch.addmm`` and the epilogue in torch)
    and the design the route picks: the measurement behind
    ``rowwise_matmul.persistent_fits``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.swin_t import CONFIG
    from repro_torch.kernels import rowwise_matmul as rm
    from repro_torch.launch.profile import kernel_us
    gen = torch.Generator(device=device).manual_seed(10)
    route = rm.persistent_fits
    out = {}
    try:
        for name, m, k, n, kw in persistent_shapes(
                CONFIG, get_config("deepseek-7b")):
            case = matmul_case(name, m, k, n, torch.bfloat16, gen, device,
                               **kw)
            want = case.check()
            row = {"m": m, "k": k, "n": n, "route": case.design}
            calls = 3 if case.flops > 2e11 else 10
            for design in ("wgmma", "persistent"):
                rm.persistent_fits = (lambda m_, n_, k_, d=design:
                                      d == "persistent")
                err, ok = err_ok(case.run(), want, BF16_TOL)
                if not ok:
                    raise AssertionError(f"persistent sweep {case.name} "
                                         f"{design}: max abs err {err}")
                row[f"{design}_us"] = kernel_us(
                    case.run, f"rowwise_matmul_kernel_{design}", calls)
            rm.persistent_fits = route
            b_ms, b_by = bound(case.flops, case.nbytes, "bf16")
            row.update(bound_us=b_ms * 1e3, bound_by=b_by,
                       library_ms=cuda_time(case.library))
            out[case.name] = row
            faster = ("persistent" if row["persistent_us"] < row["wgmma_us"]
                      else "wgmma")
            say("persistent", f"{case.name}: wgmma {row['wgmma_us']:.2f} "
                f"µs, persistent {row['persistent_us']:.2f} µs "
                f"({row['wgmma_us'] / row['persistent_us']:.2f}x), bound "
                f"{row['bound_us']:.2f} µs ({b_by}; "
                f"{row['bound_us'] / row['persistent_us']:.1%} of it), "
                f"library {row['library_ms']:.4f} ms; the route takes "
                f"{row['route']}, the faster is {faster}")
            del case, want
    finally:
        rm.persistent_fits = route
    return out


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
            "flash_attention": 0, "layernorm": 0, "wkv": 0, "ssd": 0}
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
        elif timed and any(case.counts[k] for k in DEVICE_MS_KEYS):
            # the device ms of the ViT-B/16 attention and of every kernel
            # call of the gemma3-27b, whisper-base, zamba2 and MoE paths
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


# the launch records of the last counted() call (attention_modes)
_COUNTED_RECORDS: list = []


def launches():
    """The launches counted so far of each kernel (the port's trace,
    ``core/trace.py``: they move while it records)."""
    from repro_torch.core import trace
    return {k: trace.launches(k) for k in KERNELS}


def counted(fn):
    """Run fn inside the trace's ``recording()``; return its result and
    the launches of each kernel it made (its records are kept for
    :func:`attention_modes`)."""
    import torch
    from repro_torch.core import trace
    global _COUNTED_RECORDS
    with trace.recording() as recs:
        before = launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: n - before[k] for k, n in launches().items()}
    _COUNTED_RECORDS = recs
    return out, counts


def attention_modes():
    """The attention launches of the last :func:`counted` call by mode
    (``flash_attention.mode_of``), from its launch records."""
    from repro_torch.kernels.flash_attention import mode_of
    modes = {}
    for r in _COUNTED_RECORDS:
        if r["kernel"] == "flash_attention" and r["launched"]:
            sq, skv = r["tensors"]["q"][0][2], r["tensors"]["k"][0][2]
            mode = mode_of(r["causal"], r["window"], sq, skv)
            modes[mode] = modes.get(mode, 0) + 1
    return modes


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


# the leaves the JAX package keeps fp32 in a bf16 model: RWKV6's ``u``
# and ``w0``, Mamba2's ``A_log``, ``dt_bias`` and ``D``
FP32_LEAVES = ("u", "w0", "A_log", "dt_bias", "D")


def to_bf16(tree, key=None):
    """The tree in bf16 but for the :data:`FP32_LEAVES`."""
    import torch
    if isinstance(tree, dict):
        return {k: to_bf16(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_bf16(v) for v in tree]
    return tree if key in FP32_LEAVES else tree.to(torch.bfloat16)


def rwkv_state(cache):
    """The final WKV states of an RWKV6 cache (its first layer's)."""
    return [cache[0]["0"]["rwkv_t"]["wkv"]]


def kv_state(cache):
    """The K and V leaves of a dense cache, every layer."""
    return list(cache[0]["0"]["kv"])


class RouteReplay:
    """Teacher-forced routing for :func:`check_serving` on an MoE model,
    as its tokens are teacher-forced: :meth:`record` wraps
    ``moe._route`` to keep each call's picks and probabilities (the
    plain path's); :meth:`replay` gives each call of the kernel path the
    recorded picks, its gate values taken from its own probabilities,
    and notes each token it would have routed otherwise (a flip) with
    the recorded top-k margin (the logit gap between the k-th and
    (k+1)-th expert). Without it, one flip at a near-tie moves that
    token's whole row in every later layer's KV."""

    def __init__(self, cfg):
        self.k, self.calls, self.seen = cfg.moe.top_k, [], []

    @contextlib.contextmanager
    def _wrapped(self, fn):
        from repro_torch.models import moe
        orig = moe._route
        moe._route = lambda *args: fn(orig, *args)
        try:
            yield
        finally:
            moe._route = orig

    def record(self):
        def route(orig, *args):
            out = orig(*args)
            self.calls.append(out[1:])
            return out
        return self._wrapped(route)

    def replay(self):
        import torch
        from repro_torch.models import moe
        turn = iter(self.calls)

        def route(orig, *args):
            _, idx, probs = orig(*args)
            ridx, rprobs = next(turn)
            e = probs.shape[-1]
            flip = (moe._one_hot(idx, e, torch.bool).any(1)
                    != moe._one_hot(ridx, e, torch.bool).any(1)).any(-1)
            top = rprobs.sort(-1, descending=True).values
            self.seen.append((flip, top[:, self.k - 1].log()
                              - top[:, self.k].log()))
            gate = probs.gather(-1, ridx)
            return (gate / torch.clamp(gate.sum(-1, keepdim=True),
                                       min=1e-9), ridx, probs)
        return self._wrapped(route)

    def flips(self):
        """The margins of the tokens the kernel path routed otherwise."""
        return [g for flip, gap in self.seen for g in gap[flip].tolist()]


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
    an encoder-decoder model, given to each prefill. An MoE model's
    teacher-forced kernel path takes the plain path's routing too
    (:class:`RouteReplay`): a token it would have routed otherwise must
    be a routing near-tie, its margin within ``tol`` (logit units)."""
    import torch
    from repro_torch.core import runtime
    b, s = prompts.shape
    want_decode = want_decode or want_counts
    routes = RouteReplay(model.cfg) if model.cfg.moe is not None else None
    with torch.no_grad():
        with runtime.use_impl("ref"), (
                routes.record() if routes else contextlib.nullcontext()):
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
        with routes.replay() if routes else contextlib.nullcontext():
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
    flips = routes.flips() if routes else []
    held = ("readings only; greedy picks differ at " if tol is None else
            f"tol={tol}*max(1,max|logit|); greedy picks equal but for ")
    routed = (f"; routing teacher-forced: {len(flips)} token-calls the "
              f"kernel path routed otherwise, margins "
              f"{sorted(round(g, 7) for g in flips)[-4:]} largest"
              if routes else "")
    say(phase, f"B={b} S={s} + {n_steps} steps: logits max|logit|="
               f"{scale:.4g} max_abs_err={worst:.4g} (prefill "
               f"{step_errs[0]:.4g}, last step {step_errs[-1]:.4g}) "
               f"{held}{ties} rows; final {state.__name__} "
               f"max_abs_err={s_err:.4g}; launches per prefill "
               f"{all_counts[0]} (attention by mode {modes}), per step "
               f"{all_counts[-1]}; greedy "
               f"stream on the kernels: {same:.3f} of its tokens equal "
               f"the plain path's, launches {greedy_counts}{routed}")
    if tol is not None and any(g > tol for g in flips):
        raise AssertionError(f"{phase}: the kernel path routes tokens "
                             f"otherwise at margins {sorted(flips)}")
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
            "routing_flips": flips,
            "prefill_modes": modes, "decode_counts": all_counts[-1],
            "tokens": torch.stack(toks, 1).tolist()}


def bf16_layers(phase, model16, prompts, frames=None, extra=None):
    """Each layer of the bf16 model at prefill, run on the plain bf16
    path's input to it (so no error carries from layer to layer), against
    the same layer in fp32 on the same weights and input, as rms(err) /
    rms(out): the kernel path (held to ``BF16_LAYER_TOL``; fused or not
    as ``runtime.pipeline_fusion`` says), the plain bf16 path
    (bf16's own rounding, for scale) and a control in lower precision.
    ``frames``: an encoder-decoder's, whose encoder layers run first
    (windowless, as ``lm.encode`` runs them) and whose plain bf16 output
    every decoder layer's cross-attention reads (the fp32 layer its fp32
    copy). ``extra``: a vision arch's patch embeddings and (t, h, w)
    positions. Returns the worst reading over layers of each path and
    the control's least."""
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
        x = lm._add_positions(lm.embed(tree, prompts, cfg, extra), cfg)
        layers(cfg.stages(), tree["stages"], x,
               lm._positions(cfg, prompts, extra), enc_out)
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


def skinny_norm_ab(name, models, prompts, smi, steps=8, rounds=3):
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
    f32 = torch.float32
    counts = want_launches("rwkv6-3b prefill", lm_counts(
        cfg, 4 * 512, f32, attention=True))
    step = want_launches("rwkv6-3b step", lm_counts(cfg, 4, f32,
                                                    attention=False))
    out = {"params": n_params,
           "fp32_b4": check_serving("rwkv-fp32", model, prompts, 32,
                                    LOGIT_TOL, counts, want_decode=step),
           "fp32_b1": check_serving("rwkv-fp32", model, prompt1, 8,
                                    LOGIT_TOL, counts, want_decode=step)}
    # the engine at exact lengths on 4 slots: its path through WKV
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 333, 64, 200)]
    out["engine_fp32"] = exact_engine("rwkv-engine", model, reqs, LOGIT_TOL,
                                      f32, max_new=16)
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


# ------------------------------ the serving engine ----------------------


def agree_dense(phase, rid, got, oracle):
    """How many leading tokens of a served stream equal the dense
    stream's (``dense_oracle``); a difference before the dense stream's
    first near-tie raises (the rule of ``PagedServing.agree``)."""
    want = oracle["tokens"]
    j = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
             len(got))
    if j < len(got) and not any(oracle["ties"][:j + 1]):
        raise AssertionError(f"{phase}: request {rid} leaves the dense "
                             f"stream at token {j} before a near-tie")
    return j


ENGINE_CALLS = {"_admit": "prefill", "_chunk": "chunk", "_step": "step",
                "_spec": "verify", "_insert_accepted": "insert_verify"}


def serve_engine(phase, model, prompts, oracles, *, want, max_new,
                 path=("rowwise_matmul", "flash_attention", "layernorm"),
                 sync_check=True, plan=None, eng=None, deadlines=None,
                 **engine_kw):
    """Serve ``prompts`` (greedy, ``max_new`` tokens each) through the
    port's ``serve.engine.Engine`` on the card, as a user would: submit,
    then ``run``. Every step program the engine calls (``_admit``,
    ``_chunk``, ``_step``, ``_spec``, ``_insert_accepted``) is wrapped
    to count its launches, held to ``want`` (by kind, a callable of the
    call's rows); the launch counts are set to 0 just before ``run`` and
    read just after: each kernel of ``path`` launched, and no launch
    outside the calls. With ``sync_check`` the run goes under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising CUDA
    call warns, and the warnings must be the engine's own reads
    (``Engine._fetch``, counted in ``device_reads``), one after each
    decode step, verify step, admission and final chunk and none after
    an intermediate chunk or an insert. Every stream is held to its
    dense oracle (``oracles[rid]``, near-tie rule; ``None``: readings),
    every status must be ``ok`` and no exception may reach the engine's
    recovery boundary (under a fault ``plan`` the caller holds the
    statuses, and only the injected faults may reach it). The
    engine's keyword arguments: those of ``Engine`` and of
    ``PagingConfig``; or ``eng``, an engine built already (on a
    placement). ``deadlines``: {rid: seconds} of the requests that
    carry one."""
    import collections
    import inspect
    import linecache
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import trace
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import paging
    cfg = model.cfg
    pkw = {k: engine_kw.pop(k) for k in list(engine_kw)
           if k in {f.name for f in dataclasses.fields(PagingConfig)}}
    t0 = time.perf_counter()
    if eng is None:
        eng = engine_mod.Engine(model.params.tree(), cfg, eos_id=-1,
                                device="cuda", paging=PagingConfig(**pkw),
                                faults=plan, **engine_kw)
    rows_of = {"_admit": lambda a: a[0].shape[1],
               "_chunk": lambda a: a[0].shape[1],
               "_step": lambda a: eng.n_slots,
               "_spec": lambda a: a[0].numel(),
               "_insert_accepted": lambda a: None}
    calls = {kind: [] for kind in ENGINE_CALLS.values()}
    events = []        # (kind, device reads before, host clock)
    host_s = {kind: [] for kind in ENGINE_CALLS.values()}
    read_s = []        # each read's wait for the card, host clock

    def wrap(name):
        orig = getattr(eng, name)

        def call(*args, **kw):
            kind = ENGINE_CALLS[name]
            events.append((kind, eng.device_reads, time.perf_counter()))
            before = launches()
            t = time.perf_counter()
            out = orig(*args, **kw)
            host_s[kind].append(time.perf_counter() - t)
            got = {n: k - before[n] for n, k in launches().items()}
            w = want[kind]
            w = w(rows_of[name](args)) if callable(w) else w
            calls[kind].append(got)
            if got != w:
                raise AssertionError(f"{phase}: engine {kind} launches {got},"
                                     f" want {w}")
            return out
        setattr(eng, name, call)
    for name in ENGINE_CALLS:
        wrap(name)
    fetch = eng._fetch

    def timed_fetch(*values):
        t = time.perf_counter()
        out = fetch(*values)
        read_s.append(time.perf_counter() - t)
        return out
    eng._fetch = timed_fetch
    for rid, p in enumerate(prompts):
        eng.submit(engine_mod.Request(
            rid=rid, prompt=p.cpu().numpy(), max_new=max_new,
            deadline_s=(deadlines or {}).get(rid)))
    torch.cuda.synchronize()
    # the launches are counted while the trace records (the host times
    # include its records)
    with warnings.catch_warnings(record=True) as caught, \
            trace.recording():
        base = launches()
        warnings.simplefilter("always")
        if sync_check:
            torch.cuda.set_sync_debug_mode("warn")
        # switching the mode on may itself warn, once in a process
        n0 = len(caught)
        try:
            t_run = time.perf_counter()
            done = sorted(eng.run(), key=lambda c: c.rid)
            run_s = time.perf_counter() - t_run
            caught = caught[n0:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        totals = {n: k - base[n] for n, k in launches().items()}
    # the reads that followed each call, up to the next call (or the end)
    ends = [e[1] for e in events[1:]] + [eng.device_reads]
    reads = collections.defaultdict(collections.Counter)
    for (kind, r0, _), r1 in zip(events, ends):
        reads[kind][r1 - r0] += 1
    injected = ("StepFault(", "AllocFault(") if plan else ()
    if any(not e.startswith(injected) for e in eng.errors):
        raise AssertionError(f"{phase}: the engine recovered from a real "
                             f"exception: {eng.errors}")
    eng.pool.check_conservation()
    if sorted(c.rid for c in done) != list(range(len(prompts))):
        raise AssertionError(f"{phase}: completions "
                             f"{[c.rid for c in done]}")
    same = {}
    for c in done:
        if c.status == "ok" and oracles is not None:
            same[c.rid] = agree_dense(phase, c.rid, c.tokens,
                                      oracles[c.rid]) / len(c.tokens)
    if plan is None and any(c.status != "ok" for c in done):
        raise AssertionError(f"{phase}: statuses "
                             f"{[(c.rid, c.status) for c in done]}")
    read_rule = {"step": {1}, "verify": {1}, "prefill": {1},
                 "chunk": {0, 1}, "insert_verify": {0}}
    bad_reads = {k: dict(v) for k, v in reads.items()
                 if not set(v) <= read_rule[k]}
    if bad_reads:
        raise AssertionError(f"{phase}: device reads after each call "
                             f"{bad_reads}")
    syncs, source = collections.Counter(), {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{Path(w.filename).name}:{w.lineno}"
            syncs[at] += 1
            source[at] = linecache.getline(w.filename, w.lineno).strip()
    lines, first = inspect.getsourcelines(engine_mod.Engine._fetch)
    fetch_at = {f"engine.py:{first + i}" for i in range(len(lines))}
    if sync_check and (sum(syncs.values()) != eng.device_reads
                       or not set(syncs) <= fetch_at):
        raise AssertionError(f"{phase}: synchronising calls {dict(syncs)} "
                             f"({source}), the engine read the device "
                             f"{eng.device_reads} times at {fetch_at}")
    summed = {k: sum(c[k] for v in calls.values() for c in v)
              for k in totals}
    missing = [k for k in path if not totals[k]]
    if missing or summed != totals:
        raise AssertionError(f"{phase}: the engine's run launched "
                             f"{totals}, its calls {summed}: none of "
                             f"{missing}")
    counts = eng.compile_counts()
    n_chunk_shapes = (len([b for b in eng.buckets if b <= eng.prefill_chunk])
                      if eng.prefill_chunk else 0)
    bound = ((len(eng.buckets) if eng.buckets else len(prompts))
             + n_chunk_shapes + 1 + len(paging.spec_ladder(eng.spec_k)))
    if sum(counts.values()) > bound:
        raise AssertionError(f"{phase}: shapes {counts} past the bound "
                             f"{bound}")
    steps = [e[2] for e in events if e[0] == "step"]
    res = {"statuses": {c.rid: c.status for c in done},
           "tokens": {c.rid: c.tokens for c in done},
           "tokens_equal_dense": same, "stats": dict(eng.stats),
           "compile_counts": counts, "shape_bound": bound,
           "calls": {k: len(v) for k, v in calls.items()},
           "launches": {k: v[0] for k, v in calls.items() if v},
           "run_launches": totals,
           "reads_after": {k: dict(v) for k, v in reads.items()},
           "device_reads": eng.device_reads, "syncs": dict(syncs),
           "errors": list(eng.errors),
           "prefix_cache": eng.prefix_cache is not None,
           "ttft_s": [c.ttft_s for c in done],
           "itl_s": [g for c in done for g in c.itl_s],
           "step_gaps_s": list(np.diff(steps)), "host_s": host_s,
           "read_s": read_s, "run_s": run_s,
           "seconds": time.perf_counter() - t0}
    say(phase, f"engine: {len(prompts)} requests (prompts "
        f"{[p.shape[0] for p in prompts]}, {max_new} new tokens) on "
        f"{eng.n_slots} slots of pages of {eng.page_size}, chunk "
        f"{eng.prefill_chunk}, prefix cache "
        f"{'on' if res['prefix_cache'] else 'off'}, speculation k="
        f"{eng.spec_k}{', faults ' + plan.describe() if plan else ''}: "
        f"statuses {sorted(collections.Counter(res['statuses'].values()).items())}; "
        f"calls {res['calls']}, launches a call {res['launches']}, in the "
        f"run {totals}; device reads {eng.device_reads} ("
        + ("synchronising calls " + ", ".join(
            f"{k} x{v}" for k, v in syncs.items())
           if sync_check else "sync debug off")
        + f"), reads after each call {res['reads_after']}; shapes {counts} "
        f"(bound {bound}); stats " + ", ".join(
            f"{k} {v}" for k, v in eng.stats.items() if v)
        + f"; tokens equal to the dense stream "
        f"{[round(same[r], 3) for r in sorted(same)]}; recovered from "
        f"{eng.errors}; {res['run_s']:.1f} s run, "
        f"{res['seconds']:.1f} s in all")
    return res


def engine_requests(reqs, gen, vocab):
    """deepseek-7b's eight engine requests: PR 19's six paged requests,
    then one sharing the 700-token prompt's first 520 tokens (a prefix
    hit ending mid-page: a copy-on-write of the partial page) and one of
    200 whose last 24 tokens repeat an earlier 24-token span (so the
    drafter proposes from the prompt). The shared one comes fifth, so
    the 700-token prompt's pages are in the tree when it admits."""
    import torch
    share = torch.cat([reqs[3][:520], torch.randint(
        0, vocab, (80,), generator=gen, device="cuda")])
    head = torch.randint(0, vocab, (176,), generator=gen, device="cuda")
    rep = torch.cat([head, head[100:124]])
    return reqs[:4] + [share] + reqs[4:] + [rep]


def engine_phase_dense(model, prompts, oracles, tol):
    """deepseek-7b's engine runs in fp32 (phase 9): the eight requests of
    :func:`engine_requests` (``oracles``: the dense streams of PR 19's
    six) with the prefix cache and speculation on; then four under the
    fault plan ``alloc@2,nan@4.1,exc@6``."""
    import torch
    from repro_torch.serve import faults
    cfg = model.cfg
    t0 = time.perf_counter()
    oracles = oracles[:4] + [dense_oracle(model, prompts[4], 32, tol)] \
        + oracles[4:] + [dense_oracle(model, prompts[7], 32, tol)]
    for o in oracles:
        o.pop("cache", None)
    oracle_s = time.perf_counter() - t0
    want = paged_launches("deepseek-7b", cfg, torch.float32)
    kw = dict(n_slots=4, max_len=1024, page_size=16, prefill_chunk=256,
              prefix_cache=True, speculate_k=3)
    out = {"oracle_s": oracle_s, "main": serve_engine(
        "dense-engine", model, prompts, oracles, want=want, max_new=32,
        **kw)}
    stats = out["main"]["stats"]
    short = [k for k in ("prefix_hits", "cow_copies", "spec_steps",
                         "spec_accepted") if stats[k] < 1]
    calls = out["main"]["calls"]
    if short or not all(calls[k] for k in ("prefill", "chunk", "step",
                                            "verify")):
        raise AssertionError(f"dense-engine: stats {stats}, calls {calls}")
    # the fault plan: the slot poisoned at clock 4 (rid 1, admitted at
    # clock 0 and 8 tokens long: no speculation, so it is still decoding)
    # ends failed, one recovery, the others exact
    sel = [0, 5, 1, 7]          # 97, 64, 333 tokens and the repeated span
    plan = faults.parse_plan("alloc@2,nan@4.1,exc@6")
    res = serve_engine("dense-engine-faults", model,
                       [prompts[i] for i in sel],
                       [oracles[i] for i in sel], want=want, max_new=8,
                       plan=plan, **dict(kw, speculate_k=0))
    failed = [r for r, s in res["statuses"].items() if s == "failed"]
    ok = [r for r, s in res["statuses"].items() if s == "ok"]
    if (failed != [1] or len(ok) != 3 or res["stats"]["recoveries"] != 1
            or res["stats"]["nan_quarantined"] != 1):
        raise AssertionError(f"dense-engine-faults: statuses "
                             f"{res['statuses']}, stats {res['stats']}")
    out["faults"] = res
    out["seconds"] = time.perf_counter() - t0
    return out


def engine_readings(model16, prompts, rep, rates, smi):
    """bf16 deepseek-7b readings through the engine: the B=4 x 512
    prompts with no speculation (decode tokens/s from the host clock
    between consecutive decode steps once every slot decodes), against
    the bare paged decode loop at the same batch and lengths timed in
    turns with it (bare, engine, engine, bare: the gap is the engine's
    host cost a step) and against ``paged_rates``' bare loop (timed
    earlier, before that function's profiler sessions); TTFT and
    inter-token latency p50 / p95 of the completions; then the
    repeated-span request alone with speculation (accepted tokens per
    slot-step)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import paging
    cfg, tree = model16.cfg, model16.params.tree()
    want = paged_launches("deepseek-7b", cfg, torch.bfloat16)
    # 512-token prompts chunk at 256: no attention launch
    kw = dict(n_slots=4, max_len=1024, page_size=16, prefill_chunk=256,
              prefix_cache=True, path=("rowwise_matmul", "layernorm"))
    b, s = prompts.shape
    steps = 8
    # the bare loop's cache: the prompts inserted one-shot into a pool
    with torch.no_grad():
        pool = paging.PagePool(b * 64, 16, b, 64)
        cache = lm.init_paged_cache(cfg, b, 1024, page_size=16,
                                    dtype=torch.bfloat16, device="cuda")
        for r in range(b):
            pool.admit(r, s + steps)
            pool.ensure(r, s + steps)
            _, st = lm.prefill_states(tree, prompts[r:r + 1], cfg,
                                      last_pos=s)
            cache = lm.insert_prefill(cfg, cache, st, slot=r,
                                      pages=pool.tables[r], plen=s,
                                      page_size=16)
    tables = torch.from_numpy(pool.tables).to("cuda")
    lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def bare_ms():
        """ms a step of the bare paged loop (argmax fed back, no read)."""
        tok = prompts[:, -1:]
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                lg, _ = lm.decode_step(tree, cache, tok, lengths + i, cfg,
                                       pages=tables)
                tok = lg.argmax(-1)[:, None]
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    # the model's own share of each step's enqueue: lm.decode_step timed
    # on the host, as the bare loop calls it
    decode_step, model_s = lm.decode_step, []

    def timed_decode_step(*args, **kwargs):
        t = time.perf_counter()
        out = decode_step(*args, **kwargs)
        model_s.append(time.perf_counter() - t)
        return out

    def engine_run():
        lm.decode_step = timed_decode_step
        try:
            return serve_engine("dense-engine-bf16", model16, list(prompts),
                                None, want=want, max_new=steps + 1,
                                sync_check=False, **kw)
        finally:
            lm.decode_step = decode_step
    bare_ms()                                             # warm-up
    bare = [bare_ms()]
    runs = [engine_run(), engine_run()]
    bare.append(bare_ms())
    res = runs[0]
    gaps = [g for r in runs for g in r["step_gaps_s"][-(steps - 1):]]
    gap_ms = 1e3 * float(np.median(gaps))
    # a step's gap: its launches enqueued, its one read's wait, the rest
    enqueue_ms = 1e3 * float(np.median(
        [t for r in runs for t in r["host_s"]["step"]]))
    wait_ms = 1e3 * float(np.median(
        [t for r in runs for t in r["read_s"][-steps:]]))
    model_ms = 1e3 * float(np.median(model_s))
    bare_now = float(np.mean(bare))
    engine_tps = b / gap_ms * 1e3
    bare_tps = b / bare_now * 1e3
    host_ms = gap_ms - bare_now
    early_tps = rates["decode_tokens_per_s"]["paged"]
    spec = serve_engine("dense-engine-bf16-spec", model16, [rep], None,
                        want=want, max_new=32, sync_check=False,
                        speculate_k=3, **kw)
    st = spec["stats"]
    acc = st["spec_accepted"] / max(st["spec_slot_steps"], 1)
    q = {k: [float(np.percentile([x for r in runs for x in r[k]], p)) * 1e3
             for p in (50, 95)] for k in ("ttft_s", "itl_s")}
    out = {"engine_decode_tokens_per_s": engine_tps,
           "bare_paged_decode_tokens_per_s": bare_tps,
           "bare_step_ms_in_turns": bare,
           "paged_rates_decode_tokens_per_s": early_tps,
           "host_ms_per_step": host_ms, "step_gap_ms": gap_ms,
           "step_enqueue_ms": enqueue_ms, "step_read_wait_ms": wait_ms,
           "step_decode_step_ms": model_ms,
           "ttft_ms_p50_p95": q["ttft_s"],
           "itl_ms_p50_p95": q["itl_s"],
           "accepted_per_slot_step": acc, "spec_stats": st,
           "runs": {"decode": res, "spec": spec}}
    say("throughput", f"deepseek-7b bf16 engine decode tokens/s at B=4 "
        f"after 512 tokens {engine_tps:.2f} (median of {len(gaps)} step "
        f"gaps over two runs, host clock) against the bare paged loop's "
        f"{bare_tps:.2f} (timed in turns: bare, engine, engine, bare; "
        f"{bare[0]:.2f} / {bare[1]:.2f} ms a step) and paged_rates' "
        f"{early_tps:.2f} (before its profiler sessions): the engine's host "
        f"cost {host_ms:.2f} ms a step (a step gap of {gap_ms:.2f} ms: "
        f"{enqueue_ms:.2f} ms enqueuing its launches, {model_ms:.2f} ms of "
        f"them in lm.decode_step, {wait_ms:.2f} ms waiting on its read, "
        f"the rest the host's bookkeeping); TTFT p50 / p95 "
        f"{q['ttft_s'][0]:.1f} / {q['ttft_s'][1]:.1f} ms, inter-token "
        f"{q['itl_s'][0]:.1f} / {q['itl_s'][1]:.1f} ms (4 requests of 512 "
        f"submitted at once, chunked at 256); the repeated-span request "
        f"with speculation k=3: {acc:.3f} accepted tokens a slot-step "
        f"({st['spec_accepted']} of {st['spec_drafted']} drafted in "
        f"{st['spec_steps']} verify steps) | {smi}")
    return out


def engine_phase_gemma(phase, model, reqs, oracles, want):
    """gemma3-27b's engine run (phase 10): the 1500-token prompt chunked
    at 512 across the 1024 window and the 300-token one, 17 tokens each,
    on 2 slots; ``prefix_cache=True`` must leave no prefix cache (a
    windowed arch opts out)."""
    for o in oracles:
        o.pop("cache", None)
    res = serve_engine(phase, model, reqs, oracles, want=want, max_new=17,
                       n_slots=2, max_len=2048, page_size=16,
                       prefill_chunk=512, prefix_cache=True, speculate_k=3)
    if res["prefix_cache"]:
        raise AssertionError(f"{phase}: a windowed arch kept the prefix "
                             "cache")
    return res


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
            "layernorm": 2 * layers + 1, "wkv": 0, "ssd": 0}
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
    # the ABBA readings of SKINNY_NORM_MAX_K (the boundary's, its
    # numbers in PERF.md) cut for the script's time with the training
    # mesh; ``skinny_norm_ab`` takes them by hand
    say("cut", "deepseek-7b's skinny norm prologue ABBA readings: a "
               "reading of an earlier path, cut for the script's time")
    # paged serving: six requests on four slots in fp32 (the checks),
    # then the bf16 readings
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 333, 512, 700, 64, 900)]
    paged = PagedServing(
        "dense-paged", model, reqs, chunked={3, 5}, slots=4, page_size=16,
        max_len=1024, chunk=256, n_new=32, tol=LOGIT_TOL,
        want=paged_launches("deepseek-7b", cfg, torch.float32),
        accept=(3, 2, 1, 0), cow=True)
    out["paged_fp32"] = paged.run()
    # the serving engine on the same requests and more, the paged
    # replay's dense streams reused
    ereqs = engine_requests(reqs, gen, cfg.vocab)
    oracles = paged.oracle
    del paged
    out["engine_fp32"] = engine_phase_dense(model, ereqs, oracles,
                                            LOGIT_TOL)
    del oracles
    out["paged_bf16"] = paged_rates("bf16", model16, prompts, reqs[5],
                                    chunk=256, max_len=1024, page_size=16,
                                    smi=smi)
    out["engine_bf16"] = engine_readings(model16, prompts, ereqs[7],
                                         out["paged_bf16"], smi)
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


def lm_counts(cfg, rows, dtype, *, attention):
    """Launches of a fused prefill (``attention`` True) or decode step of
    ``rows`` rows, block by block over the config's stages (a shared
    block once a repeat): an attention mixer's qkv and wo and one
    attention at prefill, an MLP's two matmuls, the norms of the qkv and
    MLP panels where their prologue splits; a Mamba2 mixer's in_proj and
    out_proj and its two standalone norms (norm1, the gated RMS norm);
    an MoE FFN's standalone norm2 (its router and experts launch no
    kernel); an RWKV6 time-mix's seven matmuls (wr, wk, wv, wg, the
    decay LoRA's two, wo), its two standalone norms (norm1, its ln) and
    the recurrence, and the channel-mix's three matmuls and norm2; a
    Mamba2 mixer's SSD scan (two launches, prefill and step alike); then
    the head and the final norm."""
    from repro_torch.kernels.ssd import LAUNCHES as SSD_LAUNCHES
    mm = attn = norms = wkv = ssd = 0
    for stage in cfg.stages():
        for blk in stage.body:
            r = stage.repeat
            if blk.mixer == "attn":
                mm += 2 * r
                attn += r if attention else 0
                norms += prologue_splits(rows, cfg.d_model, dtype, r)
            elif blk.mixer == "mamba2":
                mm += 2 * r
                norms += 2 * r
                ssd += len(SSD_LAUNCHES) * r
            elif blk.mixer == "rwkv6":
                mm += 7 * r
                norms += 2 * r
                wkv += r
            if blk.ffn == "mlp":
                mm += 2 * r
                norms += prologue_splits(rows, cfg.d_model, dtype, r)
            elif blk.ffn in ("moe", "rwkv6_cmix"):
                mm += 3 * r if blk.ffn == "rwkv6_cmix" else 0
                norms += r
    return {"rowwise_matmul": mm + 1, "flash_attention": attn,
            "layernorm": norms + 1, "wkv": wkv, "ssd": ssd}


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
    fp32 model freed and ``GEMMA_BF16_LAYERS`` layers in bf16, layer by
    layer against fp32 beside the float8 control, its logits as
    readings; prefill and decode
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
            "layernorm": 2 * cfg.n_layers + 1, "wkv": 0, "ssd": 0}
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
    served = PagedServing(
        "gemma-paged-fp32", model, reqs, tol=LOGIT_TOL,
        want=paged_launches("gemma3-27b/8", cfg, f32), **paged)
    out["paged_fp32_8_layers"] = served.run()
    oracles = served.oracle
    del served
    out["engine_fp32_8_layers"] = engine_phase_gemma(
        "gemma-engine-fp32", model, reqs, oracles,
        paged_launches("gemma3-27b/8", cfg, f32))
    del model, oracles
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    deep = dataclasses.replace(full, n_layers=GEMMA_BF16_LAYERS)
    model16 = lm.LanguageModel(
        deep, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_norms(model16.params.tree(),
                     torch.Generator(device="cuda").manual_seed(1))
    out["params_bf16"] = sum(p.numel() for p in model16.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model16.parameters()) / 2 ** 30
    say("gemma", f"{full.name}: {deep.n_layers} of {full.n_layers} layers, "
                 f"{out['params_bf16'] / 1e9:.3f} B parameters, bf16, "
                 f"{gib:.2f} GiB of weights, built in "
                 f"{time.perf_counter() - t0:.1f} s")
    bf = torch.bfloat16
    out["bf16_b2"] = check_serving(
        "gemma-bf16", model16, prompts, 8, None,
        want_launches("gemma3-27b/20 prefill",
                      lm_counts(deep, 2 * 2048, bf, attention=True)),
        state=gemma_state,
        want_decode=want_launches("gemma3-27b/20 step", lm_counts(
            deep, 2, bf, attention=False)))
    out["bf16_layers"] = bf16_layers("gemma-bf16", model16, prompts)
    torch.cuda.reset_peak_memory_stats()
    rates["bf16"] = lm_rates(model16, prompts)
    out["peak_memory_bf16_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_pipeline_fusion(False):
        rates["bf16_unfused"] = lm_rates(model16, prompts)
    with runtime.use_impl("ref"):
        rates["plain_bf16"] = lm_rates(model16, prompts)
    say("cut", "gemma3-27b's skinny norm prologue ABBA readings: a "
               "reading of an earlier path, cut for the script's time")
    served = PagedServing(
        "gemma-paged-bf16", model16, reqs, tol=BF16_TOL,
        want=paged_launches("gemma3-27b/20", deep, bf), **paged)
    out["paged_bf16"] = served.run()
    oracles = served.oracle
    del served
    out["engine_bf16"] = engine_phase_gemma(
        "gemma-engine-bf16", model16, reqs, oracles,
        paged_launches("gemma3-27b/20", deep, bf))
    del oracles
    out["paged_rates_bf16"] = paged_rates(
        "bf16, 20 layers", model16, prompts[:, :1024], reqs[0], chunk=512,
        max_len=2048, page_size=16, smi=smi)
    out["tied_head_bf16"] = tied_head_copy(model16, "bf16")
    out.update(rates=rates, seconds=time.perf_counter() - t_phase)
    say("throughput", "gemma3-27b prefill tokens/s at B=2 x 2048: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=2: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {out['peak_memory_fp32_gib']:.2f} GiB (fp32, 8 "
        f"layers), {out['peak_memory_bf16_gib']:.2f} GiB (bf16, 20 layers) "
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
              "wkv": 0, "ssd": 0}
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
        "wkv": 0, "ssd": 0})
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
            "layernorm": 2 * enc + 3 * dec + 2, "wkv": 0, "ssd": 0}
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


# ------------------------------ zamba2-1.2b -----------------------------


def jitter_hybrid(tree, gen):
    """Spread the constant leaves of a hybrid tree: every norm gain by
    0.1; each Mamba2 mixer's ``A_log`` uniform over [0, log 16] and
    ``dt_bias`` at softplus^-1 of a dt log-uniform over [1e-3, 0.1]
    (Mamba2's own init ranges), its ``D``, conv bias and gated-norm gain
    by 0.1."""
    import math

    import torch

    def rand(t):
        return torch.rand(t.shape, generator=gen, device=gen.device).to(t)

    def spread(t):
        t.add_(_rand(gen, t.shape, t.dtype, t.device, 0.1))

    for stage in tree["stages"]:
        for blk in [*stage["stacked"].values(), *stage["shared"].values()]:
            for norm in ("norm1", "norm2"):
                for t in blk.get(norm, {}).values():
                    spread(t)
            m = blk.get("mamba")
            if m is None:
                continue
            m["A_log"].copy_(rand(m["A_log"]) * math.log(16))
            dt = torch.exp(math.log(1e-3) + rand(m["dt_bias"])
                           * math.log(100))
            m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
            for k in ("D", "conv_b", "norm_g"):
                spread(m[k])
    for t in tree["final_norm"].values():
        spread(t)


def hybrid_state(cache):
    """The state of a zamba2 cache: the first Mamba2 layer's conv and
    SSM state, the shared block's K and V (every repeat) and the tail
    stage's first Mamba2 layer's."""
    kv = next(c["kv"] for c in cache[0].values() if "kv" in c)
    return [*cache[0]["0"]["mamba"], *kv, *cache[-1]["0"]["mamba"]]


def exact_engine(phase, model, prompts, tol, dtype, *, max_new,
                 n_slots=4, max_len=512):
    """An engine run at exact lengths (an arch with recurrent or MoE
    state: no buckets, chunks, prefix cache or speculation) on
    ``n_slots`` slots, every stream held to its dense stream
    (``dense_oracle`` with ``tol``, the near-tie rule), every admission
    and step launching as the model's prefill and step
    (``LAUNCHES["<arch> prefill" / "<arch> step"]``, the model running
    in ``dtype``), each kernel of that path launched in the run."""
    cfg = model.cfg
    t0 = time.perf_counter()
    oracles = [dense_oracle(model, p, max_new, tol) for p in prompts]
    for o in oracles:
        o.pop("cache")
    oracle_s = time.perf_counter() - t0
    key = LAUNCH_KEYS.get(cfg.name, cfg.name)
    path = tuple(k for k, v in lm_counts(cfg, 1, dtype,
                                         attention=True).items() if v)
    res = serve_engine(phase, model, prompts, oracles,
                       want=paged_launches(key, cfg, dtype),
                       max_new=max_new, path=path, n_slots=n_slots,
                       max_len=max_len, page_size=16)
    res["oracle_s"] = oracle_s
    return res


# the LAUNCHES key of each cut config's name
LAUNCH_KEYS = {"phi3.5-moe-42b-a6.6b": "phi3.5-moe/8"}


def int8_tree_check(model, prompts):
    """The weight-only int8 tree of ``model`` (``quant.quantize_tree``
    with ``lm_weight_predicate``: zamba2's tied embedding and head and
    its shared block's projections) under the config with its dtype set
    to fp32, so the int8 leaves dequantize to fp32 and the model runs in
    fp32: each prompt's first-token logits through ``lm.forward`` on the
    kernels and through the engine (captured at admission), against
    ``lm.forward`` on the plain path, within LOGIT_TOL x max(1,
    max|logit|); the engine's streams held to the int8 tree's dense
    streams."""
    import torch
    from repro_torch.core import quant, runtime
    from repro_torch.models import lm
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    qtree = quant.quantize_tree(model.params.tree(),
                                quant.lm_weight_predicate)
    n_int8 = sum(t.numel() for t in torch.utils._pytree.tree_leaves(qtree)
                 if t.dtype == torch.int8)
    qmodel = lm.LanguageModel(cfg, qtree, device="cuda")
    vocab, want, forward_errs = cfg.vocab, [], []
    with torch.no_grad():
        for p in prompts:
            got = lm.forward(qtree, p[None], cfg)[0][0, -1, :vocab]
            with runtime.use_impl("ref"):
                want.append(lm.forward(qtree, p[None], cfg)[0][0, -1,
                                                               :vocab])
            err, ok = err_ok(got, want[-1], LOGIT_TOL)
            forward_errs.append(err)
            if not ok:
                raise AssertionError(f"zamba2-int8: lm.forward's first-token "
                                     f"logits off by {err}")
    captured, orig = [], lm.prefill_states

    def capture(*args, **kw):
        logits, states = orig(*args, **kw)
        captured.append(logits[0, :vocab].clone())
        return logits, states
    lm.prefill_states = capture
    try:
        res = exact_engine("zamba2-int8-engine", qmodel, prompts, LOGIT_TOL,
                           torch.float32, max_new=8, n_slots=2)
    finally:
        lm.prefill_states = orig
    # the dense oracles' prefills come first, then the engine's admissions
    engine = captured[len(prompts):]
    engine_errs = [err_ok(c, w, LOGIT_TOL) for c, w in zip(engine, want)]
    say("zamba2-int8", f"weight-only int8 tree ({n_int8 / 1e6:.1f} M int8 "
        f"weights, the rest fp32), fp32 first-token logits against the "
        f"plain path: lm.forward max_abs_err "
        f"{[round(e, 7) for e in forward_errs]}, the engine's "
        f"{[round(e, 7) for e, _ in engine_errs]}; tol {LOGIT_TOL}*max(1,"
        "max|logit|)")
    if len(engine) != len(prompts) or not all(ok for _, ok in engine_errs):
        raise AssertionError(f"zamba2-int8: the engine's first-token logits "
                             f"{engine_errs}")
    return {"int8_weights": n_int8, "forward_errs": forward_errs,
            "engine_errs": [e for e, _ in engine_errs], "engine": res}


def lm_profile(arch, batch, seq, dtypes, layers=0):
    """``launch/profile.py``'s LM profile (a prefill and a decode step per
    dtype: wall, device busy time, idle share, device ms by kernel), for
    :func:`readings_apart`."""
    import argparse

    import torch
    from repro_torch.launch import profile
    args = argparse.Namespace(model=arch, layers=layers, seq=seq,
                              dtype=list(dtypes), batch=[batch],
                              impl=["auto"], unfused=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    return profile.profile_lm(args, "cuda", torch.cuda.get_device_name(0))


# the SSD scan's calls on the main path: granite-4.0-h-small's prefill at
# B=8 (the benchmark mix's least, mean and longest lengths) and
# zamba2-1.2b's at B=4 x 512
SSD_SHAPES = {"granite-4.0-h-small": (8, (407, 1872, 5526)),
              "zamba2-1.2b": (4, (512,))}
# the kernel against the plain version (both fp32, other orders of the
# sums, every decay factor at most 1), as max|diff| / max(1, max|plain|)
SSD_TOL = 1e-4


def ssd_readings(smi):
    """The SSD scan (``ssd_p``: its two launches a call) at the main
    path's shapes, on inputs in the mixer's ranges (x, B, C the conv's
    silu output, dt log-uniform over [1e-3, 0.1], A_log uniform over [0,
    log 16]: Mamba2's own init): ms a call (CUDA events), the bound (the
    launch records' operations at the fp32 FFMA peak; the call's operands
    and outputs once), the plain version's ms, and y's and the state's
    error against the plain version."""
    import math

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.launch import roofline
    from repro_torch.models import mamba2

    out = {}
    for arch, (b, lengths) in SSD_SHAPES.items():
        cfg = get_config(arch)
        sc, d_in, h, _ = mamba2._dims(cfg)
        p, n = sc.head_dim, sc.d_state
        for s in lengths:
            gen = torch.Generator(device="cuda").manual_seed(s)
            conv = F.silu(_rand(gen, (b, s, d_in + 2 * n), torch.float32,
                                "cuda"))
            xh = conv[..., :d_in].view(b, s, h, p)
            B, C = conv[..., d_in:d_in + n], conv[..., d_in + n:]
            u = torch.rand((b, s, h), generator=gen, device="cuda")
            dt = torch.exp(math.log(1e-3) + u * math.log(100))
            a = -torch.exp(torch.rand(h, generator=gen, device="cuda")
                           * math.log(16))
            D = _rand(gen, (h,), torch.float32, "cuda")
            args = (xh, dt, a, B, C, D)

            def run():
                return ssd.ssd_p(*args, chunk=sc.chunk)

            def plain():
                return ssd.ssd_plain(*args, chunk=sc.chunk)
            with roofline.recording() as recs:
                y, st = run()
            yp, sp = plain()
            (ey, oky), (es, oks) = err_ok(y, yp, SSD_TOL), err_ok(st, sp,
                                                                 SSD_TOL)
            flops = sum(roofline.price(r)[0] for r in recs)
            bound_ms, by = bound(flops, nbytes(xh, dt, a, B, C, D, y, st),
                                 "fp32")
            ms, plain_ms = cuda_time(run), cuda_time(plain)
            name = f"{arch} B={b} x {s}"
            out[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                         "plain_ms": plain_ms, "flops": flops,
                         "err_y": ey, "err_state": es}
            say("ssd", f"{name} (H {h}, P {p}, N {n}, chunk {sc.chunk}): "
                       f"kernel {ms:.4f} ms a call ({len(recs)} launches), "
                       f"bound {bound_ms:.4f} ms ({by}, {flops / 1e9:.2f} "
                       f"GFLOP; {bound_ms / ms:.1%} of it), plain "
                       f"{plain_ms:.4f} ms; max_abs_err y {ey:.3g}, state "
                       f"{es:.3g} (tol {SSD_TOL}*max(1,max|plain|)) | {smi}")
            if not (oky and oks):
                raise AssertionError(f"ssd {name}: y {ey}, state {es}")
            del conv, xh, B, C, dt, y, st, yp, sp, args
            torch.cuda.empty_cache()
    return out


def zamba2_phase(smi):
    """zamba2-1.2b at full width and depth (38 layers: 32 Mamba2 and 6
    repeats of the shared block): serving checks in fp32 and bf16, the
    engine at exact lengths, the weight-only int8 tree, rates; then the
    SSD scan's line (:func:`ssd_readings`)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-1.2b")
    f32, bf = torch.float32, torch.bfloat16
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=f32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_hybrid(model.params.tree(),
                      torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    say("zamba2", f"{cfg.name}: {cfg.n_layers} layers "
                  f"({[(st.repeat, len(st.body)) for st in cfg.stages()]} "
                  f"repeats x body), d {cfg.d_model}, SSD {cfg.ssm}, shared "
                  f"block {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
                  f"{cfg.d_ff} (GELU), vocab {cfg.vocab} (tied): "
                  f"{n_params / 1e9:.3f} B parameters (param_counts says "
                  f"{cfg.param_counts()['total'] / 1e9:.3f} B), fp32, built "
                  f"in {time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                            device="cuda")
    prompt1 = torch.randint(0, cfg.vocab, (1, 333), generator=gen,
                            device="cuda")

    def held(dtype, b, s):
        return dict(want_counts=want_launches("zamba2-1.2b prefill", lm_counts(
            cfg, b * s, dtype, attention=True)),
            want_decode=want_launches("zamba2-1.2b step", lm_counts(
                cfg, b, dtype, attention=False)), state=hybrid_state)
    out = {"params": n_params}
    for key, p, steps in (("fp32_b4", prompts, 32), ("fp32_b1", prompt1, 8)):
        out[key] = check_serving("zamba2-fp32", model, p, steps, LOGIT_TOL,
                                 **held(f32, *p.shape))
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 333, 64, 200)]
    out["engine_fp32"] = exact_engine("zamba2-engine", model, reqs,
                                      LOGIT_TOL, f32, max_new=16)
    out["int8"] = int8_tree_check(model, reqs[:2])
    model16 = lm.LanguageModel(cfg, to_bf16(model.params.tree()),
                               device="cuda")
    out["bf16_b4"] = check_serving("zamba2-bf16", model16, prompts, 8, None,
                                   **held(bf, 4, 512))
    out["bf16_layers"] = bf16_layers("zamba2-bf16", model16, prompts)
    with torch.no_grad(), runtime.use_impl("ref"):
        out["bf16_rounding"] = err_ok(model16.prefill(prompts)[0],
                                      model.prefill(prompts)[0], BF16_TOL)[0]
    say("zamba2-bf16", "plain bf16 against plain fp32 (same weights "
                       f"rounded), prefill logits: max_abs_err="
                       f"{out['bf16_rounding']:.4g}")
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32": lm_rates(model, prompts),
             "bf16": lm_rates(model16, prompts)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_impl("ref"):
        rates["plain_fp32"] = lm_rates(model, prompts)
    out["ssd"] = ssd_readings(smi)
    out.update(rates=rates, peak_memory_gib=peak_gb,
               seconds=time.perf_counter() - t_phase)
    say("throughput", "zamba2-1.2b prefill tokens/s at B=4 x 512: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=4: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {peak_gb:.2f} GiB (kernels, fp32 and bf16 models "
        f"resident) | {smi}")
    say("zamba2", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------ MoE -------------------------------------


# the largest top-k margin a bf16 routing flip may have: the fp32
# router's logit gap between a token's k-th and (k+1)-th expert, for a
# token the kernel path routes to other experts than the fp32 layer
# (PERF.md §6, written before the first run that held it)
MOE_FLIP_MARGIN = 0.1
# phi3.5-moe's depth here: 41.9 B parameters at 32 layers do not fit the
# card in bf16 (84 GB), 8 layers (10.7 B) do in fp32
PHI_LAYERS = 8


def moe_layers(phase, model, prompts):
    """Each layer of an MoE model at prefill, run on the plain path's
    input to it (as :func:`bf16_layers`), against the same layer in fp32
    on the same weights and input, token by token. The routing of the
    kernel path (its top-k experts, and which of them kept the token
    within capacity) is recorded beside the fp32 layer's: a token routed
    to other experts is a flip, allowed in a bf16 model only where its
    margin (the fp32 router's logit gap between its k-th and (k+1)-th
    expert) is below MOE_FLIP_MARGIN, and never in an fp32 model; a
    token routed alike but kept by other experts (a flip before it took
    their capacity) is a capacity move. rms(err) / rms(out) of each
    layer over the other tokens is held to BF16_LAYER_TOL (bf16) or
    FP32_TOL (fp32), beside the plain path's reading and, in bf16, the
    float8 control's."""
    import torch
    from repro_torch.core import runtime
    from repro_torch.models import blocks, lm, moe
    cfg, tree = model.cfg, model.params.tree()
    bf16 = tree["embed"].dtype == torch.bfloat16
    limit = BF16_LAYER_TOL if bf16 else FP32_TOL
    k = cfg.moe.top_k
    rec = []
    route, dispatch = moe._route, moe._dispatch_indices

    def rroute(*args):
        out = route(*args)
        rec.append({"idx": out[1], "probs": out[2]})
        return out

    def rdispatch(gate_idx, *args):
        out = dispatch(gate_idx, *args)
        rec[-1]["keep"] = out[1].reshape(gate_idx.shape)
        return out

    def kept(r):
        """(T, E) experts that took each token, and (T, E) routed."""
        e = r["probs"].shape[-1]
        hot = moe._one_hot(r["idx"], e, torch.bool)
        return (hot & r["keep"][..., None]).any(1), hot.any(1)

    reads = {"kernels": [], "plain": [], "control": []}
    flips, moves, plain_flips = [], 0, 0
    moe._route, moe._dispatch_indices = rroute, rdispatch
    try:
        with torch.no_grad():
            x = lm.embed(tree, prompts, cfg)
            positions = lm._positions(cfg, prompts)
            stage, sp = cfg.stages()[0], tree["stages"][0]
            blk = stage.body[0]
            for rep in range(stage.repeat):
                bp = lm._tree_map(lambda a, r=rep: a[r], sp["stacked"]["0"])

                def run(params, inp):
                    return blocks.apply_block(blk, params, inp, cfg=cfg,
                                              mode="prefill",
                                              positions=positions)[0]
                rec.clear()
                got = run(bp, x)
                with runtime.use_impl("ref"):
                    plain = run(bp, x)
                    want = run(lm._tree_map(lambda a: a.float(), bp),
                               x.float())
                r_got, r_plain, r_want = rec
                want_kept, want_routed = kept(r_want)

                def moved(r):
                    """Tokens routed (flip) or kept (move) otherwise than
                    by the fp32 layer."""
                    got_kept, got_routed = kept(r)
                    flip = (got_routed != want_routed).any(-1)
                    return flip, (got_kept != want_kept).any(-1) & ~flip
                flip, move = moved(r_got)
                plain_flip, plain_move = moved(r_plain)
                plain_flips += int(plain_flip.sum())
                top = r_want["probs"].sort(-1, descending=True).values
                gap = (top[:, k - 1].log() - top[:, k].log())[flip]
                flips += [(rep, g) for g in gap.tolist()]
                moves += int(move.sum())
                # each way over the tokens it routed and kept as fp32 did
                ways = {"kernels": (got, flip | move),
                        "plain": (plain, plain_flip | plain_move)}
                if bf16:
                    ways["control"] = (plain.to(torch.float8_e5m2),
                                       plain_flip | plain_move)
                for way, (o, off) in ways.items():
                    rows = ~off.reshape(x.shape[:2])
                    d = (o.float() - want)[rows]
                    if not torch.isfinite(d).all():
                        raise AssertionError(f"{phase} layer {rep}: {way} "
                                             "output not finite")
                    reads[way].append((d.square().mean().sqrt()
                                       / want[rows].square().mean().sqrt())
                                      .item())
                x = plain
    finally:
        moe._route, moe._dispatch_indices = route, dispatch
    tokens = prompts.numel() * stage.repeat
    worst = max((g for _, g in flips), default=0.0)
    out = {"kernels_max": max(reads["kernels"]),
           "plain_max": max(reads["plain"]),
           "control_min": min(reads["control"], default=None),
           "flips": flips, "capacity_moves": moves,
           "plain_flips": plain_flips, "tokens": tokens,
           "per_layer": reads}
    say(phase, f"each layer on the plain input, against the same layer in "
        f"fp32: {len(flips)} of {tokens} token-layers routed to other "
        f"experts on the kernel path (margins "
        f"{sorted(round(g, 5) for _, g in flips)[-8:]} largest; limit "
        f"{MOE_FLIP_MARGIN if bf16 else 0}), the plain path {plain_flips}; "
        f"{moves} capacity moves; rms(err)/rms(out) over the rest: kernels "
        f"max {out['kernels_max']:.4g}, plain max {out['plain_max']:.4g}"
        + (f", control (float8_e5m2) min {out['control_min']:.4g}"
           if bf16 else "") + f"; tol {limit}")
    if flips and (not bf16 or worst >= MOE_FLIP_MARGIN):
        raise AssertionError(f"{phase}: routing flips {flips}")
    if out["kernels_max"] > limit:
        raise AssertionError(f"{phase} layers: kernel path reads "
                             f"{out['kernels_max']}")
    if bf16 and out["control_min"] <= limit:
        raise AssertionError(f"{phase} layers: the control passes the "
                             "limit")
    return out


def moe_phase(smi, arch, n_layers=0):
    """An MoE LM at full width (``n_layers``: its depth cut, else full):
    fp32 serving checks and the layers' routing, the fp32 model freed,
    then the same weights in bf16 built anew (the two trees together
    would not fit the card): serving readings at full depth, the layers
    held one by one (:func:`moe_layers`), the engine at exact lengths
    (qwen2-moe), rates."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm, moe

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    key = LAUNCH_KEYS.get(arch, arch)
    tag = arch.split("-")[0]
    f32, bf = torch.float32, torch.bfloat16

    def build(dtype):
        model = lm.LanguageModel(
            cfg, device="cuda", dtype=dtype,
            generator=torch.Generator(device="cuda").manual_seed(0))
        with torch.no_grad():
            jitter_norms(model.params.tree(),
                         torch.Generator(device="cuda").manual_seed(1))
        return model

    def held(dtype, b, s):
        return dict(want_counts=want_launches(f"{key} prefill", lm_counts(
            cfg, b * s, dtype, attention=True)),
            want_decode=want_launches(f"{key} step", lm_counts(
                cfg, b, dtype, attention=False)), state=kv_state)
    model = build(f32)
    n_params = sum(p.numel() for p in model.parameters())
    mo = cfg.moe
    say(tag, f"{cfg.name}: {cfg.n_layers} of {full.n_layers} layers, d "
             f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} "
             f"({cfg.n_kv_heads} kv), {mo.n_experts} experts (padded to "
             f"{moe.padded_experts(cfg)}) top-{mo.top_k} of d_ff {mo.d_ff}, "
             f"{mo.n_shared} shared, {cfg.norm} norm, vocab {cfg.vocab}: "
             f"{n_params / 1e9:.3f} B parameters, fp32, built in "
             f"{time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (4, 256), generator=gen,
                            device="cuda")
    prompt1 = torch.randint(0, cfg.vocab, (1, 97), generator=gen,
                            device="cuda")
    out = {"params": n_params, "layers": cfg.n_layers}
    for k, p, steps in (("fp32_b4", prompts, 16), ("fp32_b1", prompt1, 8)):
        out[k] = check_serving(f"{tag}-fp32", model, p, steps, LOGIT_TOL,
                               **held(f32, *p.shape))
    out["fp32_layers"] = moe_layers(f"{tag}-fp32", model, prompts)
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32": lm_rates(model, prompts)}
    peak = {"fp32": torch.cuda.max_memory_allocated() / 2 ** 30}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model16 = build(bf)
    out["bf16_b4"] = check_serving(f"{tag}-bf16", model16, prompts, 8, None,
                                   **held(bf, 4, 256))
    out["bf16_layers"] = moe_layers(f"{tag}-bf16", model16, prompts)
    if arch == "qwen2-moe-a2.7b":
        reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                              device="cuda") for n in (97, 256, 64, 200)]
        out["engine_bf16"] = exact_engine(f"{tag}-engine", model16, reqs,
                                          BF16_TOL, bf, max_new=8)
    torch.cuda.reset_peak_memory_stats()
    rates["bf16"] = lm_rates(model16, prompts)
    peak["bf16"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_impl("ref"):
        rates["plain_bf16"] = lm_rates(model16, prompts)
    del model16
    gc.collect()
    torch.cuda.empty_cache()
    out.update(rates=rates, peak_memory_gib=peak,
               seconds=time.perf_counter() - t_phase)
    say("throughput", f"{cfg.name} ({cfg.n_layers} layers) prefill tokens/s "
        "at B=4 x 256: " + ", ".join(f"{k} {v[0]:.1f}"
                                     for k, v in rates.items())
        + "; decode tokens/s at B=4: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + "; peak memory " + ", ".join(f"{k} {v:.2f} GiB"
                                       for k, v in peak.items())
        + f" (one model resident) | {smi}")
    say(tag, f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------ qwen2-vl-2b ------------------------------


def vl_inputs(cfg, gen, b, s, n_patches):
    """A vision batch of ``b`` rows of ``s`` tokens: ``n_patches`` patch
    embeddings (the table's scale, 0.02) over the first rows, on a (t=0,
    h, w) grid 8 wide, and every text row at t = h = w = its index."""
    import torch
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    ve = _rand(gen, (b, n_patches, cfg.d_model), torch.float32, "cuda", 0.02)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    p3 = torch.stack([pos, pos, pos])[:, None].expand(3, b, s).clone()
    patch = torch.arange(n_patches, dtype=torch.int32, device="cuda")
    p3[0, :, :n_patches] = 0
    p3[1, :, :n_patches] = patch // 16
    p3[2, :, :n_patches] = patch % 16
    return tokens, {"vis_embeds": ve, "positions3": p3}


def vl_phase(smi):
    """qwen2-vl-2b at full width and depth (28 layers, 1.544 B
    parameters): 4 prompts of 512 tokens with 128 patch embeddings on an
    8 x 16 (t=0, h, w) grid then 32 greedy steps, and 1 text prompt of
    333 then 8, fp32 teacher-forced against the plain path (logits,
    picks, the KV cache), 113 / 28 / 57 / 0 launches a prefill and
    113 / 0 / 57 / 0 a step; bf16 layer by layer against fp32 beside the
    float8 control and at full depth as readings; the engine at exact
    lengths (text only, as JAX's engine serves a vision arch) in fp32;
    prefill and decode rates."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.models import lm, rope

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-vl-2b")
    f32, bf = torch.float32, torch.bfloat16
    model = lm.LanguageModel(
        cfg, device="cuda", dtype=f32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        jitter_norms(model.params.tree(),
                     torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    say("qwen2-vl", f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
                    f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV "
                    f"heads of {cfg.head_dim} (M-RoPE sections "
                    f"{rope.mrope_sections(cfg.head_dim)}), "
                    f"d_ff {cfg.d_ff} (SwiGLU), vocab {cfg.vocab} padded "
                    f"to {lm.padded_vocab(cfg)} (tied): {n_params / 1e9:.4f}"
                    f" B parameters (param_counts says "
                    f"{cfg.param_counts()['total']:,}), fp32, built in "
                    f"{time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts, extra = vl_inputs(cfg, gen, 4, 512, 128)
    prompt1 = torch.randint(0, cfg.vocab, (1, 333), generator=gen,
                            device="cuda")

    def held(dtype, b, s):
        return dict(want_counts=want_launches("qwen2-vl-2b prefill", lm_counts(
            cfg, b * s, dtype, attention=True)),
            want_decode=want_launches("qwen2-vl-2b step", lm_counts(
                cfg, b, dtype, attention=False)), state=kv_state)
    out = {"params": n_params}
    out["fp32_b4"] = check_serving("qwen2-vl-fp32", model, prompts, 32,
                                   LOGIT_TOL, extra=extra,
                                   **held(f32, 4, 512))
    out["fp32_b1"] = check_serving("qwen2-vl-fp32", model, prompt1, 8,
                                   LOGIT_TOL, **held(f32, 1, 333))
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 333, 64, 200)]
    out["engine_fp32"] = exact_engine("qwen2-vl-engine", model, reqs,
                                      LOGIT_TOL, f32, max_new=16)
    model16 = lm.LanguageModel(cfg, to_bf16(model.params.tree()),
                               device="cuda")
    out["bf16_b4"] = check_serving("qwen2-vl-bf16", model16, prompts, 8,
                                   None, extra=extra, **held(bf, 4, 512))
    out["bf16_layers"] = bf16_layers("qwen2-vl-bf16", model16, prompts,
                                     extra=extra)
    torch.cuda.reset_peak_memory_stats()
    rates = {"fp32": lm_rates(model, prompts, extra=extra),
             "bf16": lm_rates(model16, prompts, extra=extra)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with runtime.use_impl("ref"):
        rates["plain_fp32"] = lm_rates(model, prompts, extra=extra)
    out.update(rates=rates, peak_memory_gib=peak_gb,
               seconds=time.perf_counter() - t_phase)
    say("throughput", "qwen2-vl-2b prefill tokens/s at B=4 x 512 (128 "
        "patch rows a prompt): " + ", ".join(
            f"{k} {v[0]:.1f}" for k, v in rates.items())
        + "; decode tokens/s at B=4: " + ", ".join(
            f"{k} {v[1]:.2f}" for k, v in rates.items())
        + f"; peak memory {peak_gb:.2f} GiB (kernels, fp32 and bf16 models "
        f"resident) | {smi}")
    say("qwen2-vl", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------ gradients of the kernels -----------------------


def grad_cases(dtype, gen):
    """(name, the op, its inputs, the kernel launches one forward makes,
    the plain path's op or None for the same) at qwen2-vl-2b's shapes
    (M = 4 x 512 rows of K = 1536) and RWKV6-3B's WKV (B=4 x 512, 40
    heads of 64; its plain version takes fp32, as the model gives it,
    so the plain path runs on the inputs upcast)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    cfg = get_config("qwen2-vl-2b")
    m, d, f, hd = 4 * 512, cfg.d_model, cfg.d_ff, cfg.head_dim
    qkv = sum(attention.proj_splits(cfg))

    def leaf(*shape, scale=1.0):
        return _rand(gen, shape, dtype, "cuda", scale).requires_grad_(True)
    x, res = leaf(m, d), leaf(m, d)
    w, b, g, be = leaf(d, qkv, scale=d ** -0.5), leaf(qkv, scale=0.1), \
        (1 + _rand(gen, (d,), dtype, "cuda", 0.1)).requires_grad_(True), \
        leaf(d, scale=0.1)
    wgi, bgi = leaf(d, 2 * f, scale=d ** -0.5), leaf(2 * f, scale=0.1)
    wo = leaf(d, d, scale=d ** -0.5)
    rms, ln = ops.NormSpec("rms", g), ops.NormSpec("layer", g, be)
    q = leaf(4, cfg.n_heads, 512, hd)
    k, v = leaf(4, cfg.n_kv_heads, 512, hd), leaf(4, cfg.n_kv_heads, 512, hd)
    r6 = get_config("rwkv6-3b")
    h, p = r6.d_model // r6.rwkv.head_dim, r6.rwkv.head_dim
    rr, kk, vv = (leaf(4, 512, h, p, scale=0.5) for _ in range(3))
    lw = (-torch.rand(4, 512, h, p, generator=gen, device="cuda") * 2
          - 0.05).to(dtype).requires_grad_(True)
    u = leaf(h, p, scale=0.5)
    mm = {"rowwise_matmul": 1}
    split = {"rowwise_matmul": 1, "layernorm": 1}
    return [
        ("matmul qkv +bias, split RMS norm", lambda: ops.matmul(
            x, w, bias=b, norm=rms), [x, w, b, g], split),
        ("matmul wo +residual", lambda: ops.matmul(x, wo, residual=res),
         [x, wo, res], mm),
        ("matmul gate|up silu, split LayerNorm", lambda: ops.gate_up_proj(
            x, wgi, activation="silu", bias=bgi, norm=ln),
         [x, wgi, bgi, g, be], split),
        ("matmul gate|up gelu", lambda: ops.gate_up_proj(
            x, wgi, activation="gelu", bias=bgi), [x, wgi, bgi], mm),
        ("attention causal, group 6", lambda: ops.attention(
            q, k, v, causal=True), [q, k, v], {"flash_attention": 1}),
        ("attention causal, window 128", lambda: ops.attention(
            q, k, v, causal=True, window=128), [q, k, v],
         {"flash_attention": 1}),
        ("layernorm RMS", lambda: ops.layernorm(x, g, kind="rms"), [x, g],
         {"layernorm": 1}),
        ("layernorm with beta", lambda: ops.layernorm(x, g, be,
                                                      kind="layer"),
         [x, g, be], {"layernorm": 1}),
        ("wkv RWKV6-3B", lambda: ops.wkv(rr, kk, vv, lw, u)[0],
         [rr, kk, vv, lw, u], {"wkv": 1},
         lambda: ops.wkv(*(t.float() for t in (rr, kk, vv, lw, u)))[0]),
    ]


def grads_phase():
    """Each op through ``ops`` with every tensor operand wanting a
    gradient, in fp32 and bf16: the kernel path's gradient of each
    input against the plain path's (the same op under
    ``use_impl("ref")``) within the kernel limits, the forward's launches
    exact and the backward launching none."""
    import torch
    from repro_torch.core import runtime

    t_phase = time.perf_counter()
    out = []
    for dtype, name, tol in ((torch.float32, "fp32", FP32_TOL),
                             (torch.bfloat16, "bf16", BF16_TOL)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        for case, call, ins, want, *plain_call in grad_cases(dtype, gen):
            rgen = torch.Generator(device="cuda").manual_seed(12)

            def grads(impl):
                with runtime.use_impl(impl):
                    o = (plain_call[0] if plain_call and impl == "ref"
                         else call)()
                    r = torch.randn(o.shape, generator=rgen, device="cuda")
                    return torch.autograd.grad((o.float() * r).sum(), ins)
            rstate = rgen.get_state()
            # the forward's launches and the backward's (none), together
            got, counts = counted(lambda: grads("auto"))
            rgen.set_state(rstate)
            plain = grads("ref")
            errs = [err_ok(a, w_, tol) for a, w_ in zip(got, plain)]
            launched = {n: c for n, c in counts.items() if c}
            say("grads", f"{case} {name}: max_abs_err per input "
                         f"{[round(e, 7) for e, _ in errs]}, max|plain| "
                         f"{[round(w_.abs().max().item(), 4) for w_ in plain]}"
                         f" (tol {tol}*max(1,max|plain|)); launches "
                         f"{launched}")
            if not all(ok for _, ok in errs):
                raise AssertionError(f"grads {case} {name}: {errs}")
            if launched != want:
                raise AssertionError(f"grads {case} {name}: launches "
                                     f"{launched}, want {want}")
            out.append({"case": case, "dtype": name,
                        "errs": [e for e, _ in errs], "launches": launched})
    say("grads", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------ training ---------------------------------

# step 0 of qwen2-vl-2b (fp32, B=4 x 512, 28 layers): the kernel path's
# loss and gradients against the plain path's on the same parameters
# and batch (PERF.md §2, written before the first run that held them):
# |loss difference| <= TRAIN_LOSS_TOL x |loss|, and every leaf's
# max|g_kernels - g_plain| <= TRAIN_GRAD_TOL x max|g_plain|
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
# 20 steps of lr 1e-3 on the synthetic Markov stream: the mean loss of
# the last 5 steps at least this far (nats) below the first 5's
TRAIN_MARGIN = 1.0
# the depth of the preemption and resume runs (a full-depth checkpoint
# is 24.7 GB of npz; cut from 4 to 2 layers to keep the script's time)
RESUME_LAYERS = 2


def train_counts(cfg, rows, dtype):
    """Launches of a train step with remat: the forward's (as a prefill's
    of ``rows`` rows, the head over every row), then each layer's kernels
    once more as the backward recomputes it; the head and the final norm
    run once, and the backward launches nothing."""
    fwd = lm_counts(cfg, rows, dtype, attention=True)
    return {k: 2 * v - {"rowwise_matmul": 1, "layernorm": 1}.get(k, 0)
            for k, v in fwd.items()}


def vl_batch(ds, step, extra=None):
    """``SyntheticLM``'s batch ``step`` on the card (as the train CLI sends
    it); with ``extra`` (a vision batch's) the patch rows' labels -1."""
    from repro_torch.core import runtime
    batch = {k: runtime.to_device(v, "cuda").long()
             for k, v in ds.batch(step).items()}
    if extra:
        n = extra["vis_embeds"].shape[1]
        labels = batch["labels"].clone()
        labels[:, :n] = -1
        batch = {**batch, "labels": labels, **extra}
    return batch


def no_syncs(phase, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: it must
    make no synchronising call. Returns its result."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        n0 = len(caught)
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught[n0:]
                 if "synchroniz" in str(w.message)]
    if syncs:
        raise AssertionError(f"{phase}: {len(syncs)} synchronising calls, "
                             f"first {syncs[0]}")
    return result


def train_phase(smi):
    """qwen2-vl-2b trained at full width and depth in fp32 at B=4 x 512
    on ``SyntheticLM``: step-0 parity of ``lm.loss_fn`` and its gradients
    on the kernel path against the plain path, on a batch with patch
    embeddings and (t, h, w) positions (the patch rows' labels -1, the
    gradient reaching ``vis_embeds``); then 20 steps of
    ``make_train_step`` (lr 1e-3, warmup 2 of 20), each counted
    (225 / 56 / 113 / 0) and free of synchronising calls, the loss
    falling by ``TRAIN_MARGIN``; readings: tokens/s, forward and
    backward wall time, peak memory, and the device's idle share over a
    step."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import runtime
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import profile
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as tsl

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-vl-2b")
    params = lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.float32)
    with torch.no_grad():
        jitter_norms(params, torch.Generator(device="cuda").manual_seed(1))
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                global_batch=4, seed=0))
    b, s = 4, 512
    gen = torch.Generator(device="cuda").manual_seed(3)
    _, extra = vl_inputs(cfg, gen, b, s, 128)
    ve = extra["vis_embeds"].requires_grad_(True)
    vbatch = vl_batch(ds, 0, extra)
    flat = tree_lib.leaves(params)
    out = {}

    # step 0: the kernel path against the plain path
    def value_and_grads(impl):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with runtime.use_impl(impl):
            loss, metrics = lm.loss_fn(tree_lib.unflatten(params, leaves),
                                       vbatch, cfg)
            grads = torch.autograd.grad(loss, leaves + [ve])
        return loss.detach(), metrics, grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss_k, metrics_k, grads_k), counts0 = counted(
        lambda: value_and_grads("auto"))
    step0_s = time.perf_counter() - t0
    loss_p, _, grads_p = value_and_grads("ref")
    paths = [p for p, _ in tree_lib.leaves_with_paths(params)] + [
        "vis_embeds"]
    rel = {}
    for path, a, w in zip(paths, grads_k, grads_p):
        scale = w.abs().max()
        rel[path] = ((a - w).abs().max() / scale.clamp(min=1e-30)).item()
    dloss = abs(loss_k.item() - loss_p.item())
    worst = max(rel, key=rel.get)
    ve_norm = grads_k[-1].norm().item()
    want = want_launches("qwen2-vl-2b train step",
                         train_counts(cfg, b * s, torch.float32))
    say("train", f"step 0 (B={b} x {s}, 128 patch rows a row, their labels "
                 f"-1, ntokens {int(metrics_k['ntokens'])}): loss kernels "
                 f"{loss_k.item():.7f} plain {loss_p.item():.7f} |diff| "
                 f"{dloss:.3g} (tol {TRAIN_LOSS_TOL}*|loss|); gradient "
                 f"relative error max|g-g_plain|/max|g_plain| over "
                 f"{len(rel)} leaves: worst {rel[worst]:.3g} ({worst}), "
                 f"median {sorted(rel.values())[len(rel) // 2]:.3g} (tol "
                 f"{TRAIN_GRAD_TOL}); |grad vis_embeds| {ve_norm:.4g}; "
                 f"launches {counts0} in {step0_s:.2f} s")
    out["step0"] = {"loss_kernels": loss_k.item(), "loss_plain":
                    loss_p.item(), "loss_diff": dloss, "grad_rel": rel,
                    "vis_embeds_grad_norm": ve_norm, "launches": counts0,
                    "seconds": step0_s}
    if dloss > TRAIN_LOSS_TOL * abs(loss_p.item()):
        raise AssertionError(f"train step 0: loss off by {dloss}")
    if rel[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"train step 0: gradient of {worst} off by "
                             f"{rel[worst]}")
    if not ve_norm > 0:
        raise AssertionError("train step 0: no gradient reaches vis_embeds")
    if counts0 != want:
        raise AssertionError(f"train step 0: launches {counts0}, want "
                             f"{want}")
    del grads_k, grads_p, ve, vbatch
    gc.collect()
    torch.cuda.empty_cache()

    # the forward and the backward apart (wall, after the warm-up above)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    tbatch = vl_batch(ds, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = lm.loss_fn(tree_lib.unflatten(params, leaves), tbatch, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    del loss, leaves

    # 20 steps
    tcfg = tsl.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3), warmup_steps=2,
                           total_steps=20)
    step = tsl.make_train_step(cfg, tcfg)
    state = tsl.init_state(params, tcfg)
    del params, flat
    batches = [vl_batch(ds, i) for i in range(20)]
    torch.cuda.reset_peak_memory_stats()
    metrics, step_s, step_counts = [], [], []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), c = counted(lambda: no_syncs(
            f"train step {i}", lambda: step(state, batches[i])))
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
        step_counts.append(c)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"].item() for m in metrics]
    skipped = [m["skipped"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    tok_s = b * s / (sum(step_s[1:]) / len(step_s[1:]))
    prof = profile.profile_call(lambda: step(state, batches[0]), b * s,
                                iters=1, attempts=3)
    out.update(losses=losses, skipped=skipped, grad_norms=gnorms,
               step_s=step_s, tokens_per_s=tok_s, forward_s=fwd_s,
               backward_s=bwd_s, peak_memory_gib=peak_gb,
               step_launches=step_counts[0],
               profile={k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                             "idle_share", "own_kernels_ms",
                                             "top")})
    say("train", f"20 steps (lr 1e-3, warmup 2 of 20, remat): loss "
                 f"{[round(x, 4) for x in losses]}; mean of the first 5 "
                 f"{first:.4f}, of the last 5 {last:.4f} (margin "
                 f"{TRAIN_MARGIN}); grad norms {gnorms[0]:.4g} .. "
                 f"{gnorms[-1]:.4g}; skipped {sum(skipped):.0f}; launches a "
                 f"step {step_counts[0]}; no synchronising call in a step")
    say("throughput", f"qwen2-vl-2b train step, fp32, B={b} x {s}: "
        f"{tok_s:.1f} tokens/s ({sum(step_s[1:]) / 19:.3f} s a step after "
        f"the first); forward {fwd_s:.3f} s, backward {bwd_s:.3f} s (loss "
        f"and gradients alone); peak memory {peak_gb:.2f} GiB; a profiled "
        f"step: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}, our kernels {prof['own_kernels_ms']} | "
        f"{smi}")
    if any(c != want for c in step_counts):
        raise AssertionError(f"train: launches a step {step_counts}, want "
                             f"{want}")
    if any(skipped) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: skipped {skipped}, losses {losses}")
    if not last < first - TRAIN_MARGIN:
        raise AssertionError(f"train: the loss fell from {first} to {last}")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say("train", f"phase took {out['seconds']:.1f} s")
    return out


def dir_bytes(path):
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def resume_phase():
    """Preemption and resume on the card, qwen2-vl-2b cut to
    ``RESUME_LAYERS`` layers at full width (fp32, B=4 x 512): 10 steps
    straight against 6 steps, ``save``, ``restore`` and 4 more (the
    parameters within 1e-6, the limit of the JAX package's
    ``tests/test_system.py``), the bytes and seconds of the save and the
    restore; then ``launch/train.py`` in this process, stopped by
    SIGTERM in its fifth step and run again to step 8: the resumed run
    starts from the checkpoint the SIGTERM hook wrote and ends on the
    parameters of a straight run. The checkpoints are deleted after."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import signal

    import torch
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lm
    from repro_torch.train import step as tsl

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"),
                              n_layers=RESUME_LAYERS)
    tcfg = tsl.TrainConfig(warmup_steps=2, total_steps=20)
    step = tsl.make_train_step(cfg, tcfg)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                global_batch=4, seed=7))
    batches = [vl_batch(ds, i) for i in range(10)]

    def start():
        return tsl.init_state(lm.init_lm(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda", dtype=torch.float32), tcfg)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        state = start()
        for i in range(10):
            state, _ = step(state, batches[i])
        ref = [t.clone() for t in tree_lib.leaves(state.params)]
        del state
        state = start()
        for i in range(6):
            state, _ = step(state, batches[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(str(root / "direct"), 6, state, extra={"data_step": 6})
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(root / "direct")
        like = state
        t0 = time.perf_counter()
        restored, extra = ckpt.restore(str(root / "direct"), 6, like,
                                       device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(restored), tree_lib.leaves(state)))
        del state, like
        for i in range(extra["data_step"], 10):
            restored, _ = step(restored, batches[i])
        diff = max((a - b).abs().max().item() for a, b in zip(
            ref, tree_lib.leaves(restored.params)))
        del restored, ref
        out["direct"] = {"max_param_diff": diff, "restore_bitwise": exact,
                         "save_s": save_s, "restore_s": restore_s,
                         "bytes": nbytes}
        say("resume", f"{cfg.name} at {cfg.n_layers} layers, fp32: 10 steps "
                      f"straight against 6 + save + restore + 4: max param "
                      f"diff {diff:.3g} (limit 1e-6); the restore equal to "
                      f"the saved state bit for bit: {exact}; a checkpoint "
                      f"{nbytes / 1e9:.3f} GB, save {save_s:.2f} s, restore "
                      f"(sha256 checked) {restore_s:.2f} s")
        if not diff < 1e-6 or not exact:
            raise AssertionError(f"resume: params differ by {diff}, "
                                 f"restore bitwise {exact}")
        shutil.rmtree(root / "direct")
        gc.collect()
        torch.cuda.empty_cache()

        # the CLI, stopped by SIGTERM in its fifth step, then resumed
        argv = ["--arch", "qwen2-vl-2b", "--layers", str(RESUME_LAYERS),
                "--steps", "8", "--batch", "4", "--seq", "512",
                "--ckpt-every", "4", "--device", "cuda"]
        logs = {}

        def run(name, extra_argv, make_step=None):
            orig = train_cli.tsl.make_train_step
            if make_step:
                train_cli.tsl.make_train_step = make_step
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    try:
                        result = train_cli.main(argv + extra_argv)
                    except SystemExit as e:
                        result = ("exit", e.code)
            finally:
                train_cli.tsl.make_train_step = orig
            logs[name] = {"stdout": buf.getvalue(),
                          "seconds": time.perf_counter() - t0}
            return result

        make_step = tsl.make_train_step

        def preempting(cfg_, tcfg_):
            fn, calls = make_step(cfg_, tcfg_), [0]

            def stepped(st, bt):
                calls[0] += 1
                if calls[0] == 5:
                    os.kill(os.getpid(), signal.SIGTERM)
                return fn(st, bt)
            return stepped
        straight = run("straight", [])
        straight = [t.clone() for t in tree_lib.leaves(straight.params)]
        cdir = str(root / "cli")
        stopped = run("preempted", ["--ckpt-dir", cdir], preempting)
        steps_after_stop = ckpt.all_steps(cdir)
        resumed = run("resumed", ["--ckpt-dir", cdir])
        same = all(torch.equal(a, b) for a, b in zip(
            straight, tree_lib.leaves(resumed.params)))
        diff = max((a - b).abs().max().item() for a, b in zip(
            straight, tree_lib.leaves(resumed.params)))
        res_line = [ln for ln in logs["resumed"]["stdout"].splitlines()
                    if ln.startswith("resumed from step")]
        out["cli"] = {"stopped": list(stopped), "checkpoints_after_stop":
                      steps_after_stop, "resumed_line": res_line,
                      "equal_to_straight": same, "max_param_diff": diff,
                      "logs": logs}
        for name, log in logs.items():
            for ln in log["stdout"].splitlines():
                say(f"train-cli {name}", ln)
            say(f"train-cli {name}", f"took {log['seconds']:.1f} s")
        say("resume", f"launch/train.py: stopped {tuple(stopped)} with "
                      f"checkpoints {steps_after_stop} (the async save of "
                      f"step 4, the SIGTERM hook's of step 5); resumed: "
                      f"{res_line}; its parameters against the straight "
                      f"run's: max diff {diff:.3g}, bitwise {same}")
        if tuple(stopped) != ("exit", 0) or steps_after_stop != [4, 5]:
            raise AssertionError(f"train CLI: stopped {stopped}, "
                                 f"checkpoints {steps_after_stop}")
        if res_line != ["resumed from step 5"]:
            raise AssertionError(f"train CLI: resumed {res_line}")
        if not diff < 1e-6:
            raise AssertionError(f"train CLI: resumed run off by {diff}")
        if int(resumed.opt.step) != 8:
            raise AssertionError(f"train CLI: step {int(resumed.opt.step)}")
        del resumed, straight
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say("resume", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------ tensor parallelism ----------------------

# every collective, and the whole run of a world of ranks, must end in
# this many seconds: a rank that hangs fails the phase, it does not eat
# the run's time limit
TP_TIMEOUT_S = 300
TP_NEW = 8                  # tokens a request
TP_GEMMA_LAYERS = 12        # two 5:1 groups: two global layers, the rest
#                             local (window 1024), and the tied head
TP_STEP_ITERS = 10          # decode steps timed, the same on every rank
TP_DEADLINE = {3: 600.0}    # rid 3 carries a deadline (far off: it ends ok)
# the configs of the phase: (name, probe batch B x S); the ranks run
# them in this order
TP_CONFIGS = (("deepseek-fp32", (4, 512)), ("deepseek-bf16", (4, 512)),
              ("deepseek-int8", (4, 512)), ("gemma-bf16", (2, 2048)))
TP_DIR = ROOT / "build" / "tp"


def tp_cases(cfg, t, batch, dtype, gen, device, keys):
    """Every kernel call of one rank's prefill (``batch`` = B x S) and
    decode step (B rows) of ``cfg`` at ``t`` ranks, at the local shapes
    (``TensorParallel.compute_cfg``): per layer the qkv panel at N / t
    and the gate|up panel at segments of d_ff / t, each with its RMS
    norm (split or not: :func:`norm_matmul_cases`), wo at K = n_heads hd
    / t and down at K = d_ff / t with no residual (the residual is added
    after the all-reduce), causal attention at prefill over n_heads / t
    heads and n_kv_heads / t KV heads (the local layers with their
    window); the vocab-sharded head at N = padded_vocab / t, or the
    tied head whole, and the final norm, on the last position only.
    ``keys``: the count keys of the prefill and the step."""
    from repro_torch.models import attention, lm
    from repro_torch.serve.placement import TensorParallel
    loc = TensorParallel(t).compute_cfg(cfg)
    b, s = batch
    d, f, n = cfg.d_model, loc.d_ff, cfg.n_layers
    qkv, ho = sum(attention.proj_splits(loc)), loc.n_heads * loc.head_dim
    act = "gelu" if cfg.act == "geglu" else cfg.act
    windowed = sum(st.repeat * sum(1 for blk in st.body if blk.window)
                   for st in cfg.stages())
    name = f"{cfg.name.split('-')[0]}/t{t}"
    cases = []
    for m, key in ((b * s, keys[0]), (b, keys[1])):
        tag = f"{name}.{'prefill' if m > b else 'decode'}"
        cases += norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen,
                                   device, norm="rms", bias=False,
                                   **{key: n})
        cases += norm_matmul_cases(f"{tag} gate|up+{act}", m, d, f, dtype,
                                   gen, device, norm="rms", bias=False,
                                   act=act, gated=True, panel=(2 * f, 0),
                                   **{key: n})
        cases += [matmul_case(f"{tag} wo", m, ho, d, dtype, gen, device,
                              bias=False, **{key: n}),
                  matmul_case(f"{tag} down", m, f, d, dtype, gen, device,
                              bias=False, **{key: n})]
    vp = lm.padded_vocab(cfg)
    head = vp if cfg.tie_embeddings else vp // t
    head_name = "tied head" if cfg.tie_embeddings else "lm_head"
    shape = (b, s, cfg.head_dim)
    cases += [
        matmul_case(f"{name} {head_name} fp32-out", b, d, head, dtype, gen,
                    device, bias=False, out_f32=True,
                    **{keys[0]: 1, keys[1]: 1}),
        layernorm_case(f"{name} final_norm", b, d, dtype, gen, device,
                       kind="rms", **{keys[0]: 1, keys[1]: 1}),
        attention_case(f"{name}.prefill causal", shape, loc.n_heads,
                       loc.n_kv_heads, dtype, gen, device, causal=True,
                       **{keys[0]: n - windowed})]
    if windowed:
        cases.append(attention_case(
            f"{name}.prefill causal+window", shape, loc.n_heads,
            loc.n_kv_heads, dtype, gen, device, causal=True,
            window=cfg.local_window, **{keys[0]: windowed}))
    return cases


def tp_tree(name):
    """The full parameter tree and config of one TP config, built on the
    card from the seeds the dense and gemma phases use (fp32, the norms
    jittered): deepseek-7b in fp32, its bf16 copy, its weight-only int8
    tree under the config with its dtype set to fp32 (the int8 leaves
    dequantize to fp32), and gemma3-27b cut to ``TP_GEMMA_LAYERS`` in
    bf16."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.models import lm
    arch = "deepseek-7b" if name.startswith("deepseek") else "gemma3-27b"
    cfg = get_config(arch)
    if arch == "gemma3-27b":
        cfg = dataclasses.replace(cfg, n_layers=TP_GEMMA_LAYERS)
    tree = lm.LanguageModel(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0)
    ).params.tree()
    with torch.no_grad():
        jitter_norms(tree, torch.Generator(device="cuda").manual_seed(1))
    if name.endswith("bf16"):
        tree = to_bf16(tree)
    elif name.endswith("int8"):
        tree = quant.quantize_tree(tree, quant.lm_weight_predicate)
        cfg = dataclasses.replace(cfg, dtype="float32")
    return tree, cfg


def tp_engine(tree, cfg, placement):
    """The TP phase's engine: 4 slots of pages of 16 (max_len 1024),
    chunks of 256, the prefix cache (a windowed arch opts out)."""
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve.engine import Engine
    return Engine(tree, cfg, n_slots=4, max_len=1024, eos_id=-1,
                  device="cuda", placement=placement,
                  paging=PagingConfig(page_size=16, prefill_chunk=256,
                                      prefix_cache=True))


def tp_inputs(cfg, batch):
    """The six engine requests (seeded): 97, 700 (chunked at 256), 64,
    200 (rid 3: with a deadline), 600 sharing the 700's first 520 tokens
    (a prefix hit, chunked) and 150; and the probe batch (B x S) of the
    dense prefill and step."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(23)
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=gen, device="cuda")
            for n in (97, 700, 64, 200, 80, 150)]
    reqs[4] = torch.cat([reqs[1][:520], reqs[4]])
    probe = torch.randint(0, cfg.vocab, batch, generator=gen, device="cuda")
    return reqs, probe


def tp_launch_key(cfg):
    return "deepseek-7b" if cfg.name == "deepseek-7b" else (
        f"gemma3-27b/{cfg.n_layers}")


def collectives():
    from repro_torch.core import partitioning
    return {"all_reduce": partitioning.tp_reduce,
            "all_gather": partitioning.tp_gather}


def tp_serve(phase, name, eng, batch, oracles, *, sync_check):
    """One TP config on ``eng`` (built on its placement; on a rank, from
    that rank's shard): a dense prefill of the probe batch and one decode
    step through ``placement.wrap`` (their launches; the first-token
    logits), ``TP_STEP_ITERS`` decode steps timed by CUDA events (the
    same count on every rank), then the six requests through the engine
    (:func:`serve_engine`: each call's launches held to the counts the
    local config gives, which are single-device's; streams held to
    ``oracles`` by the near-tie rule where given), with the collectives
    counted over the run; peak memory over all of it."""
    import torch
    from repro_torch.models import lm
    cfg, rcfg, place = eng.cfg, eng.rcfg, eng.placement
    dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
    reqs, probe = tp_inputs(cfg, batch)
    b, s = batch
    prefill, step = place.wrap(lm.prefill), place.wrap(lm.decode_step)
    torch.cuda.reset_peak_memory_stats()
    for c in collectives().values():
        c.launches = 0
    with torch.no_grad():
        (lg, cache), pre = counted(lambda: prefill(eng.params, probe, rcfg,
                                                   alloc=s + 1))
        first = lg[:, :cfg.vocab].float().cpu()
        tok = lg.argmax(-1)[:, None]
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
        _, dec = counted(lambda: step(eng.params, cache, tok, lengths, rcfg))
        probe_coll = {k: c.launches for k, c in collectives().items()}
        for _ in range(3):
            step(eng.params, cache, tok, lengths, rcfg)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TP_STEP_ITERS):
            step(eng.params, cache, tok, lengths, rcfg)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / TP_STEP_ITERS
    del lg, cache
    key = tp_launch_key(cfg)
    want_pre = want_launches(f"{key} prefill", lm_counts(
        rcfg, b * s, dtype, attention=True))
    want_dec = want_launches(f"{key} step", lm_counts(
        rcfg, b, dtype, attention=False))
    if pre != want_pre or dec != want_dec:
        raise AssertionError(f"{phase}: a prefill launched {pre}, a step "
                             f"{dec}; want {want_pre}, {want_dec}")
    for c in collectives().values():
        c.launches = 0
    res = serve_engine(phase, eng, reqs, oracles,
                       want=paged_launches(key, rcfg, dtype), max_new=TP_NEW,
                       sync_check=sync_check, eng=eng, deadlines=TP_DEADLINE)
    coll = {k: c.launches for k, c in collectives().items()}
    layers = sum(st.repeat * len(st.body) for st in cfg.stages())
    model_calls = sum(res["calls"][k] for k in ("prefill", "chunk", "step",
                                                "verify"))
    want_coll = {"all_reduce": 2 * layers * model_calls,
                 "all_gather": 0 if cfg.tie_embeddings else model_calls}
    want_probe = {"all_reduce": 4 * layers, "all_gather":
                  0 if cfg.tie_embeddings else 2}
    if place.axis is not None:
        if coll != want_coll or probe_coll != want_probe:
            raise AssertionError(
                f"{phase}: collectives {coll} over {model_calls} model calls"
                f" (want {want_coll}); the probe's {probe_coll} (want "
                f"{want_probe})")
    elif any(coll.values()) or any(probe_coll.values()):
        raise AssertionError(f"{phase}: one device launched collectives "
                             f"{coll}, {probe_coll}")
    if name.startswith("deepseek") and not res["stats"]["prefix_hits"]:
        raise AssertionError(f"{phase}: no prefix hit: {res['stats']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(phase, f"{name} on {place.describe()}: probe prefill B={b} x {s} "
        f"launched {pre}, a step {dec}, collectives {probe_coll}; "
        f"{TP_STEP_ITERS} decode steps at B={b}: {step_ms:.4f} ms a step "
        f"(CUDA events); the engine's collectives {coll} over {model_calls} "
        f"model calls; peak memory {peak:.2f} GiB")
    return {"tokens": res["tokens"], "statuses": res["statuses"],
            "stats": res["stats"], "launches": res["launches"],
            "calls": res["calls"], "run_s": res["run_s"],
            "collectives": coll, "probe_collectives": probe_coll,
            "probe_launches": {"prefill": pre, "step": dec},
            "step_ms": step_ms, "peak_gib": peak,
            "step_gaps_s": [float(g) for g in res["step_gaps_s"]],
            "first": first}


def tp_oracles(tree, cfg, name, batch):
    """The dense path's greedy streams of the six requests (near-tie
    flags at the bf16 tolerance; ``dense_oracle``), for the bf16 runs."""
    from repro_torch.models import lm
    model = lm.LanguageModel(cfg, tree, device="cuda")
    reqs, _ = tp_inputs(cfg, batch)
    return [{k: v for k, v in dense_oracle(model, r, TP_NEW, BF16_TOL)
             .items() if k in ("tokens", "ties")} for r in reqs]


def tp_rank(rank, t, init):
    """One rank of the TP phase's world (a process of its own, on the
    one card): joins the gloo group at ``init``, then for each of
    :data:`TP_CONFIGS` builds the full tree, its engine on
    ``TensorParallel(t)`` (so keeping its shard) and frees the full tree,
    one rank after another (two full fp32 trees would not fit beside the
    shards), and serves it (:func:`tp_serve`). Its results, first-token
    logits included, go to ``TP_DIR / rank<i>.pt``."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.serve.placement import TensorParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.library()
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=t,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    place = TensorParallel(t, rank=rank, timeout_s=TP_TIMEOUT_S)
    place.connect()
    oracles = torch.load(TP_DIR / "oracles.pt")
    out = {}
    for name, batch in TP_CONFIGS:
        t0 = time.perf_counter()
        eng = None
        for r in range(t):
            if r == rank:
                tree, cfg = tp_tree(name)
                eng = tp_engine(tree, cfg, place)
                del tree
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        built = time.perf_counter() - t0
        out[name] = tp_serve(f"tp-t{t}-rank{rank}", name, eng, batch,
                             oracles.get(name), sync_check=False)
        out[name]["build_s"] = built
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()                   # no rank leaves while one still sends
    dist.destroy_process_group()
    torch.save(out, TP_DIR / f"rank{rank}.pt")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_world(t):
    """The ranks of :func:`tp_rank`, each a process on the one card, all
    waited for under ``TP_TIMEOUT_S`` x the configs: a rank that fails or
    hangs fails the phase (every rank is then stopped). Rank 0 prints to
    this output, the others to ``chiprun_out/tp_rank<i>.log``."""
    import torch
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    logs = [None] + [open(ROOT / "chiprun_out" / f"tp_rank{i}.log", "w")
                     for i in range(1, t)]
    init = f"tcp://localhost:{free_port()}"
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import chip_smoke "
            "as c; c.tp_rank({}, {}, {!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(str(ROOT), str(ROOT / "src"), i,
                                           t, init)],
        cwd=ROOT, stdout=logs[i], stderr=subprocess.STDOUT if logs[i]
        else None) for i in range(t)]
    deadline = time.monotonic() + TP_TIMEOUT_S * len(TP_CONFIGS)
    try:
        # a rank that fails stops the others at once: they would wait in
        # their next collective until its timeout
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs[1:]:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"tp: the ranks of t = {t} exited {codes} "
                             "(rank 1's log: chiprun_out/tp_rank1.log)")
    return [torch.load(TP_DIR / f"rank{i}.pt") for i in range(t)]


def tp_cli(smi):
    """``launch/serve.py`` at ``--mesh-shape model=2`` (its ranks spawned
    by the CLI, gloo on the one card, deepseek-7b cut to 2 layers), held
    to the same CLI on one device: each rank's completions the same and
    the printed streams equal to one device's."""
    import re
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "deepseek-7b", "--layers", "2", "--requests", "6", "--slots",
            "4", "--max-len", "1024", "--max-new", "16", "--prompt-len",
            "300", "--prefill-chunk", "256", "--prefix-cache",
            "--device", "cuda:0"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    outs = {}
    for label, extra in (("one device", []),
                         ("model=2", ["--mesh-shape", "model=2",
                                      "--dist-backend", "gloo",
                                      "--dist-timeout", str(TP_TIMEOUT_S)])):
        t0 = time.perf_counter()
        run = subprocess.run(args + extra, cwd=ROOT, env=env,
                             capture_output=True, text=True,
                             timeout=2 * TP_TIMEOUT_S)
        if run.returncode:
            raise AssertionError(f"tp-cli {label}: exit {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        outs[label] = run.stdout
        say("tp-cli", f"{label} in {time.perf_counter() - t0:.1f} s: "
            + " | ".join(line.strip() for line in run.stdout.splitlines()
                         if "statuses" in line or "ranks:" in line
                         or "decoded" in line))
    pattern = r"rid=\d+ status=\w+ prompt_len=\d+ tokens=\[[^]]*\]"
    rows = [re.findall(pattern, o) for o in outs.values()]
    if (not rows[0] or rows[0] != rows[1] or "ranks: 2, every rank's "
            "completions" not in outs["model=2"]
            or "statuses: {'ok': 6}" not in outs["model=2"]):
        raise AssertionError(f"tp-cli: one device printed {rows[0]}, "
                             f"model=2 {outs['model=2'][-2000:]}")
    return {"rows": rows[0], "stdout": outs}


def tp_json(run):
    """A TP run's readings without its logits tensor."""
    return {k: v for k, v in run.items() if k != "first"}


def tp_phase(smi):
    """Tensor-parallel serving (``serve/placement.py``): each config of
    :data:`TP_CONFIGS` on one device (``SingleDevice``, the reference),
    then deepseek-7b in fp32 as ``TensorParallel(1)`` on a one-rank NCCL
    group (real collectives, launched), then every config at t = 2 as
    two processes on the one card over gloo (NCCL refuses two ranks on
    one device; gloo stages each collective through host memory, so its
    step time is no TP speed), then the CLI at ``model=2``. Held: every
    rank's completions identical; equal to one device's exactly in fp32
    (the int8 tree runs in fp32) and, in bf16, to the dense stream up to
    a near-tie; the probe's fp32 first-token logits within LOGIT_TOL x
    max(1, max|logit|) of one device's; each call's launches those of
    one device at the local shapes; 2 all-reduces a layer and, with an
    untied head, 1 all-gather a model call."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.serve.placement import SingleDevice, TensorParallel

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    TP_DIR.mkdir(parents=True, exist_ok=True)
    single, oracles = {}, {}
    for name, batch in TP_CONFIGS:
        tree, cfg = tp_tree(name)
        if name.endswith("bf16"):
            oracles[name] = tp_oracles(tree, cfg, name, batch)
        eng = tp_engine(tree, cfg, SingleDevice())
        single[name] = tp_serve("tp-single", name, eng, batch,
                                oracles.get(name), sync_check=True)
        if name == "deepseek-fp32":
            # t = 1 on NCCL, on the same tree
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{free_port()}",
                rank=0, world_size=1,
                timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
            try:
                eng1 = tp_engine(tree, cfg, TensorParallel(
                    1, timeout_s=TP_TIMEOUT_S))
                one = tp_serve("tp-t1-nccl", name, eng1, batch, None,
                               sync_check=True)
                del eng1
            finally:
                dist.destroy_process_group()
        del eng, tree
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(oracles, TP_DIR / "oracles.pt")
    t_world = time.perf_counter()
    ranks = tp_world(2)
    world_s = time.perf_counter() - t_world
    out = {"single": {}, "t1": {}, "t2": {}}
    for name, _ in TP_CONFIGS:
        ref = single[name]
        fp32 = not name.endswith("bf16")
        runs = [(f"t2 rank{i}", r[name]) for i, r in enumerate(ranks)]
        if name == "deepseek-fp32":
            runs.insert(0, ("t1 nccl", one))
        for label, got in runs:
            err, ok = err_ok(got["first"], ref["first"], LOGIT_TOL)
            same = got["tokens"] == ref["tokens"]
            if got["probe_launches"] != ref["probe_launches"] or (
                    got["launches"] != ref["launches"]):
                raise AssertionError(f"tp {name} {label}: launches "
                                     f"{got['probe_launches']} / "
                                     f"{got['launches']}, one device's "
                                     f"{ref['probe_launches']} / "
                                     f"{ref['launches']}")
            if fp32 and (not ok or not same):
                raise AssertionError(f"tp {name} {label}: first-token logits"
                                     f" {err} off, streams equal {same}")
            if any(s != "ok" for s in got["statuses"].values()):
                raise AssertionError(f"tp {name} {label}: statuses "
                                     f"{got['statuses']}")
            say("tp", f"{name} {label}: first-token logits {err:.4g} off one "
                f"device's (tol {LOGIT_TOL}*max(1,max|logit|)"
                f"{'' if fp32 else ', a bf16 reading'}); streams equal to "
                f"one device's: {same}; launches as one device's; "
                f"collectives {got['collectives']}; peak "
                f"{got['peak_gib']:.2f} GiB (one device "
                f"{ref['peak_gib']:.2f}); a decode step {got['step_ms']:.4f}"
                f" ms (one device {ref['step_ms']:.4f})"
                + ("" if label.startswith("t1") else
                   ", host-staged gloo: no TP speed")
                + f" | {smi}")
        if [r[name]["tokens"] for r in ranks].count(ranks[0][name]["tokens"]) \
                != len(ranks):
            raise AssertionError(f"tp {name}: the ranks' streams differ")
        out["single"][name] = tp_json(ref)
        out["t2"][name] = [tp_json(r[name]) for r in ranks]
    out["t1"]["deepseek-fp32"] = tp_json(one)
    out["world_s"] = world_s
    out["cli"] = tp_cli(smi)
    out["seconds"] = time.perf_counter() - t_phase
    say("tp", f"phase took {out['seconds']:.1f} s (the t = 2 world "
              f"{world_s:.1f} s)")
    return out


# ------------------------------ the training mesh ----------------------

MESH_TIMEOUT_S = 600        # a collective, and the world's whole run
MESH_DIR = ROOT / "build" / "mesh"
MESH_STEPS = 3              # sharded steps a run (warmup 1: steps 1-2 move)
# the two-process runs share the one card, their collectives staged
# through the host by gloo (~1 GB/s on an H100 80GB HBM3 host: a data=2
# step at 8 layers took 27.6 s): qwen2-vl-2b cut from 28 layers to this
# many for the data=2 and pod=2 runs (time; pod=2 also memory: each pod
# holds the whole state and residual), qwen2-moe-a2.7b from 24 to 2
# (memory: each rank holds one device's reference tree beside its
# shard), deepseek-7b from 32 to 8 for the sequence-sharded decode (time
# and memory)
MESH_VL_LAYERS = 2
MESH_MOE_LAYERS = 2
MESH_DECODE_LAYERS = 8
MESH_MOE_SEQ = 256
MESH_DECODE = (2, 512, 16)  # B, prompt, steps
MESH_RULES = {"kv_seq": "model", "decode_attn": "sharded",
              # at B=2 on model=2 the default rule would give the batch
              # the model axis first (resolve walks the dims in order)
              "batch": ("pod", "data")}


def mesh_cases(cfg, dtype, gen, device):
    """Every kernel call of one rank's train step at data=2 (B=2 x 512,
    M=1024; ``mtrain``), qwen2-vl-2b at ``MESH_VL_LAYERS`` layers: each
    layer's calls twice (the forward's and the recomputation's), the
    head and the final norm once."""
    from repro_torch.models import attention, lm
    d, f, n = cfg.d_model, cfg.d_ff, MESH_VL_LAYERS
    qkv, ho = sum(attention.proj_splits(cfg)), cfg.n_heads * cfg.head_dim
    m, tag = 2 * 512, "mesh.train"
    counts = {"mtrain": 2 * n}
    cases = norm_matmul_cases(f"{tag} qkv", m, d, qkv, dtype, gen, device,
                              norm="rms", bias=False, **counts)
    cases += norm_matmul_cases(f"{tag} gate|up+silu", m, d, f, dtype, gen,
                               device, norm="rms", bias=False, act="silu",
                               gated=True, panel=(2 * f, 0), **counts)
    return cases + [
        matmul_case(f"{tag} wo+res", m, ho, d, dtype, gen, device,
                    bias=False, residual=True, **counts),
        matmul_case(f"{tag} down+res", m, f, d, dtype, gen, device,
                    bias=False, residual=True, **counts),
        attention_case(f"{tag} causal", (2, 512, cfg.head_dim), cfg.n_heads,
                       cfg.n_kv_heads, dtype, gen, device, causal=True,
                       mtrain=2 * n),
        matmul_case(f"{tag} lm_head fp32-out", m, d, lm.padded_vocab(cfg),
                    dtype, gen, device, bias=False, out_f32=True, mtrain=1),
        layernorm_case(f"{tag} final_norm", m, d, dtype, gen, device,
                       kind="rms", mtrain=1)]


def mesh_counts(cfg, shardings, n_buckets):
    """The collectives of one sharded train step, derived from the spec
    tree: each read of a leaf split over some axis is one all-gather (a
    stacked leaf's every repeat twice, the forward's and the
    recomputation's; the tied embedding twice, its gather and the head)
    and one reduce-scatter; all-reduces: the loss's three sums, the
    gradient buckets and one a set of axes for the global norm. Returns
    (counts, the derivation)."""
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    gathers = scatters = 0
    norm_sets = set()
    lines = []
    for path, s in tree_lib.leaves_with_paths(shardings):
        spec = part.local_gather_spec(s)
        if s.axes():
            norm_sets.add(s.axes())
        if not any(part.spec_axes(e) for e in spec):
            continue
        if path.startswith("stages/"):
            reps = next(st.repeat for i, st in enumerate(cfg.stages())
                        if path.startswith(f"stages/{i}/"))
            gathers += 2 * reps
            scatters += reps
            lines.append(f"{path} {s.spec}: {reps} repeats x 2 gathers")
        else:
            reads = 2 if path == "embed" and cfg.tie_embeddings else 1
            gathers += reads
            scatters += reads
            lines.append(f"{path} {s.spec}: {reads} read(s)")
    counts = {"all_gather": gathers, "reduce_scatter": scatters,
              "all_reduce": 3 + n_buckets + len(norm_sets),
              "all_to_all": 0, "staged": 0}
    return counts, lines


def grad_buckets(cfg, shardings, mesh):
    """The all-reduces of the gradients' reduction (``train/step.py``):
    the leaves grouped by the axes they are not split over, each group
    filled in order into buckets of at most ``BUCKET`` elements."""
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import lm
    from repro_torch.train import step as tsl
    groups = {}
    for s, t in zip(tree_lib.leaves(shardings),
                    tree_lib.leaves(lm.param_shapes(cfg))):
        rest = tuple(a for a in part.auto_axes(mesh) if a not in s.axes())
        if rest:
            groups.setdefault(rest, []).append(
                math.prod(s.local_shape(t.shape)))
    n = 0
    for numels in groups.values():
        size = 0
        for k in numels:
            if size and size + k > tsl.BUCKET:
                n += 1
                size = 0
            size += k
        n += 1
    return n


def host_leaves(tree):
    from repro_torch.core import tree as tree_lib
    return [t.detach().cpu() for t in tree_lib.leaves(tree)]


def vl_train_inputs(cfg, b, seed):
    """A qwen2-vl-2b training batch of ``b`` x 512 on the card: tokens and
    labels of ``SyntheticLM`` with 128 patch embeddings (labels -1) and
    their (t, h, w) positions."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                global_batch=b, seed=seed))
    _, extra = vl_inputs(cfg, torch.Generator(device="cuda").manual_seed(3),
                         b, 512, 128)
    return vl_batch(ds, 0, extra)


def vl_params(cfg):
    import torch
    from repro_torch.models import lm
    params = lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.float32)
    with torch.no_grad():
        jitter_norms(params, torch.Generator(device="cuda").manual_seed(1))
    return params


def mesh_tcfg(**kw):
    from repro_torch.optim import adamw
    from repro_torch.train import step as tsl
    return tsl.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3), warmup_steps=1,
                           total_steps=20, **kw)


def one_device_run(cfg, batch, tcfg, steps):
    """One device's reference: step-0 gradients and the parameters after
    ``steps`` steps on the host, each step's loss and launches, the
    peak memory."""
    import gc

    import torch
    from repro_torch.train import step as tsl
    torch.cuda.reset_peak_memory_stats()
    state = tsl.init_state(vl_params(cfg), tcfg)
    grads, _ = tsl._grads_and_metrics(state.params, batch, cfg, tcfg)
    grads = host_leaves(grads)
    step = tsl.make_train_step(cfg, tcfg)
    losses, counts, step_s = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), c = counted(lambda: step(state, batch))
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        counts.append(c)
    out = {"grads": grads, "params": host_leaves(state.params),
           "losses": losses, "launches": counts, "step_s": step_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rel_errs(got, want):
    """max|g - w| / max|w| of each leaf."""
    return [((a - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for a, w in zip(got, want)]


def mesh_world1(smi):
    """(a) qwen2-vl-2b at full width and depth, fp32, B=4 x 512 with patch
    embeddings, one device and then the sharded step on a (1,1,1) mesh
    over a one-rank NCCL group (real collectives): 3 steps each, losses,
    step-0 gradients and the parameters after 3 steps bitwise one
    device's; each step's launches one device's, its collectives the
    count the spec tree gives, and no synchronising call. Both run
    under ``torch.use_deterministic_algorithms``: without it one device's
    step does not repeat itself bit for bit (the embedding's gradient
    adds the rows of repeated tokens with atomics)."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.train import step as tsl
    t_run = time.perf_counter()
    cfg = get_config("qwen2-vl-2b")
    tcfg = mesh_tcfg()
    batch = vl_train_inputs(cfg, 4, 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    ref = one_device_run(cfg, batch, tcfg, MESH_STEPS)
    want = want_launches("qwen2-vl-2b train step",
                         train_counts(cfg, 4 * 512, torch.float32))
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_host_mesh((1, 1, 1))
        step = tsl.make_train_step(cfg, tcfg, mesh=mesh)
        sh = tsl.state_shardings(cfg, tcfg, mesh)
        with part.use_mesh(mesh):
            derived, lines = mesh_counts(cfg, sh.params,
                                         grad_buckets(cfg, sh.params, mesh))
        for ln in lines:
            say("mesh-a", f"derivation: {ln}")
        torch.cuda.reset_peak_memory_stats()
        state = tsl.shard_state(tsl.init_state(vl_params(cfg), tcfg), sh)
        grads, _ = step.grads_and_metrics(state, batch)
        g_same = all(torch.equal(a, b) for a, b in zip(
            host_leaves(grads), ref["grads"]))
        del grads
        losses, counts, colls, step_s = [], [], [], []
        for i in range(MESH_STEPS):
            part.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, m), c = counted(lambda: no_syncs(
                f"mesh-a step {i}", lambda: step(state, batch)))
            step_s.append(time.perf_counter() - t0)
            colls.append(part.counts())
            counts.append(c)
            losses.append(m["loss"].item())
        p_same = all(torch.equal(a, b) for a, b in zip(
            host_leaves(state.params), ref["params"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del state
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    out = {"losses": losses, "ref_losses": ref["losses"],
           "grads_bitwise": g_same, "params_bitwise": p_same,
           "launches": counts, "collectives": colls, "derived": derived,
           "step_s": step_s, "peak_gib": peak, "ref_peak_gib":
           ref["peak_gib"], "ref_launches": ref["launches"],
           "ref_step_s": ref["step_s"],
           "seconds": time.perf_counter() - t_run}
    say("mesh-a", f"qwen2-vl-2b fp32 B=4 x 512, world 1 on NCCL, mesh "
        f"(1,1,1): losses {losses} against one device's {ref['losses']} "
        f"(bitwise: {losses == ref['losses']}); step-0 gradients bitwise: "
        f"{g_same}; parameters after {MESH_STEPS} steps bitwise: {p_same}; "
        f"launches a step {counts[0]} (one device {ref['launches'][0]}); "
        f"collectives a step {colls[0]} (derived {derived}); no "
        f"synchronising call in a step; a step {min(step_s):.3f} s (one "
        f"device {min(ref['step_s']):.3f} s); peak "
        f"{peak:.2f} GiB (one device {ref['peak_gib']:.2f}); the run "
        f"{out['seconds']:.1f} s | {smi}")
    if not (losses == ref["losses"] and g_same and p_same):
        raise AssertionError(f"mesh-a: not one device's bit for bit: "
                             f"losses {losses} / {ref['losses']}, grads "
                             f"{g_same}, params {p_same}")
    if any(c != want for c in counts + ref["launches"]):
        raise AssertionError(f"mesh-a: launches {counts}, one device "
                             f"{ref['launches']}, want {want}")
    if any(c != derived for c in colls):
        raise AssertionError(f"mesh-a: collectives {colls}, derived "
                             f"{derived}")
    return out


def world_data2(rank, mesh_data, smi):
    """(b) data=2: qwen2-vl-2b at ``MESH_VL_LAYERS`` layers, B=2 x 512 a
    rank; rank 0 first runs one device's reference at B=4."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.train import step as tsl
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"),
                              n_layers=MESH_VL_LAYERS)
    tcfg = mesh_tcfg()
    batch = vl_train_inputs(cfg, 4, 0)
    ref = one_device_run(cfg, batch, tcfg, MESH_STEPS) if rank == 0 \
        else None
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    step = tsl.make_train_step(cfg, tcfg, mesh=mesh_data)
    sh = tsl.state_shardings(cfg, tcfg, mesh_data)
    state = tsl.shard_state(tsl.init_state(vl_params(cfg), tcfg), sh)
    gc.collect()
    torch.cuda.empty_cache()

    def first():
        # step 0 as the step runs it, its gradient blocks kept
        g, m = step.grads_and_metrics(state, batch)
        return g, tsl._apply_update(state, g, m, cfg, tcfg, step.shardings)
    losses, counts, colls, step_s = [], [], [], []
    for i in range(MESH_STEPS):
        part.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            (grads, (state, m)), c = counted(first)
        else:
            (state, m), c = counted(lambda: step(state, batch))
        step_s.append(time.perf_counter() - t0)
        counts.append(c)
        colls.append(part.counts())
        losses.append(m["loss"].item())
        if i == 0:
            full = host_leaves(part.gather_tree(grads, sh.params))
            del grads
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = train_counts(cfg, 2 * 512, torch.float32)
    out = {"losses": losses, "launches": counts, "collectives": colls,
           "step_s": step_s, "peak_gib": peak}
    if rank == 0:
        rel = rel_errs(full, ref["grads"])
        dl = [abs(a - b) for a, b in zip(losses, ref["losses"])]
        out.update(grad_rel_max=max(rel), loss_diff=dl,
                   ref_losses=ref["losses"], ref_peak_gib=ref["peak_gib"],
                   ref_step_s=ref["step_s"])
        if dl[0] > TRAIN_LOSS_TOL * abs(ref["losses"][0]) or \
                max(rel) > TRAIN_GRAD_TOL:
            raise AssertionError(f"mesh-b: step-0 loss off by {dl[0]}, "
                                 f"gradients by {max(rel)}")
    if any(c != want for c in counts):
        raise AssertionError(f"mesh-b rank {rank}: launches {counts}, one "
                             f"device's at B=2 {want}")
    del state, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def world_pod2(rank, mesh_pod, smi):
    """(c) pod=2: the compressed step against the exact step from one
    state (qwen2-vl-2b at ``MESH_VL_LAYERS`` layers, B=2 x 512 a pod,
    ``MESH_STEPS`` steps, the last after one update), and the int32 sum
    of the pods' int8 payloads. JAX's own oracle's limits, where it
    applies them: the first step's loss within 1e-4, each leaf's max
    relative difference < 0.1 after the steps, the residual non-zero.
    The loss after the update is a reading: Adam's first update is
    lr sign(g) an element, and an element the int8 mean rounds to 0
    does not move, so the two steps' losses part by far more than
    1e-4 (JAX's scenario compares at ``lr_scale = 0``, where no
    parameter moves)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.optim import compression
    from repro_torch.train import step as tsl
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"),
                              n_layers=MESH_VL_LAYERS)
    batch = vl_train_inputs(cfg, 4, 0)
    out = {}
    for name, comp in (("exact", False), ("compressed", True)):
        tcfg = mesh_tcfg(compress_pods=comp)
        step = tsl.make_train_step(cfg, tcfg, mesh=mesh_pod)
        sh = tsl.state_shardings(cfg, tcfg, mesh_pod)
        state = tsl.shard_state(tsl.init_state(vl_params(cfg), tcfg), sh)
        losses, step_s = [], []
        part.reset_counts()
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
        out[name] = {"losses": losses, "step_s": step_s,
                     "collectives": part.counts(),
                     "params": host_leaves(state.params)}
        if comp:
            out[name]["residual_l1"] = sum(
                r.abs().sum().item() for r in tree_lib.leaves(state.residual))
        del state
        gc.collect()
        torch.cuda.empty_cache()
    rel = [((a - b).abs().max() / (a.abs().max() + 1e-9)).item()
           for a, b in zip(out["exact"]["params"],
                           out["compressed"]["params"])]
    dl = abs(out["exact"]["losses"][0] - out["compressed"]["losses"][0])
    out["updated_loss_diff"] = abs(out["exact"]["losses"][-1]
                                   - out["compressed"]["losses"][-1])
    g = torch.randn((4096, 1536), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        10 + rank))
    q, _ = compression._quantize(g)
    pods = mesh_pod.group(("pod",))
    total = compression.int8_sum(q, pods)
    every = torch.empty((2,) + tuple(q.shape), dtype=torch.int8,
                        device="cuda")
    part.all_gather(every.view(-1, q.shape[1]), q, pods)
    exact_sum = bool(torch.equal(total, every.to(torch.int32).sum(0)))
    for k in ("exact", "compressed"):
        del out[k]["params"]
    out.update(max_rel=max(rel), loss_diff=dl, int8_sum_exact=exact_sum)
    if not (dl < 1e-4 and max(rel) < 0.1
            and out["compressed"]["residual_l1"] > 0 and exact_sum):
        raise AssertionError(f"mesh-c rank {rank}: loss diff {dl}, max rel "
                             f"{max(rel)}, residual "
                             f"{out['compressed']['residual_l1']}, int32 sum "
                             f"exact {exact_sum}")
    return out


def world_moe(rank, mesh_model, smi):
    """(d) model=2: qwen2-moe-a2.7b at full width (60 experts padded to
    64, 32 a rank) and ``MESH_MOE_LAYERS`` layers, B=2 x 256 (a row a
    rank): one gradient pass of the train step, its forward's logits, aux
    loss and every layer's routing and its gradient blocks against one
    device's, which each rank computes first for itself (two full trees
    fit; none crosses the host); 2 all-to-alls a layer forward. The expert-parallel path takes its
    capacity per rank and one device per call (the JAX package's two
    paths), so they agree where nothing drops: the run raises the
    capacity factor to n_experts / top_k, where an expert takes every
    token (the dropping case is held against JAX's ``_apply_ep`` on the
    CPU)."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import lm, moe
    from repro_torch.train import step as tsl
    cfg = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(
        cfg, n_layers=MESH_MOE_LAYERS, dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k))
    tcfg = mesh_tcfg()
    t = MESH_MOE_SEQ
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, t), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    picks = []
    route = moe._route

    def recording(xf, w, cfg_, e):
        out = route(xf, w, cfg_, e)
        picks.append(out[1].detach())
        return out

    logits = []
    unembed = lm.unembed

    def stashing(*a, **k):
        out = unembed(*a, **k)
        logits.append(out.detach())
        return out

    def params():
        return lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda", dtype=torch.float32)
    # one gradient pass a side: its forward's logits, routing (the first
    # call of each layer; the recomputation routes again) and aux loss
    moe._route, lm.unembed = recording, stashing
    try:
        p = params()
        g, m = tsl._grads_and_metrics(p, batch, cfg, tcfg)
        ref = {"logits": logits[0][rank, :, :cfg.vocab].cpu(),
               "aux": m["aux_loss"].item(),
               "picks": torch.cat([x.reshape(2, t, -1)[rank].reshape(-1)
                                   for x in picks[:MESH_MOE_LAYERS]]).cpu()}
        ref_grads = host_leaves(g)
        del p, g
        logits.clear()
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        picks.clear()
        sh = tsl.state_shardings(cfg, tcfg, mesh_model)
        state = tsl.shard_state(tsl.init_state(params(), tcfg), sh)
        gc.collect()
        torch.cuda.empty_cache()
        step = tsl.make_train_step(cfg, tcfg, mesh=mesh_model)
        part.reset_counts()
        grads, m = step.grads_and_metrics(state, batch)
        a2a = part.counts()["all_to_all"]
        aux = m["aux_loss"]
        flips = int((torch.cat([x.reshape(-1) for x in
                                picks[:MESH_MOE_LAYERS]]).cpu()
                     != ref["picks"]).sum())
        scale = max(1.0, ref["logits"].abs().max().item())
        err = (logits[0][0, :, :cfg.vocab].cpu() - ref["logits"]).abs()\
            .max().item()
        # this rank's block of each one-device gradient leaf
        rel = rel_errs(host_leaves(grads), [
            part.shard_leaf(w, s) for w, s in
            zip(ref_grads, tree_lib.leaves(sh.params))])
        out = {"aux": aux.item(), "all_to_all_forward": a2a // 3,
               "all_to_all_pass": a2a,
               "logit_err": err, "logit_scale": scale,
               "aux_diff": abs(aux.item() - ref["aux"]), "flips": flips,
               "grad_rel_max": max(rel)}
        if err > LOGIT_TOL * scale or out["aux_diff"] > 1e-6 or flips \
                or max(rel) > TRAIN_GRAD_TOL:
            raise AssertionError(f"mesh-d rank {rank}: {out}")
        # 2 a layer forward, again in the recomputation, and 2 in the
        # backward (each all-to-all's gradient is one)
        if a2a != 6 * MESH_MOE_LAYERS:
            raise AssertionError(f"mesh-d rank {rank}: {a2a} all-to-alls a "
                                 f"gradient pass of {MESH_MOE_LAYERS} layers")
        del state, grads
    finally:
        moe._route, lm.unembed = route, unembed
        gc.collect()
        torch.cuda.empty_cache()
    return out


def world_decode(rank, mesh_model, smi):
    """(e) model=2 with the sequence-sharded rules: deepseek-7b at full
    width, ``MESH_DECODE_LAYERS`` layers, fp32, B=2: a prefill, then 16
    greedy steps with each rank holding half the cache's positions,
    against the unsharded decode of the same prefill on the rank."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import partitioning as part
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("deepseek-7b"),
                              n_layers=MESH_DECODE_LAYERS)
    b, s, n = MESH_DECODE
    params = lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab, (b, s), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(6))
    alloc = s + n

    def run(sharded):
        with torch.no_grad():
            lg, cache = lm.prefill(params, prompts, cfg, alloc=alloc)
            tok = lg.argmax(-1)
            ctx = (part.use_mesh(mesh_model, MESH_RULES) if sharded
                   else contextlib.nullcontext())
            with ctx:
                if sharded:
                    sh = part.tree_shardings(
                        mesh_model, lm.cache_logical_specs(cache, cfg),
                        like=cache)
                    cache = part.shard_tree(cache, sh)
                rows = cache[0]["0"]["kv"].k.shape[2]
                lengths = torch.full((b,), s, dtype=torch.int32,
                                     device="cuda")
                part.reset_counts()
                logits, toks = [], [tok]
                for _ in range(n - 1):
                    lg, cache = lm.decode_step(params, cache, tok[:, None],
                                               lengths, cfg)
                    tok = lg.argmax(-1)
                    logits.append(lg.cpu())
                    toks.append(tok)
                    lengths = lengths + 1
        return (torch.stack(logits, 1), torch.stack(toks, 1).cpu(), rows,
                part.counts())
    ref_lg, ref_toks, ref_rows, _ = run(False)
    lg, toks, rows, coll = run(True)
    scale = max(1.0, ref_lg.abs().max().item())
    err = (lg - ref_lg).abs().max().item()
    out = {"logit_err": err, "scale": scale, "same_stream":
           bool(torch.equal(toks, ref_toks)), "cache_rows": rows,
           "alloc": alloc, "collectives": coll}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if err > LOGIT_TOL * scale or not out["same_stream"] or \
            rows != alloc // 2 or coll["all_gather"]:
        raise AssertionError(f"mesh-e rank {rank}: {out}")
    return out


def mesh_rank(rank, init):
    """One rank of the mesh phase's world of two processes on the one
    card (gloo: NCCL refuses two ranks on one device): runs (b)-(e), each
    on a mesh of its own, and writes its results to ``MESH_DIR``."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.core import partitioning as part
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.library()
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    smi = ""
    meshes = {a: part.Mesh((2,), (a,)) for a in ("data", "pod", "model")}
    out = {}
    for key, fn, axis in (("data2", world_data2, "data"),
                          ("pod2", world_pod2, "pod"),
                          ("moe", world_moe, "model"),
                          ("decode", world_decode, "model")):
        t0 = time.perf_counter()
        part.staged.launches = 0
        out[key] = fn(rank, meshes[axis], smi)
        out[key]["seconds"] = time.perf_counter() - t0
        out[key]["staged"] = part.staged.launches
        dist.barrier()
    dist.barrier()                   # no rank leaves while one still sends
    dist.destroy_process_group()
    torch.save(out, MESH_DIR / f"rank{rank}.pt")


def mesh_world():
    """The two ranks of :func:`mesh_rank` under ``MESH_TIMEOUT_S``: a rank
    that fails or hangs fails the phase (every rank is then stopped).
    Rank 0 prints to this output, rank 1 to
    ``chiprun_out/mesh_rank1.log``."""
    import torch
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    log = open(ROOT / "chiprun_out" / "mesh_rank1.log", "w")
    init = f"tcp://localhost:{free_port()}"
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import chip_smoke "
            "as c; c.mesh_rank({}, {!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(str(ROOT), str(ROOT / "src"), i,
                                           init)],
        cwd=ROOT, stdout=None if i == 0 else log,
        stderr=None if i == 0 else subprocess.STDOUT) for i in range(2)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"mesh: the ranks exited {codes} (rank 1's "
                             "log: chiprun_out/mesh_rank1.log)")
    return [torch.load(MESH_DIR / f"rank{i}.pt") for i in range(2)]


def mesh_cli(smi):
    """(f) ``launch/train.py --mesh host --smoke`` (eight ranks over gloo on
    the one card, spawned by the CLI) for 4 steps with a checkpoint every
    2, against the same CLI on one device (the printed losses equal);
    then ``--mesh none`` from the mesh's checkpoint of step 2 (the
    elastic restore: it resumes at step 2 and ends on the one device's
    last loss); then ``--mesh host --compress-pods`` for 2 steps. Each
    ``main`` runs in this process (the mesh's ranks in their own)."""
    import contextlib
    import gc
    import io
    import re
    import shutil

    import torch
    from repro_torch.launch import train as train_cli
    base = ["--arch", "deepseek-7b", "--smoke", "--steps", "4", "--batch",
            "8", "--seq", "64", "--device", "cuda"]
    mesh_args = ["--mesh", "host", "--dist-backend", "gloo",
                 "--dist-timeout", str(MESH_TIMEOUT_S)]
    d = MESH_DIR / "cli_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    outs, secs = {}, {}
    runs = (("one device", []),
            ("mesh host", mesh_args + ["--ckpt-dir", str(d),
                                       "--ckpt-every", "2"]),
            ("elastic --mesh none", ["--ckpt-dir", str(d)]),
            ("mesh host --compress-pods", mesh_args + ["--compress-pods",
                                                       "--steps", "2"]))
    for label, extra in runs:
        if label.startswith("elastic"):
            shutil.rmtree(d / "step_00000004")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_cli.main(base + extra)
        secs[label] = time.perf_counter() - t0
        outs[label] = buf.getvalue()
        say("mesh-cli", f"{label} in {secs[label]:.1f} s: " + " | ".join(
            ln.strip() for ln in outs[label].splitlines()
            if ln.startswith(("step", "resumed", "arch"))))
        gc.collect()
        torch.cuda.empty_cache()
    losses = {k: re.findall(r"step (\d+): loss=([\d.]+)", v)
              for k, v in outs.items()}
    shutil.rmtree(d, ignore_errors=True)
    if (losses["mesh host"] != losses["one device"]
            or "resumed from step 2" not in outs["elastic --mesh none"]
            or losses["elastic --mesh none"][-1] != losses["one device"][-1]
            or len(losses["mesh host --compress-pods"]) != 2):
        raise AssertionError(f"mesh-cli: losses {losses}")
    return {"losses": losses, "seconds": secs}


def mesh_phase(smi):
    """The training mesh (``core/partitioning.py``, ``train/step.py``,
    ``optim/compression.py``, ``models/moe.py::_apply_ep``, the
    sequence-sharded decode, the elastic checkpoint, ``launch/train.py
    --mesh``): (a) world 1 on NCCL in this process, (b)-(e) a world of
    two processes on the one card over gloo (staged through the host: no
    mesh speed), (f) the train CLI's mesh."""
    import gc

    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"a": mesh_world1(smi)}
    t_world = time.perf_counter()
    ranks = mesh_world()
    out["world_s"] = time.perf_counter() - t_world
    out["ranks"] = ranks
    r0, r1 = ranks
    b = r0["data2"]
    say("mesh-b", f"qwen2-vl-2b/{MESH_VL_LAYERS} fp32, data=2, B=2 x 512 a "
        f"rank: step-0 loss {b['losses'][0]:.7f} against one device's "
        f"{b['ref_losses'][0]:.7f} (tol {TRAIN_LOSS_TOL}*|loss|); step-0 "
        f"gradients gathered leaf by leaf: worst relative error "
        f"{b['grad_rel_max']:.3g} (tol {TRAIN_GRAD_TOL}); losses "
        f"{b['losses']} (one device {b['ref_losses']}); launches a step "
        f"{b['launches'][0]} on each rank (one device's at B=2); "
        f"collectives a step {b['collectives'][0]}, {b['staged']} staged "
        f"through the host in the run; a step {min(b['step_s']):.2f} / "
        f"{min(r1['data2']['step_s']):.2f} s (gloo, host-staged: no mesh "
        f"speed); peak {b['peak_gib']:.2f} / {r1['data2']['peak_gib']:.2f} "
        f"GiB a rank against one device's {b['ref_peak_gib']:.2f} at B=4 "
        f"| {smi}")
    c = r0["pod2"]
    say("mesh-c", f"qwen2-vl-2b/{MESH_VL_LAYERS} fp32, pod=2, {MESH_STEPS} "
        f"steps: compressed against exact: first loss diff "
        f"{c['loss_diff']:.3g} (tol 1e-4), the loss after one update "
        f"{c['compressed']['losses'][-1]:.6f} against "
        f"{c['exact']['losses'][-1]:.6f} (a reading), worst leaf's max "
        f"relative difference "
        f"{c['max_rel']:.3g} (tol 0.1), residual l1 "
        f"{c['compressed']['residual_l1']:.4g}; the int32 sum equal to the "
        f"pods' int8 payloads summed: {c['int8_sum_exact']}; a step exact "
        f"{min(c['exact']['step_s']):.2f} s, compressed "
        f"{min(c['compressed']['step_s']):.2f} s (host-staged) | {smi}")
    d = r0["moe"]
    say("mesh-d", f"qwen2-moe-a2.7b/{MESH_MOE_LAYERS} fp32, model=2 (32 of "
        f"64 experts a rank), B=2 x {MESH_MOE_SEQ}: logits "
        f"{d['logit_err']:.3g} off one device's (tol {LOGIT_TOL}*"
        f"{d['logit_scale']:.3g}), aux {d['aux_diff']:.3g} off (tol 1e-6), "
        f"routing flips {d['flips']}, step-0 gradients worst relative "
        f"{d['grad_rel_max']:.3g} (tol {TRAIN_GRAD_TOL}); all-to-alls a "
        f"forward {d['all_to_all_forward']}, a gradient pass "
        f"{d['all_to_all_pass']} (forward, recomputation, backward) | "
        f"{smi}")
    e = r0["decode"]
    say("mesh-e", f"deepseek-7b/{MESH_DECODE_LAYERS} fp32, model=2, "
        f"sequence-sharded decode B={MESH_DECODE[0]}, prompt "
        f"{MESH_DECODE[1]} + {MESH_DECODE[2]} steps: logits "
        f"{e['logit_err']:.3g} / {r1['decode']['logit_err']:.3g} off the "
        f"unsharded decode (tol {LOGIT_TOL}*{e['scale']:.3g}), the same "
        f"greedy stream: {e['same_stream']}; each rank's cache holds "
        f"{e['cache_rows']} of {e['alloc']} rows; collectives "
        f"{e['collectives']} | {smi}")
    for key in ("data2", "pod2", "moe", "decode"):
        say("mesh", f"run {key}: {r0[key]['seconds']:.1f} s, "
                    f"{r0[key]['staged']} collectives staged through the "
                    "host")
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = mesh_cli(smi)
    out["seconds"] = time.perf_counter() - t_phase
    say("mesh", f"phase took {out['seconds']:.1f} s (the world of two "
                f"{out['world_s']:.1f} s)")
    return out


# ------------------------------ the auditor ------------------------------

# the roofline's prices of two calls, PERF.md section 6: the 120
# persistent launches of a deepseek-7b bf16 prefill at B=4 x 512 (row 1b,
# the operations bound) and the 121 skinny launches of its bf16 decode
# step at B=4 (row 1c, the bytes bound), both from chip_smoke.py's cases
AUDIT_BOUNDS = {"prefill": ("rowwise_matmul persistent", 120, 25.14),
                "decode": ("rowwise_matmul skinny", 121, 3.88)}
AUDIT_BOUND_TOL = 0.005
# the 120 persistent launches of a deepseek-7b bf16 prefill (B=4 x 512),
# as the audit phase prices them (PERF.md section 6)
TOOLING_PREFILL_MS = 25.1444
# seconds a process of the tooling phase (a dry-run cell, an example)
# may take
TOOLING_CLI_S = 300
AUDIT_ENTRIES = ["step", "prefill", "chunk", "spec"]


def audit_phase(smi):
    """The auditor and the cost models on the card: (a) the audit CLI
    (``python -m repro_torch.analysis.audit --device cuda``) exits 0, each
    pass checked something, the recorder's host reads in each entry point
    and the sync debug mode's agree at 0, and the engine's fetch sites
    are the allowlist's; (b) every built kernel's shared memory against
    its model and the H100's budget, no spill, and a seeded over-budget
    kernel fires RWA401; (c) the roofline from the launch records of one
    deepseek-7b bf16 prefill (B=4 x 512) and decode step (B=4) against
    PERF.md's bounds, each kernel's share of its bound beside its device
    ms; (d) ``plan_matmul``'s tile constants against the library's; (e)
    a deepseek-7b bf16 engine run with the recording switch off and on:
    the same streams, the same launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import audit as audit_cli
    from repro_torch.analysis import dispatch, donation, smem, sync
    from repro_torch.configs import get_config
    from repro_torch.core.types import PagingConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import roofline
    from repro_torch.launch.profile import profile_call
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    t0 = time.perf_counter()
    out = {}
    # (a) the CLI, in a process of its own
    path = ROOT / "chiprun_out" / "audit.json"
    path.parent.mkdir(exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--arch",
         "deepseek-7b", "--device", "cuda", "--json", str(path)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    for line in proc.stdout.splitlines():
        say("audit-a", line)
    if proc.returncode:
        raise AssertionError(f"the audit CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    rep = json.loads(path.read_text())
    checked = {p["pass"]: p["checked"] for p in rep["passes"]}
    reads = {e["name"]: (e["host_reads"], e["debug_syncs"])
             for e in rep["entries"]}
    sites = sync.site_counts((ROOT / "src" / "repro_torch" / "serve" /
                              "engine.py").read_text())
    fetch = {f: n for f, (n, _) in sites.items() if n}
    say("audit-a", f"checked by pass {checked}; host reads by entry point "
                   f"(recorder, sync debug mode) {reads}; Engine._fetch "
                   f"sites {fetch}, the allowlist "
                   f"{audit_cli.ENGINE_FETCH_ALLOW}")
    if set(checked) != set(audit_cli.PASSES) or min(checked.values()) <= 0:
        raise AssertionError(f"a pass checked nothing: {checked}")
    if list(reads) != AUDIT_ENTRIES or any(
            v != (0, 0) for v in reads.values()):
        raise AssertionError(f"host reads in the entry points: {reads}")
    if fetch != audit_cli.ENGINE_FETCH_ALLOW:
        raise AssertionError(f"fetch sites {fetch}")
    out["a"] = {"checked": checked, "reads": reads, "fetch_sites": fetch,
                "entries": rep["entries"]}

    # (b) the build's shared memory and registers; (d) the constants
    lib = _build.library()
    ptxas = smem.parse_ptxas((_build.BUILD_DIR / "ptxas.log").read_text())
    built = smem.query_library(lib)
    models = {m.name: m for m in smem.kernel_models()}
    for b in built:
        m = models.get(b.name)
        say("audit-b", f"{b.name}: dynamic {b.dynamic} B (modeled "
                       f"{m.dynamic if m else None}), static {b.static} B "
                       f"(modeled {m.static if m else None}), "
                       f"{b.static + b.dynamic} of {smem.BUDGET} B; "
                       f"{b.registers} registers x {b.threads} threads x "
                       f"{b.min_blocks} blocks = "
                       f"{b.registers * b.threads * b.min_blocks} of 65536;"
                       f" local {b.local_bytes} B")
    res = smem.audit_build(built, ptxas)
    consts = smem.library_constants(lib)
    res_d = smem.check_constants(consts)
    seeded = smem.audit_models([dataclasses.replace(
        models["rowwise_matmul_kernel_wgmma<bf16,false>"],
        dynamic=smem.BUDGET + 1)])
    for d in res.diagnostics + res_d.diagnostics:
        say("audit-b", f"{d} [{d.severity}]")
    say("audit-b", f"{len(built)} kernels queried, "
                   f"{sum(e.entry for e in ptxas)} in ptxas.log, "
                   f"{len(smem.spills(ptxas))} spilling; {res.summary()}; "
                   f"seeded over-budget kernel: "
                   f"{[d.code for d in seeded.diagnostics]}")
    say("audit-d", f"library constants {consts}; {res_d.summary()}")
    if not res.ok or not res_d.ok or \
            [d.code for d in seeded.diagnostics] != ["RWA401"]:
        raise AssertionError("the smem pass failed on the build")
    out["b"] = {"kernels": [dataclasses.asdict(b) for b in built],
                "warnings": [str(d) for d in res.diagnostics]}
    out["d"] = consts

    # (c) the roofline of deepseek-7b bf16 at full width and depth
    cfg = get_config("deepseek-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_lm(cfg, gen, device="cuda", dtype=torch.bfloat16)
    b, seq = 4, 512
    tokens = torch.randint(0, cfg.vocab, (b, seq), generator=gen,
                           device="cuda")
    lengths = torch.full((b,), seq, dtype=torch.int32, device="cuda")

    def prefill():
        return lm.prefill(params, tokens, cfg, alloc=seq + 1)
    with torch.no_grad():
        with roofline.recording() as pre:
            _, cache = prefill()
        with roofline.recording() as dec:
            lm.decode_step(params, cache, tokens[:, -1:], lengths, cfg)
    calls = {"prefill": (pre, lambda: prefill(), b * seq),
             "decode": (dec, lambda: lm.decode_step(
                 params, cache, tokens[:, -1:], lengths, cfg), b)}
    out["c"] = {}
    for what, (recs, fn, items) in calls.items():
        report = roofline.report(recs, arch=cfg.name,
                                 shape=f"{what} B={b} bf16")
        by = report.by_kernel()
        prof = profile_call(fn, items)
        key, launches_, want = AUDIT_BOUNDS[what]
        got = by.get(key, {})
        for k, e in sorted(by.items()):
            dev_ms = prof["designs_ms"].get(k)
            share = e["bound_ms"] / dev_ms if dev_ms else None
            say("audit-c", f"{what} {k}: {e['launches']} launches, bound "
                           f"{e['bound_ms']:.4f} ms ({e['bound_by']}), "
                           f"device {dev_ms if dev_ms is None else round(dev_ms, 4)}"
                           f" ms, share "
                           f"{'n/a' if share is None else f'{share:.1%}'}"
                           f" | {smi}")
        say("audit-c", f"{what}: {key} {got.get('launches')} launches price "
                       f"to {got.get('bound_ms', 0):.4f} ms against "
                       f"{want} ms (PERF.md section 6), call bound "
                       f"{report.bound_ms:.4f} ms, wall "
                       f"{prof['wall_ms']:.3f} ms")
        out["c"][what] = {"by_kernel": by, "bound_ms": report.bound_ms,
                          "profile": {k: prof[k] for k in (
                              "wall_ms", "device_busy_ms", "designs_ms",
                              "own_kernels_ms")}}
        if got.get("launches") != launches_ or \
                abs(got["bound_ms"] - want) > AUDIT_BOUND_TOL * want:
            raise AssertionError(f"the roofline prices the {what}'s {key} "
                                 f"at {got}, want {launches_} launches and "
                                 f"{want} ms within {AUDIT_BOUND_TOL:.1%}")
    del cache

    # (e) an engine run with the recording switch off (the trace's
    # counters under a CUDA profiler session alone) and on
    def serve(record):
        eng = Engine(params, cfg, n_slots=2, max_len=96, eos_id=-1,
                     paging=PagingConfig(page_size=16, prefill_chunk=32),
                     device="cuda")
        rng = np.random.default_rng(0)
        for i, plen in enumerate((20, 45, 9)):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, plen).astype(np.int32), max_new=6))
        ctx = (roofline.recording() if record else profile(
            activities=[ProfilerActivity.CUDA]))
        with ctx as recs:
            before = launches()
            done = eng.run()
            counts = {k: n - before[k] for k, n in launches().items()}
        recs = recs if record else []
        return ({c.rid: list(c.tokens) for c in done}, counts,
                sum(r["launched"] for r in recs))
    off, on = serve(False), serve(True)
    say("audit-e", f"streams off {off[0]}, on {on[0]}; launches off "
                   f"{off[1]}, on {on[1]}; {on[2]} launch records")
    if off[:2] != on[:2] or on[2] != sum(on[1].values()):
        raise AssertionError("recording changed the engine's run")
    out["e"] = {"streams": off[0], "launches": off[1], "records": on[2]}
    # the entry points at full width: no host read (recorder and sync
    # debug mode), every cache leaf in place, and a decode step's peak
    # memory held under one pool leaf
    eng = Engine(params, cfg, n_slots=2, max_len=96, eos_id=-1,
                 paging=PagingConfig(page_size=16, prefill_chunk=32,
                                     speculate_k=2), device="cuda")
    runs = dispatch.run_entry_points(eng)
    step = next(r for r in runs if r.name == "step")
    leaf = min(x.nbytes for x in step.before if len(x.shape) == 5)
    res = sync.audit_entry_points(runs).merge(donation.audit_runs(runs))
    res.merge(donation.peak_check(step.peak_growth, leaf))
    for r in runs:
        say("audit-e", f"full width, entry {r.name}: "
                       f"{len(r.recorder.host_reads)} host reads recorded, "
                       f"sync debug mode {r.debug_syncs}, peak memory "
                       f"+{r.peak_growth:,} B, largest allocation "
                       f"{r.recorder.largest[1]:,} B ({r.recorder.largest[0]})"
                       f"; a pool leaf {leaf:,} B")
    for d in res.diagnostics:
        say("audit-e", str(d))
    if not res.ok:
        raise AssertionError("the entry points at full width failed the "
                             "sync or donation pass")
    out["e"]["full_width"] = {r.name: {
        "host_reads": len(r.recorder.host_reads),
        "debug_syncs": r.debug_syncs, "peak_growth": r.peak_growth,
        "largest": r.recorder.largest[1]} for r in runs}
    out["e"]["pool_leaf_bytes"] = leaf
    del params, eng, runs, step
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    say("audit", f"phase {out['seconds']:.1f} s | {smi}")
    return out


# the tooling phase's calls: (arch, batch, seq) of each bf16 prefill the
# op walk prices on the card, its cases' key in phase 3, its launches
TOOLING_CALLS = (("deepseek-7b", 4, 512, "dprefill", "deepseek-7b prefill"),
                 ("qwen2-moe-a2.7b", 4, 256, "qprefill",
                  "qwen2-moe-a2.7b prefill"))
# the dry-run cells the phase runs through the CLI, and what each JSON
# holds
TOOLING_CELLS = (("deepseek-7b", "train_4k", "multipod"),
                 ("gemma3-27b", "decode_32k", "pod"))
DRYRUN_KEYS = ("flops_per_device", "bytes_per_device",
               "coll_bytes_per_device", "model_flops", "compute_t",
               "memory_t", "memory_t_fused", "collective_t", "bound",
               "step_time", "step_time_unfused", "mfu", "mfu_unfused",
               "useful_flops_ratio", "memory_analysis",
               "live_bytes_per_device", "fits_hbm_80g",
               "launches_by_kernel", "collectives", "params_total",
               "params_active", "rules", "seconds", "schedule",
               "call_bound_ms")


def tooling_phase(smi):
    """The dry run and the op-level cost walk on the card: (a) each
    ``TOOLING_CALLS`` prefill walked by ``launch/op_cost.py`` with its
    kernels launched (counts reset just before, read just after), its
    dry walk on ``meta`` (the same FLOPs, exactly), its roofline
    (``roofline.analyze``: kernels and glue) beside the profiler's busy
    and "other" device ms; (b) the dry-run CLI's ``TOOLING_CELLS``; (c)
    two of the port's examples on the card. The examples and the CLI run
    in processes of their own; the CLI's cells run on the CPU (a fake
    world on meta tensors) beside (a)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost, roofline
    from repro_torch.launch.profile import profile_call
    from repro_torch.models import lm

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    # (b) started first: it needs no card
    cli = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out",
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env)) for cell in TOOLING_CELLS]
    out = {"a": {}}
    try:
        # (a) the op walk on the card beside the profiler
        for arch, b, seq, key, literal in TOOLING_CALLS:
            cfg = get_config(arch)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = lm.init_lm(cfg, gen, device="cuda",
                                dtype=torch.bfloat16)
            tokens = torch.randint(0, cfg.vocab, (b, seq), generator=gen,
                                   device="cuda")

            def prefill():
                return lm.prefill(params, tokens, cfg, alloc=seq + 1)
            with torch.no_grad():
                prefill()                           # the first launches
                (res, cost), counts = counted(lambda: op_cost.walk(prefill))
                del res
            mparams = lm.init_lm(cfg, None, device="meta",
                                 dtype=torch.bfloat16)
            with torch.no_grad():
                _, dry = op_cost.walk(
                    lm.prefill, mparams, tokens.to("meta"), cfg,
                    alloc=seq + 1)
            rep = roofline.analyze(cost, arch=arch, shape=f"prefill B={b} "
                                   f"x {seq} bf16", dtype=torch.bfloat16)
            prof = profile_call(prefill, b * seq)
            by = rep.by_kernel()
            launched = sum(r["launched"] for r in cost.records)
            busy, other = prof["device_busy_ms"], prof["other_device_ms"]
            rec = {
                "counts": counts, "launched_records": launched,
                "flops": cost.flops, "dry_flops": dry.flops,
                "kernel_bound_ms": rep.bound_ms, "glue_bound_ms": cost.glue_ms,
                "call_bound_ms": rep.call_bound_ms,
                "busy_ms": busy, "other_ms": other,
                "wall_ms": prof["wall_ms"], "glue_ops": cost.glue_ops,
                "glue_bytes": cost.glue_bytes,
                "dry_glue_bound_ms": dry.glue_ms,
                "by_kernel": by, "roofline": rep.to_dict(),
                "top_glue": sorted(
                    ([op, v[0], v[1], v[2]] for op, v in cost.by_op.items()
                     if op.startswith("aten.")), key=lambda r: -r[1])[:8]}
            out["a"][arch] = rec
            say("tooling-a", f"{arch} bf16 prefill B={b} x {seq}: bound of "
                             f"the whole call {rep.call_bound_ms:.4f} ms "
                             f"(kernels {rep.bound_ms:.4f}, glue "
                             f"{cost.glue_ms:.4f} over {cost.glue_ops} ops)"
                             f" beside {busy:.3f} busy ms (share "
                             f"{rep.call_bound_ms / busy:.1%}); the glue's "
                             f"bound {cost.glue_ms:.4f} ms beside "
                             f"{other:.3f} other device ms (share "
                             f"{cost.glue_ms / other:.1%}); FLOPs card "
                             f"{cost.flops:.6g}, dry walk on meta "
                             f"{dry.flops:.6g}; launches {counts}; wall "
                             f"{prof['wall_ms']:.3f} ms | {smi}")
            for k, e in sorted(by.items()):
                say("tooling-a", f"{arch} {k}: {e['launches']} launches, "
                                 f"bound {e['bound_ms']:.4f} ms "
                                 f"({e['bound_by']}), device "
                                 f"{prof['designs_ms'].get(k, 0):.4f} ms")
            for op, nbytes, fl, n in rec["top_glue"]:
                say("tooling-a", f"{arch} glue {op}: {n} calls, "
                                 f"{nbytes / 1e9:.4f} GB, {fl:.4g} FLOPs")
            want = dict(zip(KERNELS, LAUNCHES[literal]))
            if counts != want or launched != sum(counts.values()) or \
                    len(cost.records) != launched:
                raise AssertionError(f"tooling-a {arch}: launches {counts} "
                                     f"({launched} launched records of "
                                     f"{len(cost.records)}), want {want}")
            if cost.flops != dry.flops:
                raise AssertionError(f"tooling-a {arch}: the card walk's "
                                     f"FLOPs {cost.flops} differ from the "
                                     f"dry walk's {dry.flops}")
            if arch == "deepseek-7b":
                key_, n_, ms_ = AUDIT_BOUNDS["prefill"]
                got = by.get(key_, {})
                if got.get("launches") != n_ or abs(
                        got["bound_ms"] - TOOLING_PREFILL_MS) > \
                        AUDIT_BOUND_TOL * TOOLING_PREFILL_MS:
                    raise AssertionError(f"tooling-a: {key_} priced {got}, "
                                         f"want {n_} launches at "
                                         f"{TOOLING_PREFILL_MS} ms")
            del params, mparams, tokens, cost, dry
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        logs = {}
        for cell, proc in cli:
            try:
                logs[cell] = proc.communicate(timeout=TOOLING_CLI_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                logs[cell] = proc.communicate()
    # (b) the dry-run cells, and the card's memory their fits_hbm_80g
    # takes
    from repro_torch.launch import dryrun
    total = torch.cuda.get_device_properties(0).total_memory
    say("tooling-b", f"the card's memory {total} bytes (total_memory), "
                     f"the dry run's HBM_BYTES {dryrun.HBM_BYTES} | {smi}")
    if abs(total - dryrun.HBM_BYTES) > 0.01 * total:
        raise AssertionError(f"the dry run's HBM_BYTES {dryrun.HBM_BYTES} "
                             f"is not the card's {total} within 1%")
    out["b"] = {"card_memory_bytes": total}
    for cell, proc in cli:
        stdout, stderr = logs[cell]
        for line in stdout.splitlines():
            say("tooling-b", line)
        if proc.returncode:
            raise AssertionError(f"the dry-run CLI on {cell} exited "
                                 f"{proc.returncode}: {stderr[-3000:]}")
        rec = json.loads((out_dir / "__".join(cell)).with_suffix(
            ".json").read_text())
        missing = [k for k in DRYRUN_KEYS if k not in rec]
        if missing or not rec.get("ok"):
            raise AssertionError(f"the dry run's {cell} JSON lacks "
                                 f"{missing} or is not ok")
        out["b"]["__".join(cell)] = {
            k: rec[k] for k in ("seconds", "call_bound_ms", "bound",
                                "live_bytes_per_device", "fits_hbm_80g",
                                "collectives", "memory_analysis")}
    # (c) the examples on the card, both at once
    out["c"] = {}
    examples = [(name, subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device",
         "cuda"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env)) for name in ("torch_quickstart",
                                         "torch_vit_rowwise")]
    for name, proc in examples:
        try:
            stdout, stderr = proc.communicate(timeout=TOOLING_CLI_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        for line in stdout.splitlines():
            say("tooling-c", f"{name}: {line}")
        if proc.returncode:
            raise AssertionError(f"examples/{name}.py exited "
                                 f"{proc.returncode}: {stderr[-3000:]}")
        out["c"][name] = stdout.splitlines()
    out["seconds"] = time.perf_counter() - t0
    say("tooling", f"phase {out['seconds']:.1f} s | {smi}")
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

    from repro_torch.launch.roofline import PEAK_BYTES, PEAK_FLOPS
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


def with_cases(counts):
    """A run's launches of the kernels that have per-call cases (every
    one but the SSD scan, whose calls its ``ssd`` lines time)."""
    return {k: counts[k] for k in REPLACES}


def check_listed(tabs, key, counts):
    """The launches the ``key`` cases of an LM table list, per dtype,
    against the model's run ``counts`` ({"fp32": ..., "bf16": ...})."""
    for dt in ("fp32", "bf16"):
        listed = {name: tabs.get(f"{key} {dt} {name}", {}).get(
            "launches", 0) for name in REPLACES}
        # the bf16 RWKV6 model runs WKV in fp32: no bf16 wkv cases
        if dt == "bf16" and key in ("prefill", "decode"):
            listed["wkv"] = counts[dt]["wkv"]
        if listed != with_cases(counts[dt]):
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
    path of :data:`COUNTS` (``fused`` / ``unfused``: a Swin-T forward at
    B=8, ``fused64``: its attention at B=64, ``vit``: a ViT-B/16 forward
    at B=8, ``prefill`` / ``decode``: an RWKV6-3B prefill at B=4 x 512 /
    decode step at B=4, ``dprefill`` / ``ddecode`` / ``dunfused``: the
    same of deepseek-7b and its unfused prefill, and the gemma3-27b,
    whisper-base, zamba2-1.2b and MoE paths; the int8 cases over their
    Swin-T shapes, as the int8 path runs them):
    launches and event / plain / library ms and the bound, each case
    times its launches."""
    out = {}
    for key in COUNTS:
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

    from repro_torch.analysis import smem
    from repro_torch.configs import get_config
    from repro_torch.configs.swin_t import CONFIG, VIT_CONFIG
    from repro_torch.core import runtime
    from repro_torch.kernels import _build
    from repro_torch.models.vision import SwinTransformer, VisionTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    def clock(done):
        say("clock", f"{done} done at {time.perf_counter() - t_start:.1f} s")

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
    ptxas = smem.parse_ptxas((_build.BUILD_DIR / "ptxas.log").read_text())
    spills = smem.spills(ptxas)
    regs = [e.registers for e in ptxas if e.entry]
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
    if not all(mma[k] for k in mma if "wgmma" in k or "persistent" in k):
        build_faults.append("a wgmma or persistent kernel holds no "
                            "tensor-core instruction")
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
    zamba2_cfg, qwen_cfg = get_config("zamba2-1.2b"), get_config(
        "qwen2-moe-a2.7b")
    phi_cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                                  n_layers=PHI_LAYERS)
    vl_cfg = get_config("qwen2-vl-2b")
    for dt, name, tol in ((torch.float32, "fp32", FP32_TOL),
                          (torch.bfloat16, "bf16", BF16_TOL)):
        rows += run_cases(gemma_cases(gemma_cfg, dt, gen, dev), name, tol)
        rows += run_cases(whisper_cases(whisper_cfg, dt, gen, dev), name,
                          tol)
        rows += run_cases(zamba2_cases(zamba2_cfg, dt, gen, dev), name, tol)
        rows += run_cases(moe_cases(qwen_cfg, dt, gen, dev,
                                    ("qprefill", "qdecode")), name, tol)
        rows += run_cases(moe_cases(phi_cfg, dt, gen, dev,
                                    ("pprefill", "pdecode")), name, tol)
        rows += run_cases(vl_cases(vl_cfg, dt, gen, dev), name, tol)
        # one tensor-parallel rank's calls: deepseek-7b at t = 2 (run
        # below) and t = 4 (its new shapes: down at K = 2752 = 43 x 64),
        # gemma3-27b at 12 layers and t = 2
        rows += run_cases(
            tp_cases(dense_cfg, 2, (4, 512), dt, gen, dev,
                     ("tprefill", "tdecode"))
            + tp_cases(dataclasses.replace(gemma_cfg,
                                           n_layers=TP_GEMMA_LAYERS),
                       2, (2, 2048), dt, gen, dev,
                       ("tgprefill", "tgdecode")), name, tol)
        # t = 4 is not run on the one card: its shapes are checked, not
        # timed
        rows += run_cases(tp_cases(dense_cfg, 4, (4, 512), dt, gen, dev,
                                   ("t4prefill", "t4decode")), name, tol,
                          timed=False)
        if dt == torch.float32:
            # one rank's train step on the training mesh at data=2
            rows += run_cases(mesh_cases(vl_cfg, dt, gen, dev), name, tol)
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

    clock("phase 3")
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
             "wkv": 0, "ssd": 0},
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
                          2 * VIT_CONFIG.depth), "wkv": 0, "ssd": 0}),
                  LOGIT_TOL)

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
                       "layernorm": 25, "wkv": 0, "ssd": 0}, BF16_TOL)
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

    clock("phases 4-7")
    # 8. RWKV6-3B at full width and depth
    rwkv = rwkv_phase(smi)
    tables = lm_tables(rows, ("prefill", "decode"), "rwkv-table")

    clock("phase 8")
    # 9. deepseek-7b at full width and depth
    dense = dense_phase(smi)
    dense_tables = lm_tables(rows, ("dprefill", "ddecode", "dunfused"),
                             "dense-table")

    clock("phase 9")
    # 10. gemma3-27b (8 layers in fp32, 32 in bf16) and whisper-base
    gemma = gemma_phase(smi)
    gemma_tables = lm_tables(rows, ("gprefill", "gdecode"), "gemma-table")
    whisper = whisper_phase(smi)
    whisper_tables = lm_tables(rows, ("wprefill", "wdecode"),
                               "whisper-table")

    clock("phase 10")
    # 11. zamba2-1.2b, qwen2-moe-a2.7b and phi3.5-moe (8 layers)
    zamba2 = zamba2_phase(smi)
    zamba2_tables = lm_tables(rows, ("zprefill", "zdecode"), "zamba2-table")
    qwen = moe_phase(smi, "qwen2-moe-a2.7b")
    phi = moe_phase(smi, "phi3.5-moe-42b-a6.6b", PHI_LAYERS)
    moe_tables = lm_tables(rows, ("qprefill", "qdecode", "pprefill",
                                  "pdecode"), "moe-table")

    clock("phase 11")
    # 12. qwen2-vl-2b served; 13. the kernels' gradients; 14. qwen2-vl-2b
    # trained at full depth, then preempted and resumed at 2 layers
    vl = vl_phase(smi)
    vl_tables = lm_tables(rows, ("vprefill", "vdecode", "vtrain"),
                          "vl-table")
    grads = grads_phase()
    train = train_phase(smi)
    resume = resume_phase()

    clock("phases 12-14")
    # 15. tensor-parallel serving: one device, t = 1 on NCCL, t = 2 as
    # two processes over gloo, the CLI at model=2
    tp = tp_phase(smi)
    tp_tables = lm_tables(rows, ("tprefill", "tdecode", "t4prefill",
                                 "t4decode", "tgprefill", "tgdecode"),
                          "tp-table")

    clock("phase 15")
    # 16. the training mesh: world 1 on NCCL, a world of two processes
    # over gloo (data=2, pod=2 compressed, model=2 expert parallel and
    # sequence-sharded decode), the train CLI's mesh of eight
    mesh = mesh_phase(smi)
    mesh_tables = lm_tables(rows, ("mtrain",), "mesh-table")
    listed = {name: mesh_tables.get(f"mtrain fp32 {name}", {}).get(
        "launches", 0) for name in REPLACES}
    for rank in mesh["ranks"]:
        if listed != with_cases(rank["data2"]["launches"][0]):
            raise AssertionError(f"the mtrain cases list {listed} launches, "
                                 f"a rank's step ran "
                                 f"{rank['data2']['launches'][0]}")

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
                                             "decode_counts")),
            (zamba2_tables, "zprefill", both(zamba2, "b4")),
            (zamba2_tables, "zdecode", both(zamba2, "b4", "decode_counts")),
            (moe_tables, "qprefill", both(qwen, "b4")),
            (moe_tables, "qdecode", both(qwen, "b4", "decode_counts")),
            (moe_tables, "pprefill", both(phi, "b4")),
            (moe_tables, "pdecode", both(phi, "b4", "decode_counts")),
            (vl_tables, "vprefill", both(vl, "b4")),
            (vl_tables, "vdecode", both(vl, "b4", "decode_counts")),
            (tp_tables, "tprefill", {
                dt: tp["t2"][f"deepseek-{dt}"][0]["probe_launches"][
                    "prefill"] for dt in ("fp32", "bf16")}),
            (tp_tables, "tdecode", {
                dt: tp["t2"][f"deepseek-{dt}"][0]["probe_launches"]["step"]
                for dt in ("fp32", "bf16")})):
        check_listed(tabs, key, counts)
    # gemma3-27b ran at t = 2 in bf16 only
    for key, call in (("tgprefill", "prefill"), ("tgdecode", "step")):
        listed = {name: tp_tables.get(f"{key} bf16 {name}", {}).get(
            "launches", 0) for name in REPLACES}
        ran = tp["t2"]["gemma-bf16"][0]["probe_launches"][call]
        if listed != with_cases(ran):
            raise AssertionError(f"the {key} bf16 cases list {listed} "
                                 f"launches, a rank ran {ran}")
    # the train step's cases (fp32 only) against the step's launches
    listed = {name: vl_tables.get(f"vtrain fp32 {name}", {}).get(
        "launches", 0) for name in REPLACES}
    if listed != with_cases(train["step_launches"]):
        raise AssertionError(f"the vtrain cases list {listed} launches, a "
                             f"train step ran {train['step_launches']}")
    # the Swin-T cases against the fused forward's launches
    listed = {name: sum(r["fused"] for r in rows if r["kernel"] == name
                        and r["dtype"] == "fp32") for name in REPLACES}
    if listed != with_cases(main_counts):
        raise AssertionError(f"the Swin-T cases list {listed} launches, "
                             f"the forward ran {main_counts}")

    clock("phase 16")
    # 17. the auditor and the cost models
    audit = audit_phase(smi)

    clock("phase 17")
    # 18. the tooling: the op walk on the card, the dry-run CLI, examples
    tooling = tooling_phase(smi)

    clock("phase 18")
    # 19. the int8 path, the readings in processes of their own
    i8_counts, i8_device_ms = int8_path(i8_cases)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # cut for the script's time when the training mesh came (readings of
    # earlier paths, each in a process of its own; PERF.md keeps their
    # last numbers): the zamba2-1.2b and qwen2-moe-a2.7b profiles
    # (``lm_profile``; ``launch/profile.py --model`` takes them) and the
    # skinny, WKV and layernorm threshold sweeps. The prologue sweep stays:
    # it holds the split rule.
    for cut in ("the zamba2-1.2b and qwen2-moe-a2.7b profiles",
                "the skinny matmul threshold sweep",
                "the WKV threshold sweep", "the layernorm threshold sweep"):
        say("cut", f"{cut}: a reading of an earlier path, cut for the "
                   "script's time")
    profiles = threshold = threshold_wkv = threshold_ln = None
    threshold_prologue = readings_apart(
        "prologue_threshold", "prologue_threshold_readings('cuda')")
    sweep_persistent = readings_apart(
        "persistent_sweep", "persistent_readings('cuda')")
    designs = design_tables(rows)

    clock("phase 19")
    # 20. the kernels line and the result
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
        for key, run, name in (("zprefill", zamba2, "zamba2"),
                               ("qprefill", qwen, "qwen2"),
                               ("pprefill", phi, "phi3.5"),
                               ("vprefill", vl, "vl")):
            check_modes(rows, key, dt, run[f"{dt}_b4"]["prefill_modes"],
                        {"causal": [f"{name}.prefill causal"]})
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
    # this slice's paths: every kernel over one fp32 prefill of zamba2-1.2b
    # and of qwen2-moe-a2.7b
    for key, run, path in (
            ("zprefill", zamba2, "one zamba2-1.2b prefill, B=4 x 512, fp32"),
            ("qprefill", qwen, "one qwen2-moe-a2.7b prefill, B=4 x 256, "
                               "fp32")):
        for name in ("rowwise_matmul", "flash_attention", "layernorm"):
            kernels.append(kernel_line(
                rows, name, key, run["fp32_b4"]["counts"][name], path,
                label=f"{name} {path.split(' ')[1]}"))
    # qwen2-vl-2b: every kernel over one fp32 prefill and one fp32 train
    # step (forward and remat recomputation)
    for key, counts, path, tag in (
            ("vprefill", vl["fp32_b4"]["counts"],
             "one qwen2-vl-2b prefill, B=4 x 512, fp32", "qwen2-vl-2b"),
            ("vtrain", train["step_launches"],
             "one qwen2-vl-2b train step, B=4 x 512, fp32, remat (the "
             "forward's and the recomputation's calls)",
             "qwen2-vl-2b train")):
        for name in ("rowwise_matmul", "flash_attention", "layernorm"):
            kernels.append(kernel_line(rows, name, key, counts[name], path,
                                       label=f"{name} {tag}"))
    # tensor-parallel serving: every kernel over one rank's fp32 probe
    # prefill at t = 2, at the local shapes
    tp_run = tp["t2"]["deepseek-fp32"][0]["probe_launches"]["prefill"]
    for name in ("rowwise_matmul", "flash_attention", "layernorm"):
        kernels.append(kernel_line(
            rows, name, "tprefill", tp_run[name],
            "one rank's deepseek-7b prefill at t = 2, B=4 x 512, fp32 (qkv "
            "and gate|up at N / 2, wo and down at K / 2 with no residual, "
            "16 of 32 heads, the head at N = 51200)",
            label=f"{name} tensor-parallel t=2"))
    # the training mesh: every kernel over one rank's fp32 train step at
    # data=2, at the local shapes
    m_run = mesh["ranks"][0]["data2"]["launches"][0]
    for name in ("rowwise_matmul", "flash_attention", "layernorm"):
        kernels.append(kernel_line(
            rows, name, "mtrain", m_run[name],
            f"one rank's qwen2-vl-2b train step at data=2 ({MESH_VL_LAYERS} "
            "of 28 layers), B=2 x 512 a rank, fp32, remat (the FFMA matmul "
            "at M = 1024, attention at B=2)",
            label=f"{name} training mesh data=2"))
    # the tooling phase: every kernel over each bf16 prefill the op walk
    # priced on the card, its launches counted in the walk
    for arch, b, seq, key, _ in TOOLING_CALLS:
        for name in ("rowwise_matmul", "flash_attention", "layernorm"):
            kernels.append(kernel_line(
                rows, name, key, tooling["a"][arch]["counts"][name],
                f"one {arch} prefill, B={b} x {seq}, bf16, under the op "
                "walk (launch/op_cost.py)", dtype="bf16",
                label=f"{name} op walk {arch}"))
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
                               "zamba2": zamba2,
                               "zamba2_tables": zamba2_tables,
                               "qwen2_moe": qwen, "phi35_moe": phi,
                               "moe_tables": moe_tables,
                               "qwen2_vl": vl, "vl_tables": vl_tables,
                               "grads": grads, "train": train,
                               "resume": resume, "tp": tp,
                               "tp_tables": tp_tables,
                               "mesh": mesh, "mesh_tables": mesh_tables,
                               "audit": audit, "tooling": tooling,
                               "profiles": profiles,
                               "prologue_threshold_us": threshold_prologue,
                               "persistent_sweep_us": sweep_persistent,
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
                "that mode; the zamba2-1.2b, qwen2-moe-a2.7b and qwen2-vl-2b "
                "rows: over one fp32 prefill; the qwen2-vl-2b train rows: "
                "over one fp32 train step; the tensor-parallel rows: over "
                "one rank's fp32 prefill at t = 2; the training mesh rows: "
                "over one rank's fp32 train step at data=2; the op walk "
                "rows: over one bf16 prefill each)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
