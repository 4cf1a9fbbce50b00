"""Serving-side KV traffic: paged block-table decode against dense
lockstep caches, as bytes a decode step moves.

The port's copy of the serving section of the JAX package's
``core/block_traffic.py``: the four functions the serving CLI prints
(``launch/serve.py``'s KV-traffic line). A dense lockstep cache streams
``n_slots x max_len`` rows per layer per step; block-table decode
streams only each live sequence's pages. Beside them, the decode-step
weight traffic of one attention + MLP block
(:func:`decode_weight_traffic`) and the per-device bytes of
tensor-parallel serving (:func:`serve_tp_traffic`). The JAX package
prices each matmul by its TPU tile plan (operands padded to the tile);
the port's kernels read each operand once, unpadded, and these
functions price them so. The rest of that module (the Swin block, the
chunked-prefill, prefix-cache and speculation models) is not ported yet
(ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

from repro_torch.core.types import GATED_ACTS

FP32 = 4


def _mm_bytes(m: int, k: int, n: int, db: int, *, n_weights: int = 1,
              residual: bool = False, prologue: bool = False) -> tuple:
    """(total, weight) bytes of one row-wise matmul on the port's
    kernels: x (m, k) read once, each of ``n_weights`` (k, n) panels
    read once, the (m, n) output written once (and the residual read),
    a norm prologue's fp32 gamma and beta rows."""
    w = k * n * db * n_weights
    total = m * k * db + w + m * n * db
    if residual:
        total += m * n * db
    if prologue:
        total += 2 * k * FP32
    return total, w


def decode_weight_traffic(*, n_slots: int, d_model: int, n_heads: int,
                          n_kv_heads: int, head_dim: int, d_ff: int,
                          gated: bool = True, dtype_bytes: int = 2,
                          prefused: bool = True) -> dict:
    """Modeled HBM bytes for ONE attention + MLP block decode step at
    M = n_slots rows, where streaming the weights dwarfs the
    activations. ``prefused=True`` is the stored layout (``wqkv`` and
    ``wgi`` single leaves streamed as they are); ``prefused=False``
    prices concatenating the sibling projections on every call: every
    part read and the panel written before the kernel reads it back, an
    extra twice the panel's bytes.

    Returns {"ops": [(name, total_bytes, weight_bytes)],
             "total": int, "weight_bytes": int}.
    """
    db, m = dtype_bytes, n_slots
    qo, kvo = n_heads * head_dim, n_kv_heads * head_dim
    rows = []

    def mm(name, k, n, *, n_weights=1, cat=False, **kw):
        total, w = _mm_bytes(m, k, n, db, n_weights=n_weights, **kw)
        if cat and not prefused:
            extra = 2 * k * n * n_weights * db     # parts read + cat write
            total, w = total + extra, w + extra
        rows.append((name, total, w))

    mm("qkv", d_model, qo + 2 * kvo, cat=True, prologue=True)
    mm("wo+residual", qo, d_model, residual=True)
    if gated:
        mm("gate|up", d_model, d_ff, n_weights=2, cat=True, prologue=True)
    else:
        mm("mlp1", d_model, d_ff, prologue=True)
    mm("mlp2+residual", d_ff, d_model, residual=True)
    return {"ops": rows, "total": sum(t for _, t, _ in rows),
            "weight_bytes": sum(w for _, _, w in rows)}


def decode_weight_traffic_cfg(cfg, *, n_slots: int, dtype_bytes: int = 2,
                              prefused: bool = True) -> dict:
    """:func:`decode_weight_traffic` with dims pulled from a ModelConfig."""
    return decode_weight_traffic(
        n_slots=n_slots, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        gated=cfg.act in GATED_ACTS, dtype_bytes=dtype_bytes,
        prefused=prefused)


def kv_layer_counts(cfg) -> tuple:
    """(n_global, n_local, window) attention-layer counts of a config.
    The model prices one window size; configs mixing several would need
    per-window counts, so that case is rejected rather than mispriced."""
    n_global = n_local = window = 0
    for stage in cfg.stages():
        for blk in stage.body:
            if blk.mixer != "attn":
                continue
            if blk.window:
                assert window in (0, blk.window), (
                    f"mixed sliding windows ({window}, {blk.window}) "
                    "need per-window traffic accounting")
                n_local += stage.repeat
                window = blk.window
            else:
                n_global += stage.repeat
    return n_global, n_local, window



def dense_kv_step_bytes(*, n_slots: int, max_len: int, n_global: int,
                        n_local: int = 0, window: int = 0,
                        n_kv_heads: int, head_dim: int,
                        dtype_bytes: int = 2) -> int:
    """One lockstep decode step against the seed's dense per-slot
    caches: every attention layer streams its whole ``(n_slots, alloc)``
    K and V buffers regardless of how many tokens are live (windowed
    layers allocate ``min(window, max_len)``)."""
    row = 2 * n_kv_heads * head_dim * dtype_bytes          # K + V
    total = n_global * n_slots * max_len * row
    if n_local:
        total += n_local * n_slots * min(window, max_len) * row
    return total



def paged_kv_step_bytes(lengths, *, page_size: int, n_global: int,
                        n_local: int = 0, window: int = 0,
                        n_kv_heads: int, head_dim: int,
                        dtype_bytes: int = 2) -> int:
    """One decode step with block-table gathers: each live sequence
    fetches only its own live pages (whole pages — a partial tail page
    streams in full), windowed layers at most the ring's
    ``ceil(window / page_size)`` pages. Idle slots fetch nothing."""
    row = 2 * n_kv_heads * head_dim * dtype_bytes
    total = 0
    for ln in lengths:
        live = -(-(ln) // page_size) * page_size           # page-rounded
        total += n_global * live * row
        if n_local:
            ring = min(live, -(-min(window, ln) // page_size) * page_size)
            total += n_local * ring * row
    return total



def serve_kv_traffic(trace, cfg, *, n_slots: int, max_len: int,
                     page_size: int, dtype_bytes: int = 2) -> dict:
    """Sum modeled KV HBM bytes over a decode trace (a list of per-step
    live-slot length lists, as recorded by ``Engine.kv_trace``) for both
    serving regimes. The ratio is the acceptance metric: with mean live
    length << max_len, paged decode moves a small multiple of the live
    tokens while dense lockstep always moves n_slots * max_len rows."""
    n_global, n_local, window = kv_layer_counts(cfg)
    kw = dict(n_global=n_global, n_local=n_local, window=window,
              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
              dtype_bytes=dtype_bytes)
    dense = sum(dense_kv_step_bytes(n_slots=n_slots, max_len=max_len,
                                    **kw) for _ in trace)
    paged = sum(paged_kv_step_bytes(lens, page_size=page_size, **kw)
                for lens in trace)
    # attention-free archs (rwkv) move no KV either way: parity, not 0x
    ratio = dense / paged if paged else 1.0
    return {"dense_bytes": dense, "paged_bytes": paged,
            "ratio": ratio, "steps": len(trace)}




def serve_tp_traffic(trace, cfg, *, n_slots: int, max_len: int,
                     page_size: int, tp: int, dtype_bytes: int = 2) -> dict:
    """Per-device modeled decode-loop bytes under tensor parallelism
    against the single-device engine, over a recorded
    ``Engine.kv_trace``.

    Sharded per device (``serve/placement.py``):
      * KV pages: each rank's pools hold ``1/tp`` of the KV heads, so
        its gathers stream ``1/tp`` of every step's KV bytes;
      * block weights: the wqkv / wgi column panels and the wo / down
        row panels all split exactly ``1/tp``;
      * an untied lm_head vocab-shards ``1/tp``; tied embeddings stay
        replicated, so the unembed panel streams in FULL on every
        device (it caps the ratio of tied archs).

    Cross-device bytes added per step and device (ring collectives):
      * one all-reduce per attention output and one per MLP output, of
        ``n_slots x d_model`` activations: a ring all-reduce moves
        ``2 (tp-1)/tp`` x payload per device;
      * the untied logits' all-gather: ``(tp-1)/tp x n_slots x
        padded_vocab`` fp32.

    Returns {"single_bytes", "per_device_bytes", "kv_bytes",
    "weight_bytes", "lm_head_bytes", "allreduce_bytes", "ratio", "tp",
    "steps"}: ``ratio`` = single / per-device.
    """
    n_global, n_local, window = kv_layer_counts(cfg)
    n_blocks = n_global + n_local
    steps = len(trace)
    kw = dict(n_global=n_global, n_local=n_local, window=window,
              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
              dtype_bytes=dtype_bytes)
    kv = sum(paged_kv_step_bytes(lens, page_size=page_size, **kw)
             for lens in trace)
    block_w = decode_weight_traffic_cfg(
        cfg, n_slots=n_slots, dtype_bytes=dtype_bytes)["weight_bytes"]
    weights = n_blocks * block_w * steps
    vp = -(-cfg.vocab // 256) * 256                # lm.padded_vocab
    head_w = cfg.d_model * vp * dtype_bytes * steps
    single = kv + weights + head_w

    head_dev = head_w if cfg.tie_embeddings else head_w // tp
    ar = 0
    if tp > 1:
        psum = n_slots * cfg.d_model * dtype_bytes
        ar = 2 * n_blocks * (2 * (tp - 1) * psum // tp) * steps
        if not cfg.tie_embeddings:
            ar += (tp - 1) * n_slots * vp * FP32 // tp * steps
    per_device = kv // tp + weights // tp + head_dev + ar
    return {"single_bytes": single, "per_device_bytes": per_device,
            "kv_bytes": kv, "weight_bytes": weights,
            "lm_head_bytes": head_w, "allreduce_bytes": ar,
            "ratio": single / per_device if per_device else 1.0,
            "tp": tp, "steps": steps}
