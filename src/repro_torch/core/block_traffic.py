"""Serving-side KV traffic: paged block-table decode against dense
lockstep caches, as bytes a decode step moves.

The port's copy of the serving section of the JAX package's
``core/block_traffic.py``: the four functions the serving CLI prints
(``launch/serve.py``'s KV-traffic line). A dense lockstep cache streams
``n_slots x max_len`` rows per layer per step; block-table decode
streams only each live sequence's pages. The rest of that module (the
per-block pricing of the matmul planner) is not ported yet (ROADMAP.md
queue 1 item 10).
"""
from __future__ import annotations


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

