"""Model-level HBM-traffic accounting, the port's copy of the JAX
package's ``core/block_traffic.py``.

* :func:`swin_block_traffic`: one Swin block forward, fused (the norm
  in the matmul's prologue, residual adds in epilogues, flash window
  attention with a streamed bias) or per op, each matmul priced on the
  plan of the design the port's wrapper takes
  (``core/rowwise.plan_matmul``: x re-read once per column tile, the
  weights once per row tile), where the JAX package prices its TPU tile
  plan (operands padded to the tile); :func:`swin_t_stage_cases`, the
  Swin-T stage geometries.
* Serving KV traffic: paged block-table decode against dense lockstep
  caches (:func:`serve_kv_traffic`); a dense lockstep cache streams
  ``n_slots x max_len`` rows per layer per step, block-table decode only
  each live sequence's pages. Beside them the decode-step weight traffic
  of one attention + MLP block (:func:`decode_weight_traffic`, each
  operand read once, unpadded, as the port's skinny kernels read them at
  decode) and the per-device bytes of tensor-parallel serving
  (:func:`serve_tp_traffic`).
* The chunked-prefill trade (:func:`chunked_prefill_traffic`), the
  prefix cache's skipped FLOPs and KV bytes (:func:`prefix_prefill_flops`,
  :func:`prefix_cache_traffic`) and a speculative verify step's bytes per
  accepted token (:func:`spec_step_traffic`).
"""
from __future__ import annotations

from repro_torch.core.rowwise import plan_matmul
from repro_torch.core.types import GATED_ACTS

FP32 = 4
_DTYPES = {4: "fp32", 2: "bf16"}


def _mm(m: int, k: int, n: int, db: int, **kw) -> int:
    """Modeled bytes of one matmul on the port's kernels at ``db``-byte
    operands and output (:func:`plan_matmul`)."""
    return plan_matmul(m, k, n, dtype=_DTYPES[db], **kw).bytes_moved


def _norm_io(m: int, d: int, db: int) -> int:
    """Standalone norm kernel: read + write the row panel, gamma/beta."""
    return 2 * m * d * db + 2 * d * FP32


def _ew_add_io(m: int, d: int, db: int) -> int:
    """A residual add in torch ops: read both operands, write the sum."""
    return 3 * m * d * db


def swin_block_traffic(*, grid_h: int, grid_w: int, c: int, heads: int,
                       window: int = 7, mlp_ratio: float = 4.0,
                       dtype_bytes: int = 2, batch: int = 1,
                       shifted: bool = False, fused: bool = True) -> dict:
    """Modeled HBM bytes for one Swin block forward at feature-map size
    (grid_h, grid_w) with C channels. Returns {"ops": [(name, bytes)],
    "total": int}. The attention terms are the JAX package's closed
    forms; each matmul is its port plan's bytes."""
    db = dtype_bytes
    m = batch * grid_h * grid_w                 # activation rows
    t = window * window                         # tokens per window
    n_win = batch * (grid_h // window) * (grid_w // window)
    f = int(mlp_ratio * c)
    score = n_win * heads * t * t * FP32        # one dense score pass
    qkv_io = 3 * m * c * db                     # q, k, v head-layout reads
    ops = []

    if fused:
        ops.append(("ln1+qkv(wide-N)", _mm(m, c, 3 * c, db, prologue=True)))
        # Flash window attention: q/k/v stream once, the score bias
        # streams as an operand, the S x S matrix never exists in HBM.
        if shifted:
            # per-window bias (rel + shift mask): constructed once per
            # forward (write + mask read), re-fetched per (window, head)
            nw_img = n_win // batch
            bias = (nw_img * heads * t * t * FP32          # construct
                    + nw_img * t * t * FP32                # mask read
                    + score)                               # kernel fetch
        else:
            # broadcast bias: fetched once per head
            bias = heads * t * t * FP32
        ops.append(("flash-attn+bias", qkv_io + bias + m * c * db))
        ops.append(("proj+residual", _mm(m, c, c, db, residual=True)))
        ops.append(("ln2+mlp1+gelu", _mm(m, c, f, db, prologue=True)))
        ops.append(("mlp2+residual", _mm(m, f, c, db, residual=True)))
    else:
        ops.append(("ln1", _norm_io(m, c, db)))
        ops.append(("qkv", _mm(m, c, 3 * c, db)))
        # Dense windowed attention: write scores, read-modify-write for
        # bias+mask+softmax (one fused pass), read probs for p@v.
        ops.append(("dense-attn", qkv_io + 4 * score + m * c * db))
        ops.append(("proj", _mm(m, c, c, db)))
        ops.append(("residual1", _ew_add_io(m, c, db)))
        ops.append(("ln2", _norm_io(m, c, db)))
        ops.append(("mlp1+gelu", _mm(m, c, f, db)))
        ops.append(("mlp2", _mm(m, f, c, db)))
        ops.append(("residual2", _ew_add_io(m, c, db)))

    return {"ops": ops, "total": sum(b for _, b in ops)}


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



def chunked_prefill_traffic(plen: int, *, chunk_size: int, page_size: int,
                            n_global: int, n_local: int = 0,
                            window: int = 0, n_kv_heads: int,
                            head_dim: int, dtype_bytes: int = 2) -> dict:
    """The chunked-prefill trade for one admitted prompt: the decode
    stall it removes against the prefix re-read bytes it adds.

    * Stall: a monolithic bucketed prefill makes every co-resident
      decode slot wait for ONE call over the whole prompt (``plen``
      rows between decode steps); chunked prefill bounds that to
      ``chunk_size`` rows per engine step.
    * Extra bytes: each chunk re-gathers the slot's already-written
      prefix pages (whole pages; windowed layers at most the ring), KV
      the one-shot call kept on chip. The chunk's own KV write is the
      same in both regimes and cancels.

    Returns ``{"n_chunks", "stall_rows_one_shot", "stall_rows_chunked",
    "prefix_reread_bytes"}``.
    """
    row = 2 * n_kv_heads * head_dim * dtype_bytes          # K + V
    reread = 0
    offs = list(range(0, plen, chunk_size))
    for off in offs[1:]:                                   # chunk 0: none
        live = -(-off // page_size) * page_size            # page-rounded
        reread += n_global * live * row
        if n_local:
            ring = min(live, -(-min(window, off) // page_size) * page_size)
            reread += n_local * ring * row
    last = plen - offs[-1]
    return {"n_chunks": len(offs),
            "stall_rows_one_shot": plen,
            "stall_rows_chunked": max(chunk_size if len(offs) > 1 else 0,
                                      last),
            "prefix_reread_bytes": reread}


def chunked_prefill_traffic_cfg(cfg, plen: int, *, chunk_size: int,
                                page_size: int,
                                dtype_bytes: int = 2) -> dict:
    """:func:`chunked_prefill_traffic` with layer counts from a config."""
    n_global, n_local, window = kv_layer_counts(cfg)
    return chunked_prefill_traffic(
        plen, chunk_size=chunk_size, page_size=page_size,
        n_global=n_global, n_local=n_local, window=window,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        dtype_bytes=dtype_bytes)


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


# ----------------------------------------------------------------------
# Speculative decode: HBM bytes per ACCEPTED token
# ----------------------------------------------------------------------


def spec_step_traffic(cfg, *, lengths, accepted_total: int,
                      page_size: int, n_slots: int = None,
                      dtype_bytes: int = 2) -> dict:
    """Bytes-per-accepted-token model for ONE speculative verify step
    against the plain decode steps it replaces.

    Decode at serving batch sizes is weight-streaming-bound: one fused
    panel fetch per block per step, whatever M is. The verify step
    scores a ``1 + k`` row panel per slot through the same row-wise
    primitive (M grows, the weight fetch does not) and its multi-query
    prefix gather reads each live page once per STEP instead of once per
    emitted token.

    ``lengths``: live-slot token lengths at the step (an
    ``Engine.kv_trace`` row). Returns ``{"step_bytes", "weight_bytes",
    "kv_bytes", "emitted", "bytes_per_accepted",
    "decode_bytes_per_token", "amortization"}``; with no accepted
    drafts the model is decode's own bytes a token (amortization 1.0).
    """
    n_live = len(lengths)
    if n_slots is None:
        n_slots = max(n_live, 1)
    w = decode_weight_traffic_cfg(cfg, n_slots=n_slots,
                                  dtype_bytes=dtype_bytes)
    n_blocks = sum(st.repeat * len(st.body) for st in cfg.stages())
    n_global, n_local, window = kv_layer_counts(cfg)
    kv = paged_kv_step_bytes(lengths, page_size=page_size,
                             n_global=n_global, n_local=n_local,
                             window=window, n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim,
                             dtype_bytes=dtype_bytes)
    weight = w["weight_bytes"] * n_blocks
    step = weight + kv
    emitted = n_live + int(accepted_total)
    per_tok = step / emitted if emitted else float(step)
    decode_per_tok = step / n_live if n_live else float(step)
    return {"step_bytes": step, "weight_bytes": weight, "kv_bytes": kv,
            "emitted": emitted, "bytes_per_accepted": per_tok,
            "decode_bytes_per_token": decode_per_tok,
            "amortization": (decode_per_tok / per_tok if per_tok
                             else 1.0)}


# ----------------------------------------------------------------------
# Prefix-cache traffic: prefill FLOPs and KV bytes a radix hit skips
# ----------------------------------------------------------------------


def prefix_prefill_flops(cfg, plen: int, hit: int = 0) -> int:
    """Modeled prefill FLOPs for a prompt whose first ``hit`` tokens are
    served by shared prefix-cache pages (``hit=0``: the cold cost).

    Linear work (qkv / wo / mlp projections, 2 FLOPs per MAC) scales
    with the *suffix* token count. Attention score + value work scales
    with the (query, key) pairs whose query is not cached: per attention
    layer ``4 * Hq * hd`` FLOPs per pair over ``T(plen) - T(hit)``
    pairs, ``T(n) = n(n+1)/2``. Embedding and lm_head are excluded.
    Global attention only: the engine keeps sliding-window archs out of
    the prefix cache."""
    qo = cfg.n_heads * cfg.head_dim
    kvo = cfg.n_kv_heads * cfg.head_dim
    d = cfg.d_model
    gated = cfg.act in GATED_ACTS
    suffix = plen - hit
    pairs = plen * (plen + 1) // 2 - hit * (hit + 1) // 2
    total = 0
    for stage in cfg.stages():
        for blk in stage.body:
            r = stage.repeat
            if blk.mixer == "attn":
                total += r * (2 * d * (qo + 2 * kvo)    # qkv projection
                              + 2 * qo * d) * suffix    # wo projection
                total += r * 4 * qo * pairs             # scores + values
            if blk.ffn == "mlp":
                total += r * (6 if gated else 4) * d * cfg.d_ff * suffix
    return total


def prefix_cache_traffic(cfg, requests, *, page_size: int,
                         dtype_bytes: int = 2) -> dict:
    """The prefix-cache win over a request trace. ``requests``: list of
    ``(plen, hit)`` pairs, the prompt length and the cached-prefix tokens
    of each admission. Returns prompt / hit token totals, the hit rate,
    cold against actual prefill FLOPs (:func:`prefix_prefill_flops`) and
    their ratio, and ``hit_kv_bytes``, the KV write traffic the shared
    pages absorb."""
    prompt_tokens = sum(p for p, _ in requests)
    hit_tokens = sum(h for _, h in requests)
    flops_cold = sum(prefix_prefill_flops(cfg, p) for p, _ in requests)
    flops_actual = sum(prefix_prefill_flops(cfg, p, h)
                       for p, h in requests)
    n_global, _, _ = kv_layer_counts(cfg)
    row = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    return {
        "prompt_tokens": prompt_tokens,
        "hit_tokens": hit_tokens,
        "hit_rate": hit_tokens / prompt_tokens if prompt_tokens else 0.0,
        "flops_cold": flops_cold,
        "flops_actual": flops_actual,
        "flops_saved": flops_cold - flops_actual,
        "flops_ratio": (flops_cold / flops_actual
                        if flops_actual else float("inf")),
        "hit_kv_bytes": n_global * hit_tokens * row,
    }


def swin_t_stage_cases(batch: int = 1) -> dict:
    """The Swin-T (224x224) per-stage block geometries."""
    return {
        "stage1": dict(grid_h=56, grid_w=56, c=96, heads=3, batch=batch),
        "stage2": dict(grid_h=28, grid_w=28, c=192, heads=6, batch=batch),
        "stage3": dict(grid_h=14, grid_w=14, c=384, heads=12, batch=batch),
    }
