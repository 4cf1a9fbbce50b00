"""Stage-compiled language model: init / train forward / prefill / decode.

The JAX package scans each stage over its stacked layers; here a Python
loop walks the repeats and hands each block the views ``leaf[i]`` of the
stacked parameter and cache leaves. The parameter tree and the cache
keep the JAX package's layout — stacked leaves ``(R, ...)``, cache
leaves ``(R, B, ...)`` — so the two packages' trees compare leaf for
leaf (``convert.from_jax_params`` loads a JAX tree).

Serving runs two ways, as in the JAX package. The dense-cache oracle:
one-shot :func:`prefill` at the prompts' exact lengths into a cache of
``alloc`` positions, then :func:`decode_step` with greedy picks
(:func:`greedy`). The paged core the serving engine drives: a cache of
page pools (:func:`init_paged_cache`) addressed through block tables,
filled by bucketed one-shot prefill (:func:`prefill_states` with
``last_pos``, then :func:`insert_prefill`) or chunk by chunk
(:func:`prefill_chunk`), advanced by :func:`decode_step` with
``pages``, scored speculatively (:func:`verify_states`, then
:func:`insert_verify`), and copied on write (:func:`cow_copy`). Every
pool is written in place. The port runs the dense decoder archs
(attention + MLP: a global layer's KV cache leaves ``(R, B, alloc, Hkv,
hd)``, a windowed layer's a ring of ``window`` slots, both written in
place at decode), the encoder-decoder arch (:func:`encode` over
``extra={"frames": ...}``, the cross K/V cached at prefill), the MoE
archs (their aux loss summed through :func:`forward`), RWKV6 (recurrent
state) and the Mamba2 hybrids: zamba2's stage repeats one shared
attention block (one weight copy) whose KV cache is per repeat, beside
the per-slot recurrent state of its Mamba layers, so a paged zamba2
cache holds page pools and per-slot state at once; granite's repeats a
period of Mamba2 and attention layers (``ModelConfig.layer_pattern``),
each with its own weights and a dropless MoE, its muP scalars folded
into the weights (:func:`fold_multipliers`). A weight-only int8
tree (``quant.quantize_tree``) runs too: the embedding gathers int8 rows
and dequantizes them, the projections dequantize their leaves. The
vision-language arch (qwen2-vl) takes precomputed patch embeddings
spliced over the first rows (``extra["vis_embeds"]``) and their M-RoPE
positions (``extra["positions3"]``). Training: :func:`loss_fn` over
:func:`forward` in train mode, each repeat recomputed in the backward
(``remat``, as the JAX package's ``jax.checkpoint``), on trees whose
leaves require a gradient; :func:`fuse_params` / :func:`unfuse_params`
migrate the seed's split projection layout. Tensor-parallel serving
(``serve/placement.py``) runs these functions on each rank's shard:
the row-parallel projections sum over the group and an untied head
gathers its vocab blocks (``core/partitioning.py``). Under the training
mesh every parameter is read through ``partitioning.gathered`` (a
stacked leaf one repeat at a time, inside the repeat's recomputation;
the embedding, the head and the final norms where they are read), and
:func:`loss_fn` reduces over the mesh; :func:`logical_specs` and
:func:`cache_logical_specs` name every leaf's logical axes, the trees
the JAX package's ``init_lm`` returns beside its parameters.

:func:`prefill` is an entry point of the port's trace (``core/trace.py``):
under it, the spans ``lm.embed``, ``lm.layer`` (one a block),
``lm.unembed`` and ``lm.states_to_cache``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core import partitioning as part
from repro_torch.core import quant, runtime, trace
from repro_torch.core.params import ParamTree, randn
from repro_torch.core.types import ModelConfig, Stage
from repro_torch.kernels import ops
from repro_torch.models import attention, blocks, mamba2, rope
from repro_torch.models.attention import KVCache, PagedKVCache

NEG_INF = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure (dicts,
    lists, tuples, named tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        items = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return fn(*trees)


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 (the JAX package's
    shardable padding); the pad columns are masked in the logits."""
    return -(-cfg.vocab // 256) * 256


def _init_stage(gen, stage: Stage, cfg: ModelConfig, dtype, device):
    stacked, shared = {}, {}
    for i, blk in enumerate(stage.body):
        stack = None if blk.shared else stage.repeat
        p = blocks.init_block(gen, blk, cfg, stack, dtype, device)
        (shared if blk.shared else stacked)[str(i)] = p
    return {"stacked": stacked, "shared": shared}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda",
            dtype=None) -> Dict[str, Any]:
    """Random parameters in the JAX package's tree, drawn from
    ``generator`` on the generator's own device (a CUDA generator draws
    the 3 B normals of rwkv6-3b in well under a second) and placed on
    ``device``. ``dtype``: default ``cfg.dtype``. The JAX package's
    ``init_lm`` returns (params, specs); here the specs come from the
    config alone (:func:`logical_specs`), and a ``generator`` of None
    on ``device="meta"`` gives the shapes alone (:func:`param_shapes`)."""
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    d = cfg.d_model
    vp = padded_vocab(cfg)

    def normal(shape, scale):
        t = randn(generator, shape) * scale
        return t.to(dtype=dtype, device=device)

    params: Dict[str, Any] = {"embed": normal((vp, d), 0.02)}
    params["stages"] = [_init_stage(generator, stage, cfg, dtype, device)
                        for stage in cfg.stages()]
    params["final_norm"] = {"g": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layer":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype,
                                                device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, vp), 1 / math.sqrt(d))
    if cfg.encdec:
        params["enc"] = {
            "stages": [_init_stage(generator, stage, cfg, dtype, device)
                       for stage in cfg.enc_stages()],
            "final_norm": {"g": torch.ones((d,), dtype=dtype,
                                           device=device)}}
        if cfg.norm == "layer":
            params["enc"]["final_norm"]["b"] = torch.zeros(
                (d,), dtype=dtype, device=device)
    return params


def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> Dict[str, Any]:
    """:func:`init_lm`'s tree on the meta device: every leaf's shape and
    dtype, nothing allocated."""
    return init_lm(cfg, None, device="meta", dtype=dtype)


def _stage_specs(stage: Stage, cfg: ModelConfig):
    stacked, shared = {}, {}
    for i, blk in enumerate(stage.body):
        stack = None if blk.shared else stage.repeat
        s = blocks.block_logical_specs(blk, cfg, stack)
        (shared if blk.shared else stacked)[str(i)] = s
    return {"stacked": stacked, "shared": shared}


def logical_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axis names of every leaf of :func:`init_lm`'s tree,
    the tree of the same structure the JAX package's ``init_lm`` returns
    beside its parameters: ``("vocab", "embed")`` for the embedding,
    ``("layers", ...)`` for a stacked leaf."""
    def norm():
        s = {"g": (None,)}
        if cfg.norm == "layer":
            s["b"] = (None,)
        return s
    specs: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "stages": [_stage_specs(st, cfg) for st in cfg.stages()],
        "final_norm": norm()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    if cfg.encdec:
        specs["enc"] = {"stages": [_stage_specs(st, cfg)
                                   for st in cfg.enc_stages()],
                        "final_norm": norm()}
    return specs


# ----------------------------------------------------------------------
# Param-layout migration: fused (wqkv / wgi) <-> seed (wq/wk/wv, wg/wi)
# ----------------------------------------------------------------------


def _cat_leaves(leaves):
    """Concatenate sibling projection leaves along the output axis.
    Weight-only int8 leaves fuse exactly: their scales are per output
    column, so the fused panel's scales are the parts' scales."""
    if quant.is_quantized(leaves[0]):
        return {k: torch.cat([t[k] for t in leaves], dim=-1)
                for k in ("q", "s")}
    return torch.cat(leaves, dim=-1)


def _split_leaf(leaf, widths):
    """Inverse of :func:`_cat_leaves`: copies, not views, so that each
    part is a leaf of its own."""
    widths = [int(w) for w in widths]
    if quant.is_quantized(leaf):
        qs = torch.split(leaf["q"], widths, dim=-1)
        ss = torch.split(leaf["s"], widths, dim=-1)
        return [{"q": q.clone(), "s": sc.clone()} for q, sc in zip(qs, ss)]
    return [t.clone() for t in torch.split(leaf, widths, dim=-1)]


def _migrate_blocks(cfg: ModelConfig, params, block_fn):
    """Apply ``block_fn(blk, block_params) -> block_params`` to every
    block's param dict (stacked and shared groups, decoder and encoder
    stages); returns a new tree, every other leaf untouched."""
    def stage_list(stages_cfg, stages_p):
        new = []
        for stage, sp in zip(stages_cfg, stages_p):
            ns = {"stacked": dict(sp["stacked"]),
                  "shared": dict(sp["shared"])}
            for i, blk in enumerate(stage.body):
                key = str(i)
                group = "shared" if blk.shared else "stacked"
                if key in ns[group]:
                    ns[group][key] = block_fn(blk, ns[group][key])
            new.append(ns)
        return new

    out = dict(params)
    out["stages"] = stage_list(cfg.stages(), params["stages"])
    if cfg.encdec and "enc" in params:
        enc = dict(params["enc"])
        enc["stages"] = stage_list(cfg.enc_stages(),
                                   params["enc"]["stages"])
        out["enc"] = enc
    return out


def fuse_params(cfg: ModelConfig, params):
    """Migrate a seed-layout param tree (split wq/wk/wv, wg/wi leaves) to
    the fused layout ``init_lm`` makes: one ``wqkv`` leaf per
    self-attention layer, one ``wkv`` per cross-attention layer, one
    ``wgi`` per gated MLP. Idempotent and exact (a concatenation, also
    of weight-only int8 leaves and of per-leaf optimizer moments: see
    ``train.step.fuse_state``)."""
    def block_fn(blk, p):
        p = dict(p)
        if blk.mixer == "attn" and "attn" in p and "wq" in p["attn"]:
            a = dict(p["attn"])
            a["wqkv"] = _cat_leaves([a.pop("wq"), a.pop("wk"),
                                     a.pop("wv")])
            p["attn"] = a
        if blk.cross_attn and "cross" in p and "wk" in p["cross"]:
            c = dict(p["cross"])
            c["wkv"] = _cat_leaves([c.pop("wk"), c.pop("wv")])
            p["cross"] = c
        if (blk.ffn == "mlp" and "ffn" in p and "wg" in p["ffn"]
                and "wi" in p["ffn"]):
            f = dict(p["ffn"])
            f["wgi"] = _cat_leaves([f.pop("wg"), f.pop("wi")])
            p["ffn"] = f
        return p

    return _migrate_blocks(cfg, params, block_fn)


def fold_multipliers(cfg: ModelConfig, params):
    """Fold the published scalars that weights can carry into a float
    tree, IN PLACE, and return it: ``residual_multiplier`` into each
    projection whose output meets the residual (attention's ``wo``,
    Mamba2's ``out_proj``, the MLP's, the experts' and the shared
    expert's down), ``attention_multiplier`` into the q columns (as
    its ratio to the kernel's ``head_dim ** -0.5``) and
    ``1 / logits_scaling`` into the final norm's gain. So the kernels'
    fused residual epilogue and norm prologue stay whole, and a config
    whose scalars are 1 takes no extra op. Fold a tree once; the
    embedding scale is applied as the rows are read (:func:`embed`)."""
    rm = cfg.residual_multiplier
    qs = (cfg.attention_multiplier * cfg.head_dim ** 0.5
          if cfg.attention_multiplier else 1.0)
    qo = cfg.n_heads * cfg.head_dim

    def block_fn(blk, p):
        outs = []
        if blk.mixer == "attn":
            outs.append(p["attn"]["wo"])
            a = p["attn"]
            wq = a["wqkv"][..., :qo] if "wqkv" in a else a["wq"]
            if qs != 1.0:
                wq.mul_(qs)
        elif blk.mixer == "mamba2":
            outs.append(p["mamba"]["out_proj"])
        if blk.ffn in ("mlp", "moe"):
            outs += [p["ffn"][k] for k in ("wo", "shared_wo")
                     if k in p["ffn"]]
        if rm != 1.0:
            for w in outs:
                w.mul_(rm)
        return p

    _migrate_blocks(cfg, params, block_fn)
    if cfg.logits_scaling != 1.0:
        params["final_norm"]["g"].div_(cfg.logits_scaling)
    return params


def unfuse_params(cfg: ModelConfig, params):
    """Inverse of :func:`fuse_params`: the seed's split layout.
    ``fuse_params(cfg, unfuse_params(cfg, p))`` equals ``p``."""
    qo, kvo, _ = attention.proj_splits(cfg)

    def block_fn(blk, p):
        p = dict(p)
        if blk.mixer == "attn" and "attn" in p and "wqkv" in p["attn"]:
            a = dict(p["attn"])
            a["wq"], a["wk"], a["wv"] = _split_leaf(a.pop("wqkv"),
                                                    (qo, kvo, kvo))
            p["attn"] = a
        if blk.cross_attn and "cross" in p and "wkv" in p["cross"]:
            c = dict(p["cross"])
            c["wk"], c["wv"] = _split_leaf(c.pop("wkv"), (kvo, kvo))
            p["cross"] = c
        if blk.ffn == "mlp" and "ffn" in p and "wgi" in p["ffn"]:
            f = dict(p["ffn"])
            wgi = f.pop("wgi")
            half = (wgi["q"] if quant.is_quantized(wgi)
                    else wgi).shape[-1] // 2
            f["wg"], f["wi"] = _split_leaf(wgi, (half, half))
            p["ffn"] = f
        return p

    return _migrate_blocks(cfg, params, block_fn)


# ----------------------------------------------------------------------
# Stage execution
# ----------------------------------------------------------------------


def _run_stage(stage: Stage, sp, x, *, cfg: ModelConfig, mode: str,
               positions=None, lengths=None, cache=None, enc_out=None,
               pages=None, chunk_len=None, targets=None,
               causal: bool = True, remat: bool = False):
    """Walk a stage's repeats. Returns (x, aux, states): the decode and
    chunk modes' new cache (its pools written in place) or the prefill
    and verify modes' per-layer states, stacked over the repeats as the
    JAX scan stacks them (``{}`` in train). ``enc_out``, ``pages`` (the
    serving block table: every layer indexes its own pool through it),
    ``chunk_len`` and ``targets`` (``attention.chunk_targets`` of the
    call) go to every block; ``causal=False`` (the encoder) drops the
    blocks' windows, as the JAX package's does. ``remat`` (train mode
    only): each repeat's body runs under ``torch.utils.checkpoint``,
    which keeps its input alone and runs it again in the backward, as
    the JAX package's ``jax.checkpoint`` over the scan body."""
    stacked, shared = sp["stacked"], sp["shared"]
    aux = 0.0
    per_layer: List[dict] = []

    def body(x, rep):
        out_states, aux = {}, 0.0
        for i, blk in enumerate(stage.body):
            key = str(i)
            # under a training mesh each leaf is gathered here, inside
            # the repeat's recomputation (``part.gathered``)
            bp = (_tree_map(lambda a, r=rep: part.gathered(a, r),
                            stacked[key])
                  if key in stacked else _tree_map(part.gathered,
                                                   shared[key]))
            csl = (_tree_map(lambda a, r=rep: a[r], cache[key])
                   if cache and key in cache else None)
            with trace.span("lm.layer"):
                x, io = blocks.apply_block(
                    blk, bp, x, cfg=cfg, mode=mode, positions=positions,
                    lengths=lengths, cache=csl, enc_out=enc_out,
                    pages=pages, chunk_len=chunk_len, targets=targets,
                    window_override=None if causal else 0)
            aux = aux + io.aux
            state = (io.new_cache if mode in ("decode", "chunk")
                     else io.prefill_state)
            if state is not None:
                out_states[key] = state
        return x, aux, out_states

    for rep in range(stage.repeat):
        if remat and mode == "train" and torch.is_grad_enabled():
            # no op of the train path draws random numbers: no RNG state
            # to keep for the recomputation
            x, aux_r, out_states = torch.utils.checkpoint.checkpoint(
                body, x, rep, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux_r, out_states = body(x, rep)
        aux = aux + aux_r
        per_layer.append(out_states)
    states = ({} if not per_layer[0] else
              _tree_map(lambda *ls: torch.stack(ls), *per_layer))
    if mode in ("decode", "chunk"):
        # the leaves a block wrote in place (the attention KV) or only
        # read (the cross KV) are not in its new cache: the stage's
        # stacked leaves hold the step already
        states = {key: {**cache[key], **states.get(key, {})}
                  for key in cache}
    return x, aux, states


def _run_stages(stage_params, stages, x, *, cache=None, **kw):
    aux_total = 0.0
    all_states = []
    for si, (stage, sp) in enumerate(zip(stages, stage_params)):
        stage_cache = cache[si] if cache is not None else None
        x, aux, states = _run_stage(stage, sp, x, cache=stage_cache, **kw)
        aux_total += aux
        all_states.append(states)
    return x, aux_total, all_states


# ----------------------------------------------------------------------
# Embedding / logits
# ----------------------------------------------------------------------


@trace.traced("lm.embed")
def embed(params, tokens, cfg: ModelConfig, extra: Optional[dict] = None):
    """The token rows of the table; a vision arch's ``extra["vis_embeds"]``
    (B, n_patches, d) over the first ``n_patches`` rows, in the table's
    dtype (the JAX package's ``dynamic_update_slice`` at (0, 0, 0)),
    built out of place so that a gradient reaches both."""
    w = part.gathered(params["embed"])
    if quant.is_quantized(w):
        # weight-only int8 tree: gather the int8 rows, then dequantize
        # only the gathered (B, S, d) block by the per-column scales
        x = (w["q"][tokens].float() * w["s"]).to(DTYPES[cfg.dtype])
    else:
        x = w[tokens]
    if cfg.embedding_multiplier != 1.0:
        # muP's embedding scale as the rows are read: a tied table is the
        # head too, and cannot carry it
        x = x * cfg.embedding_multiplier
    if cfg.frontend == "vision" and extra and "vis_embeds" in extra:
        ve = extra["vis_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


@trace.traced("lm.unembed")
def unembed(params, x, cfg: ModelConfig):
    fn = _tree_map(part.gathered, params["final_norm"])
    x = ops.layernorm(x, fn["g"], fn.get("b"), eps=cfg.norm_eps,
                      kind=cfg.norm)
    if cfg.tie_embeddings:
        # the kernel reads weights with unit column stride: the tied
        # head multiplies by a transposed copy of the table. Tied
        # embeddings stay replicated under tensor parallelism (the
        # embed gather needs every row), so the logits are full-width
        w = quant.resolve_weight(part.gathered(params["embed"]),
                                 x.dtype).t().contiguous()
        logits = ops.matmul(x, w, out_dtype=torch.float32)
    else:
        # under tensor parallelism the lm_head is vocab-sharded: each
        # rank computes its contiguous logit block, and the tiled gather
        # rebuilds the row before the pad mask, which needs global
        # column indices (a no-op outside TP)
        logits = part.tp_gather(ops.matmul(
            x, part.gathered(params["lm_head"]), out_dtype=torch.float32))
    if padded_vocab(cfg) != cfg.vocab:  # mask pad columns out of softmax
        logits[..., cfg.vocab:] = NEG_INF
    return logits


def _add_positions(x, cfg: ModelConfig):
    """The sinusoidal absolute positions 0..S-1 of the position-free
    archs, in x's dtype (RoPE archs rotate inside attention instead)."""
    if cfg.rope != "none":
        return x
    pe = rope.sinusoidal_embedding(x.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def _positions(cfg: ModelConfig, tokens, extra: Optional[dict] = None):
    """RoPE positions of a full sequence: 0..S-1 per row, (B, S); an
    M-RoPE arch's ``extra["positions3"]`` (3, B, S) where given."""
    if cfg.rope == "mrope" and extra and "positions3" in extra:
        return extra["positions3"]
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


def encode(params, frames, cfg: ModelConfig):
    """The encoder of an encoder-decoder arch over precomputed frame
    embeddings (B, T, d): the sinusoidal positions 0..T-1, its stages
    with their windows dropped, then its final norm."""
    x = frames + rope.sinusoidal_embedding(
        frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)[None]
    x, _, _ = _run_stages(params["enc"]["stages"], cfg.enc_stages(), x,
                          cfg=cfg, mode="train", causal=False, remat=True)
    fn = _tree_map(part.gathered, params["enc"]["final_norm"])
    return ops.layernorm(x, fn["g"], fn.get("b"), eps=cfg.norm_eps,
                         kind=cfg.norm)


def _encoder_out(params, cfg: ModelConfig, extra):
    """The encoder's output for the frames of ``extra`` (None for a
    decoder-only arch)."""
    if not cfg.encdec:
        return None
    if not extra or "frames" not in extra:
        raise ValueError(f"{cfg.name} needs extra={{'frames': (B, "
                         f"{cfg.cross_len}, {cfg.d_model})}}")
    return encode(params, extra["frames"], cfg)


def forward(params, tokens, cfg: ModelConfig, *,
            extra: Optional[dict] = None, remat: bool = True):
    """Full train-mode forward -> (logits, aux_loss). ``extra``: the
    encoder's ``{"frames": (B, T, d)}`` of an encoder-decoder arch, a
    vision arch's ``{"vis_embeds": (B, P, d), "positions3": (3, B, S)}``.
    ``remat``: recompute each repeat in the backward (where a gradient
    is taken)."""
    enc_out = _encoder_out(params, cfg, extra)
    x = _add_positions(embed(params, tokens, cfg, extra), cfg)
    x, aux, _ = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                            mode="train",
                            positions=_positions(cfg, tokens, extra),
                            enc_out=enc_out, remat=remat)
    aux = (aux.float() if isinstance(aux, torch.Tensor)
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return unembed(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """Cross-entropy next-token loss -> (loss + aux_loss, metrics).
    ``batch``: ``tokens`` and ``labels`` (B, S), labels below 0 masked;
    every other key goes to :func:`forward` as ``extra``. The
    log-sum-exp runs in fp32 and the gold logit is gathered; the token
    count is floored at 1.

    Under a training mesh (``part.use_mesh``) ``batch`` is this rank's
    rows: the token count, the loss and the accuracy are the global
    batch's (summed over the mesh, each row counted once however many
    ranks hold it), and the value returned for the gradient is this
    rank's share of the global loss, so that the gradients summed over
    the ranks are the global loss's."""
    extra = {k: v for k, v in batch.items()
             if k not in ("tokens", "labels")} or None
    logits, aux = forward(params, batch["tokens"], cfg, extra=extra,
                          remat=remat)
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * valid
    correct = ((torch.argmax(logits, -1) == safe) * valid).sum()
    if part.active_mesh() is None:
        ntok = torch.clamp(valid.sum(), min=1)
        loss = nll.sum() / ntok
        metrics = {"loss": loss, "aux_loss": aux, "ntokens": ntok,
                   "accuracy": correct / ntok}
        return loss + aux, metrics
    reps = part.batch_replicas()
    ntok = torch.clamp(part.mesh_sum(valid.sum()) // reps, min=1)
    share = nll.sum() / (ntok * reps)
    metrics = {"loss": part.mesh_sum(share), "aux_loss": aux.detach(),
               "ntokens": ntok,
               "accuracy": (part.mesh_sum(correct) // reps) / ntok}
    return share + aux, metrics


# ----------------------------------------------------------------------
# KV / recurrent-state cache: init, prefill conversion
# ----------------------------------------------------------------------


def _slot_cache_init(blk, cfg: ModelConfig, repeat, batch, alloc, dtype,
                     device, pool=None):
    blocks._check(blk)
    c = {}
    if blk.mixer == "attn" and pool is not None:
        # paged serving: (R, n_pages + n_slots scratch, ps, Hkv, hd)
        n_pages, ps = pool
        shape = (repeat, n_pages + batch, ps, cfg.n_kv_heads, cfg.head_dim)
        c["kv"] = PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))
    elif blk.mixer == "attn":
        # a windowed layer keeps a ring of at most ``window`` slots
        slots = min(alloc, blk.window) if blk.window else alloc
        shape = (repeat, batch, slots, cfg.n_kv_heads, cfg.head_dim)
        c["kv"] = KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))
    elif blk.mixer == "mamba2":
        st = mamba2.init_state(cfg, batch, dtype, device)
        c["mamba"] = mamba2.MambaState(*(
            torch.zeros((repeat,) + a.shape, dtype=a.dtype, device=device)
            for a in st))
    elif blk.mixer == "rwkv6":
        r = cfg.rwkv
        h = cfg.d_model // r.head_dim
        c["rwkv_t"] = {
            "x_prev_t": torch.zeros((repeat, batch, cfg.d_model),
                                    dtype=dtype, device=device),
            "wkv": torch.zeros((repeat, batch, h, r.head_dim, r.head_dim),
                               dtype=torch.float32, device=device)}
    if blk.cross_attn:
        shape = (repeat, batch, cfg.cross_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                         torch.zeros(shape, dtype=dtype, device=device))
    if blk.ffn == "rwkv6_cmix":
        c["rwkv_c"] = {"x_prev_c": torch.zeros(
            (repeat, batch, cfg.d_model), dtype=dtype, device=device)}
    return c


def _init_cache_tree(cfg: ModelConfig, batch, alloc, dtype, device,
                     pool=None):
    out = []
    for stage in cfg.stages():
        sc = {}
        for i, blk in enumerate(stage.body):
            c = _slot_cache_init(blk, cfg, stage.repeat, batch, alloc,
                                 dtype, device, pool=pool)
            if c:
                sc[str(i)] = c
        out.append(sc)
    return out


def init_cache(cfg: ModelConfig, batch: int, alloc: Optional[int] = None,
               dtype=None, device="cuda"):
    """Zeroed decode cache: KV leaves of ``alloc`` positions (required
    when the arch has attention; a windowed layer's ring holds
    min(alloc, window); the cross K/V ``cross_len``; the recurrent state
    has no sequence axis)."""
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    if alloc is None and any(blk.mixer == "attn" for stage in cfg.stages()
                             for blk in stage.body):
        raise ValueError(f"{cfg.name}: init_cache needs alloc, the KV "
                         "positions to hold")
    return _init_cache_tree(cfg, batch, alloc, dtype, device)


def init_paged_cache(cfg: ModelConfig, n_slots: int, max_len: int, *,
                     page_size: int = 16, n_pages: int = 0, dtype=None,
                     device="cuda"):
    """Serving cache with paged attention KV: every attention layer gets
    a page pool ``(R, n_pages + n_slots, page_size, Hkv, hd)`` indexed
    by the engine's block tables (the ``+ n_slots`` are per-slot
    *scratch* pages idle and mid-prefill slots write to); recurrent and
    cross-attention state stays per-slot dense.

    ``n_pages == 0`` sizes the pool for full occupancy
    (``n_slots * ceil(max_len / page_size)`` real pages); pass less to
    oversubscribe. Sliding windows must be page-aligned
    (``window % page_size == 0``) so ring pages tile exactly.
    """
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    max_pages = -(-max_len // page_size)
    n_pages = n_pages or n_slots * max_pages
    for stage in cfg.stages():
        for blk in stage.body:
            if blk.mixer == "attn" and blk.window % page_size:
                raise ValueError(f"sliding window {blk.window} must be a "
                                 f"multiple of page_size {page_size}")
    return _init_cache_tree(cfg, n_slots, max_len, dtype, device,
                            pool=(n_pages, page_size))


def cache_logical_specs(cache, cfg: Optional[ModelConfig] = None):
    """Logical names for every leaf of a dense cache (the JAX package's):
    (layers, batch, ...), a 5-dim leaf (layers, batch, kv_seq, kv_heads,
    head_dim). Paged pools stay engine-local. With ``cfg``, only a global
    attention layer's own K/V keeps those names: the port's other
    readers take their leaf whole, so it is split over nothing but its
    layers and batch (JAX's GSPMD would gather it where it is read). A
    windowed layer's ring decodes on the unsharded path; the cross K/V
    is read whole by cross-attention; a recurrent state (RWKV6's
    (H, P, P), Mamba2's) by its mixer's step."""
    from repro_torch.core import tree as tree_lib

    def spec(leaf):
        names = [None] * leaf.dim()
        names[0] = "layers"
        if leaf.dim() >= 2:
            names[1] = "batch"
        if leaf.dim() == 5:           # (R, B, S, kv_heads, hd)
            names[2] = "kv_seq"
            names[3] = "kv_heads"
        return tuple(names)
    specs = tree_lib.tree_map(spec, cache)
    for stage, sc in zip(cfg.stages() if cfg else (), specs):
        for i, blk in enumerate(stage.body):
            for key, names in list(sc.get(str(i), {}).items()):
                if key == "kv" and not blk.window:
                    continue
                sc[str(i)][key] = part.map_specs(
                    lambda n: n[:2] + (None,) * (len(n) - 2), names)
    return specs


def _ring_from_prefill(k, window):
    """Stacked prefill states (R, B, S, ...) as a ring buffer of
    ``window`` slots holding the last ``window`` positions at slots
    p % window (zero-padded when S <= window)."""
    s = k.shape[2]
    if s <= window:
        return _pad_seq(k, window)
    p = torch.arange(s - window, s, device=k.device)
    return k[:, :, p[torch.argsort(p % window)]]


@trace.traced("lm.states_to_cache")
def states_to_cache(cfg: ModelConfig, all_states, alloc: int):
    """Prefill states -> decode cache: a global layer's KV padded with
    zeros to ``alloc`` positions, a windowed layer's as its ring of
    ``window`` slots (whatever ``alloc``, as in JAX, where ``init_cache``
    makes min(alloc, window)); the cross K/V and the recurrent state
    (RWKV6's, Mamba2's) pass through."""
    out = []
    for stage, states in zip(cfg.stages(), all_states):
        sc = {}
        for i, blk in enumerate(stage.body):
            st = states.get(str(i))
            if st is None:
                continue
            c = dict(st)
            if "kv" in st:
                if blk.window:
                    c["kv"] = KVCache(*(_ring_from_prefill(t, blk.window)
                                        for t in st["kv"]))
                else:
                    c["kv"] = KVCache(*(_pad_seq(t, alloc)
                                        for t in st["kv"]))
            sc[str(i)] = c
        out.append(sc)
    return out


def _pad_seq(t, alloc):
    """Stacked prefill states (R, B, S, ...) in a zeroed (R, B, alloc,
    ...) buffer."""
    if alloc < t.shape[2]:
        raise ValueError(f"alloc {alloc} is shorter than the prompt "
                         f"({t.shape[2]} tokens)")
    out = t.new_zeros(t.shape[:2] + (alloc,) + t.shape[3:])
    out[:, :, :t.shape[2]] = t
    return out


def prefill_states(params, tokens, cfg: ModelConfig, *,
                   extra: Optional[dict] = None, last_pos=None):
    """Full-sequence prefill -> (logits, raw per-layer states).
    ``extra``: as :func:`forward`'s (after a prefill with
    ``positions3``, decode rotates by the sequence index, as in the JAX
    package: ROADMAP.md, "Reference caveats").

    ``last_pos`` ((B,) or int) is *bucketed* prefill: the tokens are
    right-padded to a bucket length and the logits are taken at position
    ``last_pos - 1`` (the last real token). Causal attention keeps every
    real position's activations and KV untouched by the tail padding;
    :func:`insert_prefill` drops the pad rows' KV. Recurrent mixers
    fold padding into their state, so recurrent archs prefill at exact
    lengths (``last_pos=None``)."""
    b = tokens.shape[0]
    enc_out = _encoder_out(params, cfg, extra)
    x = _add_positions(embed(params, tokens, cfg, extra), cfg)
    x, _, states = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                               mode="prefill",
                               positions=_positions(cfg, tokens, extra),
                               enc_out=enc_out)
    if last_pos is None:
        xl = x[:, -1:]
    else:
        idx = runtime.to_device(last_pos, x.device).long().expand(b) - 1
        xl = x[torch.arange(b, device=x.device), idx][:, None]
    logits = unembed(params, xl, cfg)
    return logits[:, 0], states


@trace.traced("lm.prefill", is_entry=True)
def prefill(params, tokens, cfg: ModelConfig, *,
            extra: Optional[dict] = None, alloc: Optional[int] = None):
    """Full-sequence prefill -> (last-position logits, dense cache of
    ``alloc`` positions; default: the prompt length)."""
    logits, states = prefill_states(params, tokens, cfg, extra=extra)
    return logits, states_to_cache(cfg, states, alloc or tokens.shape[1])


def _pools(cache):
    """The paged KV pools of a cache, stage by stage."""
    return [c["kv"] for sc in cache for c in sc.values()
            if isinstance(c.get("kv"), PagedKVCache)]


def _windows(cfg: ModelConfig):
    """The distinct windows of the attention layers (0: global)."""
    return tuple(sorted({blk.window for stage in cfg.stages()
                         for blk in stage.body if blk.mixer == "attn"}))


def _insert_slot(dst, src, slot):
    """Write a (R, 1, ...) prefill state into batch row ``slot`` of a
    (R, B, ...) per-slot cache leaf, in place."""
    dst[:, slot] = src[:, 0].to(dst.dtype)
    return dst


def _insert_pages(pool: PagedKVCache, k, v, targets):
    """Scatter prefilled KV states (R, 1, S_pad, Hkv, hd) into the
    slot's pages of every repeat's pool, in place: the rows ``targets``
    (``attention.chunk_targets`` of the prompt) name. Positions >= plen
    (padding) and, for windowed layers, < plen - window (evicted from
    the ring) are not written; stale rows left in a partial tail page
    are masked at read time by the kv_len bookkeeping."""
    bi, si, pid, off = targets
    pool.k[:, pid, off] = k[:, bi, si].to(pool.k.dtype)
    pool.v[:, pid, off] = v[:, bi, si].to(pool.v.dtype)
    return pool


def _insert(cfg: ModelConfig, cache, states, targets_of, slot=None):
    """Write a call's per-layer states into the cache, in place: each
    attention layer's KV (R, B, S, Hkv, hd) into its pool through the
    targets ``targets_of(S)`` gives (``attention.chunk_targets``, built
    once, each layer taking its window's), and the recurrent and
    cross-attention leaves into batch row ``slot``."""
    targets = None
    out = []
    for stage, stage_cache, stage_states in zip(cfg.stages(), cache, states):
        sc = {}
        for key, cur in stage_cache.items():
            st = (stage_states or {}).get(key) or {}
            c = dict(cur)
            if "kv" in st:
                k, v = st["kv"]
                if targets is None:
                    targets = targets_of(k.shape[2])
                c["kv"] = _insert_pages(
                    cur["kv"], k, v, targets[stage.body[int(key)].window])
            for name in ("mamba", "rwkv_t", "rwkv_c", "cross_kv"):
                if name in st:
                    c[name] = _tree_map(lambda d, s_: _insert_slot(d, s_,
                                                                   slot),
                                        cur[name], st[name])
            sc[key] = c
        out.append(sc)
    return out


def insert_prefill(cfg: ModelConfig, cache, states, *, slot, pages, plen,
                   page_size: int):
    """Insert a single-request prefill into a paged serving cache, in
    place. Attention KV states scatter into the pages the engine
    granted the slot (``pages``: (max_pages,) physical ids): positions
    below ``plen`` (and, for a windowed layer, its last ``window``);
    recurrent and cross-attention state writes batch row ``slot``, so
    the recurrent and encoder-decoder archs admit here at exact lengths.

    One-shot prefill scatters the *whole* prompt, so every granted page
    must be slot-private (refcount 1): a prefix-cache hit takes the
    chunked path, which starts past the shared pages. A host ``pages``
    (numpy) and ``plen`` (int) cost no device read
    (``attention.chunk_targets``)."""
    pools = _pools(cache)
    dev = pools[0].k.device if pools else None
    if isinstance(pages, torch.Tensor) and pools:
        pages = pages.to(dev)
    return _insert(cfg, cache, states, lambda s: attention.chunk_targets(
        0, plen, pages[None], s, _windows(cfg), page_size, device=dev),
        slot)


def _panel_positions(x, offset, cfg: ModelConfig):
    """The sinusoidal positions of a panel at ``offset`` ((B,)), for the
    position-free decoder archs (RoPE archs rotate inside attention)."""
    if cfg.rope != "none" or cfg.encdec:
        return x
    pos = offset[:, None] + torch.arange(x.shape[1], device=x.device)[None]
    return x + rope.sinusoidal_rows(pos, cfg.d_model).to(x.dtype)


def prefill_chunk(params, cache, tokens, cfg: ModelConfig, *, offset,
                  chunk_len, pages):
    """Chunked-prefill step: one forward over a row panel of the prompt,
    resumable across engine steps.

    tokens: (1, Sc_pad) — a chunk of a longer prompt starting at
    absolute position ``offset`` (tokens already in the paged cache),
    right-padded to a chunk shape with the true length in ``chunk_len``
    (<= Sc_pad). Every attention layer attends the slot's written KV
    pages plus the in-flight chunk (``attention.paged_chunk_apply``) and
    appends the chunk's KV in place, so successive calls rebuild the KV
    state one-shot prefill + :func:`insert_prefill` would have written.
    ``pages``: (1, max_pages) block table. Returns (next-token logits
    (1, V) at chunk position chunk_len - 1, cache). Only
    causal-attention archs may chunk (``paging.supports_bucketing``);
    the final chunk's logits are the prompt's first-token logits.
    Host ``offset`` / ``chunk_len`` (ints) and ``pages`` (numpy), as the
    engine passes them, cost no device read
    (``attention.chunk_targets``)."""
    b, s = tokens.shape
    dev = tokens.device
    targets = attention.chunk_targets(offset, chunk_len, pages, s,
                                      _windows(cfg),
                                      _pools(cache)[0].k.shape[2],
                                      device=dev)
    pages = runtime.to_device(pages, dev).long()
    offset = runtime.to_device(offset, dev).long().expand(b)
    clen = runtime.to_device(chunk_len, dev).long().expand(b)
    x = _panel_positions(embed(params, tokens, cfg), offset, cfg)
    x, _, new_cache = _run_stages(params["stages"], cfg.stages(), x,
                                  cfg=cfg, mode="chunk", lengths=offset,
                                  cache=cache, pages=pages, chunk_len=clen,
                                  targets=targets)
    xl = x[torch.arange(b, device=dev), clen - 1][:, None]
    logits = unembed(params, xl, cfg)
    return logits[:, 0], new_cache


def verify_states(params, cache, tokens, cfg: ModelConfig, *, offset,
                  chunk_len, pages):
    """Speculative-verify forward (the batched, read-only sibling of
    :func:`prefill_chunk`): score a (B, Sc) panel — each slot's last
    committed token plus its draft tokens, right-padded — against the
    paged cache, WITHOUT writing the panel's KV. ``offset`` /
    ``chunk_len``: per-row (B,) (tokens already in the cache / real
    panel rows; 0 rows are fully masked). Returns (full panel logits
    (B, Sc, V), per-layer panel KV states): acceptance needs every
    panel position's distribution; the caller then writes only the
    accepted rows with :func:`insert_verify`."""
    b, _ = tokens.shape
    dev = tokens.device
    offset = runtime.to_device(offset, dev).expand(b)
    clen = runtime.to_device(chunk_len, dev).expand(b)
    x = _panel_positions(embed(params, tokens, cfg), offset, cfg)
    x, _, states = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                               mode="verify", lengths=offset, cache=cache,
                               pages=runtime.to_device(pages, dev).long(),
                               chunk_len=clen)
    return unembed(params, x, cfg), states


def insert_verify(cfg: ModelConfig, cache, states, *, pages, offset,
                  n_keep):
    """Write the accepted prefix of a verify panel into the paged cache,
    in place: every attention layer scatters its panel rows
    ``< n_keep[b]`` (per row: the re-scored committed token plus the
    accepted drafts; ``n_keep == 0`` writes nothing — inactive or fully
    rolled-back slots), through the chunked-prefill scatter's targets
    (including the windowed ring routing), built once for the call. Host
    ``pages`` / ``offset`` / ``n_keep`` (numpy), as the engine passes
    them after its one read of the accepted counts, cost no device read
    (``attention.chunk_targets``)."""
    pool = _pools(cache)[0].k
    return _insert(cfg, cache, states, lambda s: attention.chunk_targets(
        offset, n_keep, pages, s, _windows(cfg), pool.shape[2],
        device=pool.device))


def cow_copy(cache, src, dst):
    """Copy-on-write page copy across every paged attention layer, in
    place: physical page ``src``'s K/V rows land in page ``dst`` (see
    ``attention.copy_page``). ``src == dst`` is the identity. Other
    state (recurrent, cross-KV) is untouched."""
    src, dst = int(src), int(dst)
    for pool in _pools(cache):
        attention.copy_page(pool, src, dst)
    return cache


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig,
                pages=None):
    """One decode step. tokens: (B, 1); lengths: (B,) tokens in cache.
    Returns (logits (B, vocab), new_cache). The attention KV leaves are
    written IN PLACE at position ``lengths`` (so ``cache`` holds the
    step too, and ``new_cache`` shares those leaves): a step that copied
    them would move the whole cache, 2.1 GB for deepseek-7b at B=4 x
    544 in fp32. The recurrent leaves are new tensors. ``pages``
    ((B, max_pages) block tables) is required when ``cache`` holds paged
    KV pools (:func:`init_paged_cache`); every layer indexes its own
    pool through the same table."""
    x = embed(params, tokens, cfg)
    if cfg.rope == "none":
        # rows ``lengths`` of the JAX package's 65536-row table
        pe = rope.sinusoidal_rows(lengths, cfg.d_model)
        x = x + pe[:, None].to(x.dtype)
    x, _, new_cache = _run_stages(
        params["stages"], cfg.stages(), x, cfg=cfg, mode="decode",
        lengths=lengths, cache=cache,
        pages=None if pages is None else pages.long())
    logits = unembed(params, x, cfg)
    return logits[:, 0], new_cache


def greedy(params, prompts, cfg: ModelConfig, n_new: int, *,
           extra: Optional[dict] = None):
    """Greedy generation for a batch of equal-length prompts (B, S):
    prefill, then ``n_new - 1`` decode steps, each feeding back the
    argmax. Returns the (B, n_new) picked tokens — the stream
    ``tests/conftest.py::manual_greedy`` gives per prompt (its cache
    sized ``S + n_new``). ``extra``: as :func:`prefill_states`."""
    logits, cache = prefill(params, prompts, cfg, extra=extra,
                            alloc=prompts.shape[1] + n_new)
    toks = [torch.argmax(logits, dim=-1)]
    lengths = torch.full((prompts.shape[0],), prompts.shape[1],
                         dtype=torch.int32, device=prompts.device)
    for _ in range(n_new - 1):
        logits, cache = decode_step(params, cache, toks[-1][:, None],
                                    lengths, cfg)
        toks.append(torch.argmax(logits, dim=-1))
        lengths = lengths + 1
    return torch.stack(toks, dim=1)


# --------------------------- nn.Module wrapper -------------------------


class LanguageModel(nn.Module):
    """The LM as a module over the parameter tree. ``params``: a tree as
    ``init_lm`` or ``from_jax_params`` make it; by default a random one
    drawn from ``generator`` (seed 0). Runs on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 dtype=None, generator=None):
        super().__init__()
        device = runtime.resolve_device(device)
        if params is None:
            params = init_lm(cfg, generator or torch.Generator()
                             .manual_seed(0), device=device, dtype=dtype)
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, tokens: torch.Tensor, extra: Optional[dict] = None):
        return forward(self.params.tree(), tokens, self.cfg, extra=extra)

    def prefill(self, tokens: torch.Tensor, alloc: Optional[int] = None,
                extra: Optional[dict] = None):
        return prefill(self.params.tree(), tokens, self.cfg, extra=extra,
                       alloc=alloc)

    def decode_step(self, cache, tokens: torch.Tensor, lengths: torch.Tensor,
                    pages: Optional[torch.Tensor] = None):
        return decode_step(self.params.tree(), cache, tokens, lengths,
                           self.cfg, pages=pages)

    def greedy(self, prompts: torch.Tensor, n_new: int,
               extra: Optional[dict] = None) -> torch.Tensor:
        return greedy(self.params.tree(), prompts, self.cfg, n_new,
                      extra=extra)
