"""Configuration types of the language models.

The port's own copy of the JAX package's ``core/types.py``, field for
field: a ``ModelConfig`` lowers to a list of ``Stage``s, each a repeat
over a homogeneous body of ``BlockDef``s. The port walks a stage's
repeats in a Python loop; the stacked parameter and cache leaves keep
their leading repeat axis, so the trees match the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Activations whose MLP is the gated two-matmul front half (SwiGLU /
# GeGLU).
GATED_ACTS = ("silu", "geglu")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (token-choice routing)."""

    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared: int = 0              # always-on shared experts (qwen2-moe)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # The port's own fields (the JAX package's MoEConfig lacks them):
    # dropless routing over every expert, of which this device holds the
    # contiguous range ``held`` = (first, stop) ((0, 0): all of them),
    # with an ungated shared expert (granite's); the shared expert's
    # width (0: d_ff * n_shared).
    dropless: bool = False
    held: Tuple[int, int] = (0, 0)
    shared_d_ff: int = 0

    @property
    def held_range(self) -> Tuple[int, int]:
        """(first, stop) of the experts this device computes."""
        return self.held if self.held != (0, 0) else (0, self.n_experts)

    @property
    def n_held(self) -> int:
        first, stop = self.held_range
        return stop - first

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.d_ff * self.n_shared


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") time-mix configuration."""

    head_dim: int = 64
    chunk: int = 128
    decay_lora: int = 64           # rank of data-dependent decay LoRA
    tokenshift_lora: int = 32


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Paged-KV serving geometry (vLLM-style block tables).

    The serving engine carves each attention layer's KV storage into a
    global pool of fixed-size pages ``(n_pages + n_slots, page_size,
    Hkv, hd)`` and maps every slot's logical positions onto physical
    pages through a per-slot block table. Physical page ``n_pages +
    slot`` is the slot's private *scratch page*: idle and mid-prefill
    slots' tables point at it so lockstep decode writes land in storage
    nobody reads — and, being per-slot, never serialize on one page.

    ``n_pages == 0`` means "size for full occupancy": the engine
    allocates ``n_slots * ceil(max_len / page_size)`` real pages, i.e.
    the same capacity as the dense lockstep caches; smaller values
    oversubscribe and the engine defers admissions until pages free up.

    ``prefill_chunk > 0`` enables *chunked prefill*: prompts longer than
    the chunk split into successive row panels processed across engine
    steps, interleaved with decode — the monolithic largest-bucket
    prefill program no longer stalls co-resident decode slots (the TTFT
    cliff). The chunk must sit on the bucket ladder (a power of two) so
    compiled chunk shapes stay bounded, and requires a bucketing-capable
    arch (pure causal attention).
    """

    page_size: int = 16            # tokens per KV page
    n_pages: int = 0               # real pages per layer pool (0 => full)
    min_bucket: int = 16           # smallest prefill padding bucket
    prefill_chunk: int = 0         # chunked-prefill panel size (0 => off)
    # Slice the decode block table to the batch's max live pages,
    # rounded up to a power of two, so executed gather volume tracks
    # live-page traffic instead of always reading max_pages entries.
    # Costs up to log2(max_pages) extra compiled decode programs (one
    # per table width), so it is opt-in.
    table_width_bucketing: bool = False
    # Radix-tree prefix cache over token prefixes: admission maps fully
    # shared prompt pages straight into the new slot's block table
    # (refcount++, zero prefill FLOPs) and chunked prefill processes
    # only the uncached suffix. Requires prefill_chunk > 0 (suffixes
    # replay through the chunk ladder, keeping the compile bound) and a
    # bucketing-capable, all-global-attention arch (sliding-window ring
    # writes would clobber shared pages); silently off otherwise.
    prefix_cache: bool = False
    # Sarathi-style cap on prefill tokens advanced per engine step
    # across mid-prefill slots (0 => unbounded). The head of the chunk
    # queue always advances, so prefill can't fully starve.
    prefill_token_budget: int = 0
    # Self-speculative decode: max draft tokens per slot per step
    # (0 => off). Drafts come from a host-side prompt-lookup n-gram
    # drafter (serve/spec.py); a batched verify step scores the panel
    # through the chunk kernels and writes only accepted rows. Panel
    # widths pad up the documented ``paging.spec_ladder`` so the
    # compile bound grows by len(ladder) programs exactly. Requires a
    # bucketing-capable arch, and is mutually exclusive with
    # table_width_bucketing (the width ladder would multiply the
    # k-ladder; speculative steps ship full-width tables instead).
    speculate_k: int = 0


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer inside a stage body.

    mixer  : 'attn' | 'mamba2' | 'rwkv6' | 'none'
    ffn    : 'mlp' | 'moe' | 'rwkv6_cmix' | 'none'
    window : 0 => global attention; >0 => sliding-window (local) attention
    shared : True => parameters are NOT stacked over the stage's repeats
             (zamba2's shared attention block).
    cross_attn : True => decoder block with cross-attention (whisper).
    """

    mixer: str = "attn"
    ffn: str = "mlp"
    window: int = 0
    shared: bool = False
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class Stage:
    """``repeat`` iterations over ``body`` (a tuple of BlockDefs)."""

    repeat: int
    body: Tuple[BlockDef, ...]

    @property
    def n_layers(self) -> int:
        return self.repeat * len(self.body)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|vlm|audio|ssm|vision
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    act: str = "silu"              # silu => SwiGLU MLP; gelu => GELU MLP
    norm: str = "rms"              # rms | layer
    rope: str = "default"          # default | mrope | none | nope
    rope_theta: float = 10_000.0
    # sliding-window pattern: e.g. gemma3 is 5 local : 1 global
    pattern_local: int = 0         # local layers per pattern group
    pattern_global: int = 0        # global layers per pattern group
    local_window: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): attn block shared every `hybrid_period` ssm layers
    hybrid_period: int = 0
    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    cross_len: int = 1500          # encoder output length (audio frames)
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # long-context capability flag
    subquadratic: bool = False
    # The port's own fields (the JAX package's ModelConfig lacks them;
    # their defaults keep its behaviour). ``layer_pattern``: a period of
    # mixers, "M" Mamba2 and "A" attention, repeated to ``n_layers``,
    # every block with the model's FFN and its own weights (granite's
    # hybrid; ``hybrid_period`` is zamba2's). ``norm_eps``: every
    # norm's. The muP scalars as published: the embedding rows times
    # ``embedding_multiplier`` as read; ``residual_multiplier`` on every
    # mixer and FFN output, ``attention_multiplier`` the softmax scale
    # (0: head_dim ** -0.5) and the logits over ``logits_scaling``,
    # which :func:`repro_torch.models.lm.fold_multipliers` folds into
    # the weights (the out-projections, the q columns, the final norm).
    layer_pattern: str = ""
    norm_eps: float = 1e-6
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    # ------------------------------------------------------------------
    # Stage compilation: config -> homogeneous stages
    # ------------------------------------------------------------------
    def stages(self) -> Tuple[Stage, ...]:
        if self.family == "ssm" and self.rwkv is not None:
            blk = BlockDef(mixer="rwkv6", ffn="rwkv6_cmix")
            return (Stage(self.n_layers, (blk,)),)

        if self.family == "hybrid" and self.layer_pattern:
            kinds = {"M": "mamba2", "A": "attn"}
            ffn = "moe" if self.moe is not None else "mlp"
            body = tuple(BlockDef(mixer=kinds[c], ffn=ffn)
                         for c in self.layer_pattern)
            if self.n_layers % len(body):
                raise ValueError(f"{self.name}: {self.n_layers} layers are "
                                 f"no whole number of {self.layer_pattern!r}")
            return (Stage(self.n_layers // len(body), body),)

        if self.family == "hybrid":
            period = self.hybrid_period or 6
            ssm_blk = BlockDef(mixer="mamba2", ffn="none")
            attn_blk = BlockDef(mixer="attn", ffn="mlp", shared=True)
            n_groups = self.n_layers // period
            tail = self.n_layers - n_groups * period
            stages = [Stage(n_groups,
                            (ssm_blk,) * (period - 1) + (attn_blk,))]
            if tail:
                stages.append(Stage(tail, (ssm_blk,)))
            return tuple(stages)

        ffn = "moe" if self.moe is not None else "mlp"
        if self.pattern_local:
            group = self.pattern_local + self.pattern_global
            n_groups = self.n_layers // group
            tail = self.n_layers - n_groups * group
            local = BlockDef(mixer="attn", ffn=ffn, window=self.local_window)
            glob = BlockDef(mixer="attn", ffn=ffn, window=0)
            body = ((local,) * self.pattern_local
                    + (glob,) * self.pattern_global)
            stages = [Stage(n_groups, body)]
            if tail:
                stages.append(Stage(tail, (local,)))
            return tuple(stages)

        blk = BlockDef(mixer="attn", ffn=ffn, cross_attn=self.encdec)
        return (Stage(self.n_layers, (blk,)),)

    def enc_stages(self) -> Tuple[Stage, ...]:
        """The encoder of an encoder-decoder arch: dense attention + MLP
        blocks (their attention unwindowed)."""
        assert self.encdec
        blk = BlockDef(mixer="attn", ffn="mlp")
        return (Stage(self.n_enc_layers, (blk,)),)

    # ------------------------------------------------------------------
    # Parameter counting
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and per-token-active."""
        d, hd = self.d_model, self.head_dim
        q_out = self.n_heads * hd
        kv_out = self.n_kv_heads * hd

        def attn_params():
            return d * q_out + 2 * d * kv_out + q_out * d

        def mlp_params(d_ff):
            n_mats = 3 if self.act in GATED_ACTS else 2
            return n_mats * d * d_ff

        total = active = 0
        for stage in self.stages():
            for blk in stage.body:
                mult = 1 if blk.shared else stage.repeat
                p = 0
                if blk.mixer == "attn":
                    p += attn_params() + 2 * d  # + norm
                    if blk.cross_attn:
                        p += attn_params() + d
                elif blk.mixer == "mamba2":
                    s = self.ssm
                    d_in = s.expand * d
                    p += 2 * d_in * d + d_in * 2 * s.d_state  # in/out/BC
                    p += d_in * s.d_conv + 2 * (d_in // s.head_dim) + d
                elif blk.mixer == "rwkv6":
                    r = self.rwkv
                    p += 4 * d * d + d * r.decay_lora * 2 + 6 * d + 2 * d
                a = p  # mixer params are always active
                if blk.ffn == "mlp":
                    m = mlp_params(self.d_ff) + d
                    p += m
                    a += m
                elif blk.ffn == "moe":
                    mo = self.moe
                    e = mlp_params(mo.d_ff)
                    shared = (mlp_params(mo.shared_width)
                              if mo.n_shared else 0)
                    p += mo.n_held * e + d * mo.n_experts + d + shared
                    a += mo.top_k * e + d * mo.n_experts + d + shared
                elif blk.ffn == "rwkv6_cmix":
                    m = int(2 * d * self.d_ff) + d
                    p += m
                    a += m
                total += mult * p
                active += mult * a
        embed = self.vocab * d
        total += embed + d
        active += embed + d
        if not self.tie_embeddings:
            total += embed
            active += embed
        if self.encdec:
            for stage in self.enc_stages():
                for _blk in stage.body:
                    p = attn_params() + mlp_params(self.d_ff) + 3 * d
                    total += stage.repeat * p
                    active += stage.repeat * p
        return {"total": total, "active": active}


# The port's own fields of each config type, which the JAX package's lack
PORT_FIELDS = {
    "ModelConfig": ("layer_pattern", "norm_eps", "embedding_multiplier",
                    "residual_multiplier", "attention_multiplier",
                    "logits_scaling"),
    "MoEConfig": ("dropless", "held", "shared_d_ff"),
}


def jax_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields where
    they hold their defaults, so that it compares with the asdict of
    the JAX package's config: a port field set otherwise stays in."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if (f.name in PORT_FIELDS.get(type(cfg).__name__, ())
                and v == f.default):
            continue
        out[f.name] = jax_fields(v) if dataclasses.is_dataclass(v) else v
    return out


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell. kind: train | prefill | decode."""

    name: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        # tokens processed per step: full seq for train/prefill, 1/seq for decode
        if self.kind == "decode":
            return self.global_batch
        return self.global_batch * self.seq_len
