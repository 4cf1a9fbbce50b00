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
    rope: str = "default"          # default | mrope | none
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
                    p += mo.n_experts * e + d * mo.n_experts + d
                    p += mo.n_shared * mlp_params(mo.d_ff)
                    a += (mo.top_k + mo.n_shared) * e + d * mo.n_experts + d
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
