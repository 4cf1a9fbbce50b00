"""Faithful analytical model of the paper's ASIC (the reproduction target).

The port's copy of the JAX package's ``core/asic_model.py``. Every
number here is the model of the paper's 40 nm ASIC (its clock, its
array, its schedule), not a measurement of this port or of any card.

Reimplements the paper's PE array — 12 blocks x 7 rows x 4 MACs = 336
MACs @ 600 MHz, 8-bit W/A — and its row-wise scheduling rules:

  * conv 4x4x3: the 48-weight kernel is spread over all 12 blocks
    (3 channels x 4 blocks), 7 rows produce 7 spatial outputs/cycle
    => 448 cycles per output channel for a 224x224 image (Sec. IV-C);
  * fully-connected: 48 input channels per cycle (12 blocks x 4 MACs),
    7 outputs per pass (7 rows), accumulated over ceil(K/48) cycles
    (Sec. IV-D: 96 channels => 7 outputs every 2 cycles);
  * attention (QK^T, AV): Q is broadcast as the weight, K is the input;
    only 8 of 12 blocks are used (Sec. IV-E) => 32 K-lanes/cycle and
    8/12 peak utilization for these ops.

Walking Swin-T through these rules reproduces the paper's claims:
403.2 GOPS peak (Table III), ~22.4 ms / 44.5 img/s per 224x224 image
(Table IV), overall utilization >= 99% (Sec. V), and the Fig. 2
FLOPs/parameter distribution (>=97% FLOPs and >=83% params in FC).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

from repro_torch.configs.swin_t import SwinConfig, ViTConfig
from repro_torch.core.rowwise import OpRecord


@dataclasses.dataclass(frozen=True)
class ASICGeometry:
    blocks: int = 12
    rows: int = 7
    macs_per_row: int = 4
    clock_hz: float = 600e6
    attn_blocks: int = 8          # Sec. IV-E: attention uses 8 blocks

    @property
    def macs(self) -> int:
        return self.blocks * self.rows * self.macs_per_row  # 336

    @property
    def peak_gops(self) -> float:
        return self.macs * 2 * self.clock_hz / 1e9          # 403.2


ASIC = ASICGeometry()


def op_cycles(op: OpRecord, geom: ASICGeometry = ASIC) -> int:
    """Cycle count for one GEMM under the paper's row-wise schedule."""
    if op.kind == "attn":
        k_lanes = geom.attn_blocks * geom.macs_per_row      # 32
    else:
        k_lanes = geom.blocks * geom.macs_per_row           # 48
    per = op.n * math.ceil(op.k / k_lanes) * math.ceil(op.m / geom.rows)
    return per * op.count


@dataclasses.dataclass
class ASICReport:
    ops: List[OpRecord]
    cycles: int
    geom: ASICGeometry

    @property
    def total_macs(self) -> int:
        return sum(op.macs for op in self.ops)

    @property
    def time_s(self) -> float:
        return self.cycles / self.geom.clock_hz

    @property
    def images_per_s(self) -> float:
        return 1.0 / self.time_s

    @property
    def utilization(self) -> float:
        return self.total_macs / (self.geom.macs * self.cycles)

    @property
    def achieved_gops(self) -> float:
        return 2 * self.total_macs / self.time_s / 1e9

    def flops_shares(self) -> dict:
        total = self.total_macs
        out = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0.0) + op.macs / total
        return out


def run_asic(ops: List[OpRecord], geom: ASICGeometry = ASIC) -> ASICReport:
    return ASICReport(ops=list(ops), geom=geom,
                      cycles=sum(op_cycles(op, geom) for op in ops))


# ----------------------------------------------------------------------
# Swin / ViT GEMM walks (shared by the ASIC model, the row-wise
# scheduler, and the Fig. 2 analysis)
# ----------------------------------------------------------------------


def swin_ops(cfg: SwinConfig) -> List[OpRecord]:
    """Decompose Swin into (M, K, N) GEMMs, layer by layer."""
    ops: List[OpRecord] = []
    res = cfg.img_size // cfg.patch
    c = cfg.embed_dim
    # patch-embed conv: (H/4*W/4) outputs, K = 4*4*3, N = embed_dim
    ops.append(OpRecord("patch_embed", "conv",
                        m=res * res, k=cfg.patch * cfg.patch * cfg.in_chans,
                        n=c))
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        tokens = res * res
        n_windows = (res // cfg.window) ** 2
        wt = cfg.window * cfg.window          # tokens per window (49)
        hd = c // heads
        for _ in range(depth):
            ops.append(OpRecord(f"s{si}.qkv", "fc", m=tokens, k=c, n=3 * c))
            ops.append(OpRecord(f"s{si}.qk", "attn", m=wt, k=hd, n=wt,
                                count=n_windows * heads))
            ops.append(OpRecord(f"s{si}.av", "attn", m=wt, k=wt, n=hd,
                                count=n_windows * heads))
            ops.append(OpRecord(f"s{si}.proj", "fc", m=tokens, k=c, n=c))
            mlp = int(cfg.mlp_ratio * c)
            ops.append(OpRecord(f"s{si}.mlp1", "fc", m=tokens, k=c, n=mlp))
            ops.append(OpRecord(f"s{si}.mlp2", "fc", m=tokens, k=mlp, n=c))
        if si < len(cfg.depths) - 1:
            # patch merging: (res/2)^2 tokens, 4C -> 2C
            ops.append(OpRecord(f"s{si}.merge", "fc",
                                m=(res // 2) ** 2, k=4 * c, n=2 * c))
            res //= 2
            c *= 2
    ops.append(OpRecord("head", "fc", m=1, k=c, n=cfg.num_classes))
    return ops


def swin_params(cfg: SwinConfig) -> dict:
    """Parameter counts by category (conv / fc / attn) for Fig. 2."""
    conv = cfg.patch * cfg.patch * cfg.in_chans * cfg.embed_dim
    fc = 0
    attn = 0
    res = cfg.img_size // cfg.patch
    c = cfg.embed_dim
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        for _ in range(depth):
            fc += 3 * c * c + c * c                      # qkv + proj
            mlp = int(cfg.mlp_ratio * c)
            fc += c * mlp + mlp * c
            attn += heads * (2 * cfg.window - 1) ** 2    # rel-pos bias
        if si < len(cfg.depths) - 1:
            fc += 4 * c * 2 * c
            c *= 2
    fc += c * cfg.num_classes
    return {"conv": conv, "fc": fc, "attn": attn}


def vit_ops(cfg: ViTConfig) -> List[OpRecord]:
    ops: List[OpRecord] = []
    tokens = (cfg.img_size // cfg.patch) ** 2
    c = cfg.embed_dim
    hd = c // cfg.num_heads
    ops.append(OpRecord("patch_embed", "conv", m=tokens,
                        k=cfg.patch * cfg.patch * cfg.in_chans, n=c))
    seq = tokens + 1
    for i in range(cfg.depth):
        ops.append(OpRecord(f"l{i}.qkv", "fc", m=seq, k=c, n=3 * c))
        ops.append(OpRecord(f"l{i}.qk", "attn", m=seq, k=hd, n=seq,
                            count=cfg.num_heads))
        ops.append(OpRecord(f"l{i}.av", "attn", m=seq, k=seq, n=hd,
                            count=cfg.num_heads))
        ops.append(OpRecord(f"l{i}.proj", "fc", m=seq, k=c, n=c))
        mlp = int(cfg.mlp_ratio * c)
        ops.append(OpRecord(f"l{i}.mlp1", "fc", m=seq, k=c, n=mlp))
        ops.append(OpRecord(f"l{i}.mlp2", "fc", m=seq, k=mlp, n=c))
    ops.append(OpRecord("head", "fc", m=1, k=c, n=cfg.num_classes))
    return ops
