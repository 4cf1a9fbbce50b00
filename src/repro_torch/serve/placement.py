"""Device-placement policies for the serving engine.

The port's copy of the JAX package's ``serve/placement.py``. The engine
never talks to devices directly: a *placement* owns where parameters
and page pools live and runs the engine's model calls, so the same host
loop serves one device or a tensor-parallel group.

``SingleDevice`` is the identity policy (exactly the engine without a
policy).

``TensorParallel`` is Megatron-style tensor parallelism over a
``torch.distributed`` process group of ``n_shards`` ranks. The JAX
package runs one controller over a mesh (``shard_map``); here each rank
is a process of its own that builds the same engine with its own
``TensorParallel`` and runs the same host loop, and the collectives
inside the model calls keep the ranks in step. Every model call runs
under ``partitioning.tp_shard(group)`` against a *local* config (heads
and d_ff divided by the shard count):

  * the fused ``wqkv`` / ``wgi`` panels are column-sharded
    **segment-wise**: the stored columns are permuted into per-shard
    order ``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]`` (:func:`shard_perm`), so
    rank i's contiguous block is a valid local fused panel. GQA grouping
    survives because q heads are stored grouped per kv head and the
    shard count divides ``n_kv_heads``;
  * attention ``wo`` and the MLP down projection are row-sharded along
    the contraction dim; their matmuls yield K-partial sums that one
    ``all_reduce`` per projection finishes (``partitioning.tp_reduce``),
    the residual added strictly after;
  * each rank's page pools hold only its own KV heads
    (``n_kv_heads / n_shards``);
  * an untied ``lm_head`` is vocab-sharded and the logits all-gathered
    back (``partitioning.tp_gather``); tied embeddings stay replicated;
  * block tables, lengths, temperatures, tokens and the ``PagePool``
    free list are the same on every rank: the host loop is oblivious.

What JAX marks replicated is identical on every rank by construction:
an ``all_reduce`` or an ``all_gather`` hands every rank the same bits,
everything after it is the same kernels on the same inputs, and every
rank's generator is seeded alike. What the host decides from a wall
clock (request deadlines) is agreed instead (:meth:`TensorParallel.
agreed`): rank 0's clock reading, broadcast over a CPU side group.

Weight-only int8 ``{"q", "s"}`` leaves shard with their weight: scales
are per output channel, so column shards permute and split the scale
row alike and row shards replicate it.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import partitioning, quant, tree
from repro_torch.core.types import GATED_ACTS, ModelConfig
from repro_torch.models import attention, lm
from repro_torch.serve.paging import supports_bucketing


class SingleDevice:
    """Identity placement: everything on the engine's device."""

    n_shards = 1
    axis: Optional[str] = None

    def validate(self, cfg: ModelConfig) -> None:
        pass

    def compute_cfg(self, cfg: ModelConfig) -> ModelConfig:
        return cfg

    def prepare_params(self, params, cfg: ModelConfig):
        return params

    def prepare_cache(self, cfg: ModelConfig, init: Callable):
        return init(cfg)

    def put_rep(self, x):
        return x

    def wrap(self, fn):
        return fn

    def agreed(self, value: float) -> float:
        return value

    def describe(self) -> str:
        return "single-device"


def shard_perm(widths: Sequence[int], t: int) -> np.ndarray:
    """Column permutation turning a fused multi-segment panel into
    per-shard order: segment s has ``widths[s]`` columns; shard i's
    slice of EVERY segment lands contiguously at block i, so a plain
    t-way split of the permuted axis yields valid local fused panels."""
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    idx = []
    for s in range(t):
        for o, w in zip(offs, widths):
            p = w // t
            idx.extend(range(o + s * p, o + (s + 1) * p))
    return np.asarray(idx, np.int64)


def _cols(leaf, idx):
    """The columns ``idx`` of a leaf (an int8 leaf's scales with them),
    as a tensor of their own."""
    if quant.is_quantized(leaf):
        return {"q": _cols(leaf["q"], idx), "s": _cols(leaf["s"], idx)}
    return leaf[..., torch.as_tensor(idx, device=leaf.device)].contiguous()


def _rows(leaf, rank, t):
    """Rank ``rank``'s contiguous block of the contraction (second to
    last) axis; an int8 leaf's per-output-channel scales replicated."""
    if quant.is_quantized(leaf):
        return {"q": _rows(leaf["q"], rank, t), "s": leaf["s"]}
    k = leaf.shape[-2] // t
    return leaf[..., rank * k:(rank + 1) * k, :].contiguous()


def shard_params(params, cfg: ModelConfig, t: int, rank: int):
    """Rank ``rank``'s shard of the full parameter tree ``params`` for
    ``t`` ranks: JAX's ``addressable_shards[rank]`` of each leaf that
    ``TensorParallel.prepare_params`` places. Each sharded leaf is
    gathered straight from the full one (never a full permuted copy);
    replicated leaves are the full tree's own tensors."""
    qkv = shard_perm(attention.proj_splits(cfg), t)
    gated = cfg.act in GATED_ACTS
    gi = shard_perm((cfg.d_ff, cfg.d_ff), t) if gated else None

    def block(idx):
        return idx[rank * (len(idx) // t):(rank + 1) * (len(idx) // t)]

    def block_fn(blk, p):
        p = dict(p)
        if blk.mixer == "attn" and "attn" in p:
            a = dict(p["attn"])
            a["wqkv"] = _cols(a["wqkv"], block(qkv))
            a["wo"] = _rows(a["wo"], rank, t)
            p["attn"] = a
        if blk.ffn == "mlp" and "ffn" in p:
            f = dict(p["ffn"])
            if gated:
                f["wgi"] = _cols(f["wgi"], block(gi))
            else:
                f["wi"] = _cols(f["wi"], block(np.arange(cfg.d_ff)))
            f["wo"] = _rows(f["wo"], rank, t)
            p["ffn"] = f
        return p

    out = lm._migrate_blocks(cfg, params, block_fn)
    if not cfg.tie_embeddings:
        out["lm_head"] = _cols(params["lm_head"],
                               block(np.arange(lm.padded_vocab(cfg))))
    return out


class TensorParallel:
    """Head- / segment-sharded tensor parallelism over the ``n_shards``
    ranks of a ``torch.distributed`` process group.

    ``group`` is the process group (None: the default one) and ``rank``
    this process's rank in it (None: ``dist.get_rank(group)``). Nothing
    touches the group before :meth:`prepare_params`, which raises unless
    a group of exactly ``n_shards`` ranks is initialised; no run falls
    back to one device."""

    def __init__(self, n_shards: int, *, group=None,
                 rank: Optional[int] = None, axis: str = "model",
                 timeout_s: float = 600.0):
        if n_shards < 1:
            raise ValueError(f"mesh axis size must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.axis = axis
        self.group = group
        self.rank = rank
        self.timeout_s = timeout_s
        self._side = None            # CPU (gloo) group for host values

    # -- validation (engine construction time, never mid-step) ---------

    def validate(self, cfg: ModelConfig) -> None:
        t = self.n_shards
        if not supports_bucketing(cfg):
            raise ValueError(
                f"{cfg.name}: tensor-parallel serving supports pure "
                "causal attention+MLP stacks only (recurrent/MoE/cross-"
                "attention state has no head sharding)")
        bad = []
        if cfg.n_heads % t:
            bad.append(f"n_heads={cfg.n_heads}")
        if cfg.n_kv_heads % t:
            bad.append(f"n_kv_heads={cfg.n_kv_heads}")
        if cfg.d_ff % t:
            seg = ("each wgi gate/up segment" if cfg.act in GATED_ACTS
                   else "the wi panel")
            bad.append(f"d_ff={cfg.d_ff} ({seg})")
        if not cfg.tie_embeddings and lm.padded_vocab(cfg) % t:
            bad.append(f"padded vocab={lm.padded_vocab(cfg)}")
        if bad:
            raise ValueError(
                f"mesh axis '{self.axis}'={t} cannot shard {cfg.name}: "
                f"it must divide every fused-panel segment and head "
                f"count (DESIGN.md §5), but not: " + ", ".join(bad))

    def compute_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The per-rank config the model calls run against."""
        t = self.n_shards
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // t,
                                   n_kv_heads=cfg.n_kv_heads // t,
                                   d_ff=cfg.d_ff // t)

    # -- the group -----------------------------------------------------

    def connect(self):
        """(group, rank), checked against ``n_shards``: the counterpart
        of JAX's "needs N devices, found M". The first call also makes
        the CPU side group, a collective: every rank calls it at once
        (``prepare_params`` does)."""
        t = self.n_shards
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"mesh axis '{self.axis}'={t} needs a process group of "
                f"{t} ranks, found none (start one process per rank and "
                "call torch.distributed.init_process_group in each)")
        group = self.group if self.group is not None else dist.group.WORLD
        size = dist.get_world_size(group)
        if size != t:
            raise ValueError(
                f"mesh axis '{self.axis}'={t} needs {t} ranks, found a "
                f"process group of {size}")
        rank = dist.get_rank(group)
        if self.rank is not None and self.rank != rank:
            raise ValueError(f"rank {self.rank} was asked for, but this "
                             f"process is rank {rank} of its group")
        self.group, self.rank = group, rank
        if self._side is None:
            # host values (rank 0's clock) travel on the CPU: a gloo
            # group over the same ranks, whatever the main backend
            self._side = dist.new_group(
                ranks=dist.get_process_group_ranks(group), backend="gloo",
                timeout=datetime.timedelta(seconds=self.timeout_s))
        return group, rank

    # -- parameter / cache placement -----------------------------------

    def prepare_params(self, params, cfg: ModelConfig):
        """This rank's shard of the full tree (:func:`shard_params`),
        on the device the full tree lives on."""
        _, rank = self.connect()
        return shard_params(params, cfg, self.n_shards, rank)

    def prepare_cache(self, cfg: ModelConfig, init: Callable):
        """This rank's paged cache, allocated at the local config: page
        pools ``(R, n_pages + n_slots, ps, Hkv / n_shards, hd)``, never
        the full pool and then a slice. ``validate`` has rejected every
        arch whose cache holds more than attention pools."""
        self.connect()
        cache = init(self.compute_cfg(cfg))
        for path, leaf in tree.leaves_with_paths(cache):
            if leaf.dim() != 5:
                raise AssertionError(
                    "a TP cache holds paged attention pools only, got "
                    f"{path} of rank {leaf.dim()}")
        return cache

    def put_rep(self, x):
        """A replicated engine-state tensor: every rank holds its own
        identical copy, so there is nothing to place."""
        return x

    def wrap(self, fn):
        """``fn`` (an engine call) run as this rank of the group: the
        counterpart of JAX's ``shard_map`` + ``jit``."""
        def run(*args, **kwargs):
            group, _ = self.connect()
            with partitioning.tp_shard(group):
                return fn(*args, **kwargs)
        run.__name__ = getattr(fn, "__name__", "run")
        run.__wrapped__ = fn
        return run

    def agreed(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a host reading the ranks
        must decide on alike, such as the clock of a deadline sweep)."""
        self.connect()
        buf = torch.tensor([value], dtype=torch.float64)
        dist.broadcast(buf, dist.get_global_rank(self.group, 0),
                       group=self._side)
        return float(buf[0])

    def describe(self) -> str:
        return f"tensor-parallel {self.axis}={self.n_shards}"


def from_mesh_shape(spec: str):
    """Parse a ``--mesh-shape`` CLI value into a placement policy.
    Accepts '' / '1' (single device), 'N', or 'model=N'."""
    s = (spec or "").strip()
    if not s:
        return SingleDevice()
    axis = "model"
    if "=" in s:
        axis, _, s = s.partition("=")
        axis = axis.strip()
        if axis != "model":
            raise ValueError(
                f"unknown mesh axis '{axis}' in --mesh-shape (serving "
                "shards over the 'model' axis only, e.g. 'model=4')")
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"--mesh-shape '{spec}' is not 'N' or 'model=N'") from None
    if n < 1:
        raise ValueError(f"--mesh-shape size must be >= 1, got {n}")
    return SingleDevice() if n == 1 else TensorParallel(n, axis=axis)
