"""Serving engine: paged-KV continuous batching with bucketed prefill.

The port's copy of the JAX package's ``serve/engine.py``. The host side
(the queue, the request lifecycle, admission, chunk scheduling, the
prefix cache, the drafter, preemption, the fault machinery and the run
loop) is the reference's, line for line, so with greedy sampling the
completions and ``stats`` equal the JAX engine's. The four jitted step
programs become plain methods on tensors run under ``torch.no_grad()``
on the engine's device (``_step``, ``_admit``, ``_chunk``, ``_spec``),
calling the paged functions of ``models/lm.py``; the page pools are
written in place, so nothing is donated. One ``torch.Generator`` on
the device, seeded with ``seed``, stands in for the JAX key splits.
A placement (``serve/placement.py``) owns the parameters, the pools and
the model calls: ``SingleDevice`` by default, or ``TensorParallel`` for
one rank of a ``torch.distributed`` group, where every rank builds the
same engine on its shard and runs this host loop, and the deadline
sweep decides on rank 0's clock (``placement.agreed``) so that no
rank's host decisions differ. ``audit_entry_points``, which feeds the
JAX package's static auditor, is not ported (ROADMAP.md queue 1 item
10).

vLLM-style paging: a fixed batch of ``n_slots`` sequences decodes in
lockstep, but attention KV lives in per-layer page *pools* shared by
every slot — a retiring sequence hands its pages back to a free list
and the refilling request takes only what its prompt needs, so short
sequences never pay ``max_len`` attention traffic. The host <-> device
choreography keeps a closed set of shapes:

  * decode is ONE step over fixed shapes — block tables, lengths,
    per-slot temperatures, the active mask and the fault-injection
    poison mask are tensor operands;
  * prefill pads prompts to a static bucket ladder (powers of two up to
    ``max_len``) and runs the prefill forward, the paged cache insert
    and first-token sampling in one call per admission, so continuous
    batching over arbitrary prompt lengths sees at most
    ``n_buckets + 1`` shapes (archs with recurrent/MoE state prefill
    at exact lengths — see ``paging.supports_bucketing``);
  * with ``paging.prefill_chunk`` set, prompts longer than the chunk
    *chunk-prefill*: each engine step advances every mid-prefill slot by
    one bounded row panel (``lm.prefill_chunk``), interleaved with the
    decode step; chunk shapes stay on the bucket ladder, so the shape
    count is bounded by ``n_buckets + n_chunk_shapes + 1``;
  * with ``paging.table_width_bucketing`` set, the decode block table is
    sliced to the batch's max live pages rounded up to a power of two,
    so executed gather volume tracks live-page traffic — at the cost of
    up to ``log2(max_pages)`` extra decode shapes;
  * every call reads the device at most once (:meth:`Engine._fetch`,
    one ``.cpu()`` of one stacked tensor, counted in
    ``Engine.device_reads``): a decode step its sampled tokens and
    their finite-ness flags, a speculative step those and the accepted
    counts (the accepted rows are then written with the counts as host
    integers), an admission or a final chunk its first token and flag,
    an intermediate chunk nothing. Host operands reach the device by
    non-blocking copies (``runtime.to_device``), and the scatters'
    targets are built from them on the host
    (``attention.chunk_targets``); sequence lengths are mirrored on the
    host.

On top of that sits the **request lifecycle and fault-tolerance layer**
(DESIGN.md §7). Every submitted rid is guaranteed exactly one terminal
:class:`Completion` whose ``status`` says how it ended:

  ``ok``       hit its ``max_new`` budget
  ``eos``      sampled the EOS token
  ``length``   hit the engine's ``max_len`` KV cap
  ``deadline`` exceeded its ``Request.deadline_s`` (queued or running)
  ``cancelled`` :meth:`Engine.cancel` was called on it
  ``preempted_requeued``  returned unfinished (``run`` hit ``max_steps``
               or :meth:`Engine.shutdown` drained the engine); carries
               the tokens produced so far and may be resubmitted
  ``failed``   quarantined (NaN/inf logits), unserviceable on this pool,
               or gave up after repeated faults

The machinery behind the guarantee:

  * **Transactional admission** — every multi-page mutation of
    :class:`~repro_torch.serve.paging.PagePool` (admit+ensure, chunk
    growth, decode tail allocation) runs inside ``begin``/``commit``/
    ``rollback``, so an allocation failure mid-admission restores the
    exact prior allocator state instead of leaking half an admission.
  * **Preemption** — when a deadlined queue head is blocked behind
    deadline-free (or laxer) residents, the youngest such slot is
    preempted: its pages roll back to the free list and the request
    re-enqueues *with the tokens it already produced*; re-admission
    replays ``prompt + tokens[:-1]`` through the ordinary (chunked)
    prefill path and greedily re-derives the last token, so the resumed
    greedy stream is bit-identical to the unpreempted one. Pure
    pool-pressure preemption is opt-in via ``preempt_patience``.
  * **Recovery boundary** — the pools are written in place, so a
    mid-step exception may leave them half written; ``run`` catches
    step/admit/chunk failures, rebuilds device state (fresh paged
    cache, zeroed host mirrors) and replays every live request from its
    host-side record. A request that keeps failing retires as
    ``failed`` instead of looping.
  * **NaN quarantine** — the decode step computes per-slot finite-ness
    of the logits on the device (fetched with the sampled tokens in
    the same transfer); a poisoned slot retires as ``failed`` instead
    of corrupting the lockstep batch. With no poisoning the guard is
    bitwise inert.
  * **Fault injection** — a seeded
    :class:`~repro_torch.serve.faults.FaultPlan` drives all of the
    above deterministically, keyed on ``Engine.clock`` (one tick per
    run-loop iteration, monotonic across ``run`` calls).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import quant, runtime
from repro_torch.core.types import ModelConfig, PagingConfig
from repro_torch.models import lm
from repro_torch.serve import sampling, spec
from repro_torch.serve.faults import AllocFault, FaultPlan, StepFault
from repro_torch.serve.placement import SingleDevice
from repro_torch.serve.paging import (PagePool, bucket_for, chunk_schedule,
                                      default_buckets, page_aligned_size,
                                      spec_ladder, supports_bucketing)
from repro_torch.serve.prefix_cache import PrefixCache

TERMINAL_STATUSES = ("ok", "eos", "length", "deadline", "cancelled",
                     "preempted_requeued", "failed")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32 — host-resident.
    #                                  submit() accepts a tensor and
    #                                  normalises it to numpy ONCE at
    #                                  the host boundary; admission and
    #                                  resume then slice it with no
    #                                  device transfer
    max_new: int = 32
    temperature: Optional[float] = None   # None => engine default
    deadline_s: Optional[float] = None    # seconds after submission by
    #                                  which the request must finish;
    #                                  None => no deadline

@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]
    prompt_len: int
    latency_s: float                 # submission -> retirement
    ttft_s: float = 0.0              # submission -> first token (queue
    #                                  wait + prefill, the serving TTFT)
    queue_s: float = 0.0             # submission -> first admission: the
    #                                  queue-wait component of ttft_s,
    #                                  split out so a bench can attribute
    #                                  a prefix-cache hit's TTFT win to
    #                                  skipped compute rather than a
    #                                  shorter queue (never-admitted
    #                                  requests report their full latency)
    itl_s: List[float] = dataclasses.field(default_factory=list)
    #                                  inter-token gaps (len(tokens) - 1
    #                                  entries): the stall a co-resident
    #                                  prefill admission injects shows up
    #                                  here as a latency spike
    status: str = "ok"               # terminal status, one of
    #                                  TERMINAL_STATUSES


@dataclasses.dataclass
class _Pending:
    """A queued unit of work: a fresh request, or a preempted/recovered
    one carrying the tokens it already produced. Re-admission replays
    ``prompt + prior[:-1]`` through the ordinary prefill path and the
    prefill sample re-derives ``prior[-1]`` (bit-identical under
    greedy), so resume needs no special device machinery."""
    req: Request
    t0: float                        # submission wall time (TTFT base)
    t_dl: float = 0.0                # submission time the ranks agree on
    #                                  (the deadline base: rank 0's clock
    #                                  under tensor parallelism, t0 else)
    prior: List[int] = dataclasses.field(default_factory=list)
    prior_times: List[float] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None     # preserved across preemption: the
    #                                  first token was already delivered
    admit_t: Optional[float] = None  # first admission wall time (queue_s
    #                                  base), preserved across preemption
    finished: bool = False           # exactly-once terminal guard


@dataclasses.dataclass
class _ChunkState:
    """Per-slot chunked-prefill progress (host side)."""
    pend: _Pending
    prompt: np.ndarray               # (S,) int32 effective prompt
    sched: List[tuple]               # remaining (offset, len, shape)
    #                                  panels (paging.chunk_schedule)
    hit: int = 0                     # prompt tokens served by shared
    #                                  prefix-cache pages (sched covers
    #                                  only positions >= hit)
    cow: bool = False                # the page at hit // page_size is a
    #                                  COW-pending shared page: remap it
    #                                  before the first chunk writes in


def accept_drafts(safe, tokens, temps, draft_len, gen, *, top_k=0,
                  top_p=1.0):
    """The verify step's acceptance (DESIGN.md §10) over finite panel
    logits ``safe`` (B, 1 + k_pad, V) of the panel ``tokens`` (the last
    committed token, then the padded draft), per-row ``temps`` (B,) and
    true draft lengths ``draft_len`` (B,): ``(next, n_acc)``, the token
    the step emits after the accepted prefix and that prefix's length.
    Draws come from ``gen``."""
    b, sc = tokens.shape
    kpad = sc - 1
    dev = tokens.device
    t = temps.to(safe.dtype).expand(b)
    greedy_row = t < sampling.GREEDY_EPS
    # the exact distribution decode would sample position i from
    filt = sampling.filter_logits(
        safe / torch.clamp(t, min=sampling.GREEDY_EPS)[:, None, None],
        top_k=top_k, top_p=top_p)
    probs = torch.softmax(filt, dim=-1)
    draft = tokens[:, 1:]
    p_draft = torch.gather(probs[:, :kpad], -1, draft[..., None])[..., 0]
    u = torch.rand((b, kpad), generator=gen, device=dev)
    amax = torch.argmax(safe, dim=-1)
    # standard rejection rule with a deterministic drafter
    # (q = 1 on the proposed token): accept d_i with prob
    # p_i(d_i); greedy rows accept exactly the argmax chain.
    # n_acc = longest accepted prefix (cumprod-sum).
    acc = torch.where(greedy_row[:, None], draft == amax[:, :kpad],
                      u < p_draft)
    acc &= torch.arange(kpad, device=dev)[None, :] < draft_len[:, None]
    n_acc = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    # the step's own emitted token comes from position n_acc: on
    # rejection the drafted token is masked out and the leftover
    # mass renormalised (with the acceptance test this keeps
    # decode's distribution exact); on a full accept it is the
    # bonus token scored for free by the panel's last row
    at = torch.arange(b, device=dev)
    raw_at = safe[at, n_acc]
    f_at = filt[at, n_acc]
    rej = n_acc < draft_len
    d_rej = torch.gather(draft, 1,
                         torch.clamp(n_acc, max=kpad - 1)[:, None])[:, 0]
    v = safe.shape[-1]
    masked = ((rej & ~greedy_row)[:, None]
              & (torch.arange(v, device=dev)[None, :] == d_rej[:, None]))
    f_at = torch.where(masked, -torch.inf, f_at)
    toks = sampling.categorical(f_at, gen)
    nxt = torch.where(greedy_row, sampling.greedy(raw_at), toks)
    return nxt, n_acc


class Engine:
    """The serving engine over the port's parameter tree (``lm.init_lm``
    or ``convert.from_jax_params``), on ``device``: the card unless the
    caller asks for ``device="cpu"`` (with no card present it raises at
    construction). ``params`` must already live there."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 512, eos_id: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 paging: PagingConfig = PagingConfig(),
                 buckets: Optional[List[int]] = None,
                 cache_dtype=None, placement=None,
                 faults: Optional[FaultPlan] = None,
                 preempt_patience: Optional[int] = None,
                 max_recoveries: int = 8, max_rid_failures: int = 3,
                 device="cuda"):
        self.placement = placement or SingleDevice()
        # fail at construction, never mid-step: an indivisible mesh axis
        # would otherwise surface as a shape error deep in a model call
        self.placement.validate(cfg)
        self.device = runtime.resolve_device(device)
        embed = params["embed"]
        leaf = embed["q"] if quant.is_quantized(embed) else embed
        if leaf.device.type != self.device.type:
            raise ValueError(f"the parameters live on {leaf.device}, the "
                             f"engine runs on {self.device}: move them "
                             "there first")
        self.cfg = cfg
        # the config the model calls run against: per-rank heads / d_ff
        # under tensor parallelism, cfg itself on one device
        self.rcfg = self.placement.compute_cfg(cfg)
        self.n_slots, self.max_len, self.eos_id = n_slots, max_len, eos_id
        self.temperature = temperature
        # engine-level static top-k / nucleus filter: one decode/verify
        # shape whatever the knobs; greedy rows (per-row temperature <
        # GREEDY_EPS) sample from the raw logits and are bit-identical
        # with and without the filter
        self.top_k, self.top_p = int(top_k), float(top_p)
        # every draw of the engine (sampling, the verify step's uniform
        # draws and categorical) comes from this one generator
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        ps = page_aligned_size(paging.page_size, cfg)
        self.page_size = ps
        self.max_pages = -(-max_len // ps)
        self._n_pages = paging.n_pages or n_slots * self.max_pages
        self.pool = PagePool(self._n_pages, ps, n_slots, self.max_pages)
        self._twb = paging.table_width_bucketing
        # KV-cache dtype: explicit override > the embed leaf's dtype >
        # cfg.dtype. A weight-only int8 tree (quant.quantize_tree) stores
        # the embed leaf as a {"q","s"} dict, which has no one dtype —
        # quantized trees fall back to the config dtype.
        if cache_dtype is not None:
            dtype = lm.DTYPES.get(cache_dtype, cache_dtype)
        elif quant.is_quantized(params["embed"]):
            dtype = lm.DTYPES[cfg.dtype]
        else:
            dtype = params["embed"].dtype
        self.cache_dtype = dtype
        # the placement owns the parameters and the pools (this rank's
        # shard and KV heads under tensor parallelism)
        self.params = self.placement.prepare_params(params, cfg)
        self.cache = self.placement.prepare_cache(cfg, self._init_cache)
        if buckets is not None:
            if not supports_bucketing(cfg):
                raise ValueError(
                    f"{cfg.name} carries recurrent/MoE prefill state: "
                    "padded buckets are inexact, prompts must prefill at "
                    "exact lengths (omit `buckets`)")
            self.buckets: Optional[List[int]] = sorted(buckets)
            if self.buckets[-1] < max_len:
                raise ValueError(
                    f"largest bucket {self.buckets[-1]} must cover "
                    f"max_len={max_len} (every admissible prompt length)")
        elif supports_bucketing(cfg):
            self.buckets = default_buckets(max_len, paging.min_bucket)
        else:
            self.buckets = None      # exact-length prefill (recurrent/MoE)

        self.prefill_chunk = paging.prefill_chunk
        if self.prefill_chunk:
            if self.buckets is None:
                raise ValueError(
                    f"{cfg.name} carries recurrent/MoE prefill state: a "
                    "prompt cannot be split across chunk forwards "
                    "(chunked prefill needs pure causal-attention KV)")
            if self.prefill_chunk not in self.buckets:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must sit on the "
                    f"bucket ladder {self.buckets} (chunk shapes reuse "
                    "the ladder to bound the compile count)")

        # radix-tree prefix cache (PR 8): admission maps fully shared
        # prompt pages into the new slot's table (zero prefill FLOPs)
        # and chunked prefill replays only the uncached suffix.
        # Sliding-window archs are silently excluded — the one per-slot
        # block table is shared across layers, and a ring write through
        # a shared page would clobber every other mapper's cached
        # prefix — as are bucketing-incapable archs (no chunk path).
        self.prefix_cache: Optional[PrefixCache] = None
        self.prefill_token_budget = paging.prefill_token_budget
        windowed = any(blk.mixer == "attn" and blk.window
                       for stage in cfg.stages() for blk in stage.body)
        if paging.prefix_cache and self.buckets is not None \
                and not windowed:
            if not self.prefill_chunk:
                raise ValueError(
                    "prefix_cache requires prefill_chunk: cache hits "
                    "prefill only the uncached suffix through the chunk "
                    "program (suffix shapes stay on the bucket ladder, "
                    "keeping the compile bound)")
            self.prefix_cache = PrefixCache(self.pool)
            self.pool.reclaimer = self.prefix_cache

        # self-speculative decode (DESIGN.md §10): a host-side
        # prompt-lookup drafter proposes up to spec_k tokens per slot and
        # a batched verify step scores the whole panel through the chunk
        # path, amortising decode's per-step weight stream over every
        # accepted token. Panel widths pad up the documented spec ladder
        # so the verify step sees len(ladder) shapes, no more.
        self.spec_k = paging.speculate_k
        self.spec_ladder = spec_ladder(self.spec_k)
        if self.spec_k:
            if self.buckets is None:
                raise ValueError(
                    f"{cfg.name} carries recurrent/MoE prefill state: a "
                    "verify panel cannot score draft tokens in one "
                    "forward (speculation needs pure causal-attention "
                    "KV, like chunked prefill)")
            if self._twb:
                raise ValueError(
                    "speculate_k is mutually exclusive with "
                    "table_width_bucketing: the decode width ladder "
                    "would multiply the spec k-ladder in the compile "
                    "bound — speculative steps ship full-width tables")

        # the recurring step operands live on the device; the host
        # mirrors lengths (_host_len) and the shipped tables
        self._zero_device_state()
        self._host_len = np.zeros((n_slots,), np.int64)
        self._tables_host = self.pool.tables.copy()
        self._tables_dev = self._put(self._tables_host)
        self._tables_key = (self.pool.version, frozenset(), self.max_pages)
        self.active: List[Optional[_Pending]] = [None] * n_slots
        self.chunking: Dict[int, _ChunkState] = {}   # slot -> progress
        self.out_tokens: List[List[int]] = [[] for _ in range(n_slots)]
        self.started = [0.0] * n_slots
        self.ttft = [0.0] * n_slots
        self._token_times: List[List[float]] = [[] for _ in range(n_slots)]
        self.queue: deque = deque()          # of _Pending
        self._prefill_lens: set = set()   # distinct padded lengths seen
        self._chunk_shapes: set = set()   # distinct chunk panel shapes
        self._step_widths: set = set()    # distinct decode table widths
        self._spec_shapes: set = set()    # distinct verify panel widths
        self._stepped = False
        self.device_reads = 0        # device->host reads (_fetch)
        self.completed: List[Completion] = []
        self.kv_trace: List[List[int]] = []   # per-step live slot lengths

        # lifecycle / fault-tolerance state
        self.faults = faults if faults is not None else FaultPlan()
        self.clock = 0               # run-loop tick, monotonic across runs
        self.preempt_patience = preempt_patience
        self.max_recoveries = max_recoveries
        self.max_rid_failures = max_rid_failures
        self.stats = {"preemptions": 0, "recoveries": 0,
                      "recompute_tokens": 0, "nan_quarantined": 0,
                      "alloc_faults": 0,
                      # prefix-cache counters (PR 8)
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      "prompt_tokens": 0, "cow_copies": 0,
                      "cow_in_place": 0, "share_deferrals": 0,
                      # token-budgeted chunk scheduling
                      "budget_deferred_chunks": 0,
                      # self-speculative decoding (PR 10): steps that
                      # carried drafts, tokens drafted, tokens accepted
                      "spec_steps": 0, "spec_slot_steps": 0,
                      "spec_drafted": 0, "spec_accepted": 0}
        self.page_trace: List[tuple] = []   # per-step (unique, mapped)
        self._share_deferred = False
        self.errors: List[str] = []  # reprs of recovered exceptions
        self._terminal: set = set()  # rids with a terminal completion
        self._fail_counts: Dict[int, int] = {}   # rid -> recovery replays
        self._admit_seq = [0] * n_slots          # admission order (age)
        self._seq = 0
        self._head_blocked = 0       # consecutive iters the head waited
        # the model calls run through the placement (as this rank of its
        # group under tensor parallelism; unchanged on one device)
        self._step = self.placement.wrap(self._step)
        self._admit = self.placement.wrap(self._admit)
        self._chunk = self.placement.wrap(self._chunk)
        self._spec = self.placement.wrap(self._spec)

    # ------------------------------------------------------------------

    def _init_cache(self, cfg: ModelConfig):
        return lm.init_paged_cache(cfg, self.n_slots, self.max_len,
                                   page_size=self.page_size,
                                   n_pages=self._n_pages,
                                   dtype=self.cache_dtype,
                                   device=self.device)

    def _zero_device_state(self):
        """The step operands the device keeps: lengths, the last token
        of each slot and the per-slot temperatures, zeroed. (A host
        value goes into them by ``fill_``: an item assignment of a
        Python number copies it from the host and waits for the card.)"""
        dev, n = self.device, self.n_slots
        self.lengths = torch.zeros(n, dtype=torch.int32, device=dev)
        self._last = torch.zeros(n, 1, dtype=torch.int64, device=dev)
        self._temps = torch.zeros(n, dtype=torch.float32, device=dev)

    def _put(self, host) -> torch.Tensor:
        """A host array on the device, by a non-blocking copy."""
        return runtime.to_device(host, self.device)

    def _fetch(self, *values) -> np.ndarray:
        """The call's ONE device->host read: ``values`` (integer or bool
        tensors of one shape) stacked and read back together."""
        self.device_reads += 1
        return torch.stack([v.to(torch.int64) for v in values]).cpu().numpy()

    # -- the step programs ------------------------------------------------

    @torch.no_grad()
    def _step(self, active, poison):
        """One lockstep paged decode step: ``(next, bad)``, lengths and
        the pools updated on the device."""
        logits, self.cache = lm.decode_step(
            self.params, self.cache, self._last, self.lengths, self.rcfg,
            pages=self._tables_dev)
        # fault injection + containment: `poison` overwrites a slot's
        # logits with NaN (chaos testing the guard below); `bad` flags
        # any non-finite row so the host can quarantine it. With poison
        # all-False and finite logits both `where`s are identity — the
        # guarded step is bitwise identical to the unguarded one.
        logits = torch.where(poison[:, None], torch.nan, logits)
        bad = ~torch.isfinite(logits).all(dim=-1)
        safe = torch.where(bad[:, None], 0.0, logits)
        nxt = sampling.sample(safe, self.gen, temperature=self._temps,
                              top_k=self.top_k, top_p=self.top_p)
        # idle / mid-prefill slots stay parked at length 0 writing
        # their private scratch page
        self.lengths = torch.where(active, self.lengths + 1, 0)
        return nxt, bad

    @torch.no_grad()
    def _admit(self, tokens, slot, pages_row, plen, temp):
        """Bucketed one-shot prefill of one prompt into ``slot``, its
        paged insert and its first token: ``(first, bad)``."""
        logits, states = lm.prefill_states(self.params, tokens, self.rcfg,
                                           last_pos=plen)
        self.cache = lm.insert_prefill(self.rcfg, self.cache, states,
                                       slot=slot, pages=pages_row,
                                       plen=plen, page_size=self.page_size)
        bad = ~torch.isfinite(logits).all()
        safe = torch.where(bad, 0.0, logits)
        first = sampling.sample(safe, self.gen, temperature=temp,
                                top_k=self.top_k, top_p=self.top_p)[0]
        self.lengths[slot].fill_(plen)
        self._last[slot, 0] = first
        return first, bad

    @torch.no_grad()
    def _chunk(self, tokens, offset, chunk_len, slot, pages_row, temp,
               cow_src, cow_dst):
        """One chunked-prefill panel of ``slot``: ``(token, bad)``."""
        # copy-on-write seam: before the first chunk that writes into a
        # partially-shared prefix page, the host remaps the table row
        # and passes the (src, dst) physical ids here; every other chunk
        # passes (0, 0), the identity
        self.cache = lm.cow_copy(self.cache, cow_src, cow_dst)
        logits, self.cache = lm.prefill_chunk(
            self.params, self.cache, tokens, self.rcfg, offset=offset,
            chunk_len=chunk_len, pages=pages_row[None])
        # a NaN written by an *earlier* chunk propagates through the
        # prefix-page attention into these logits, so checking the
        # final chunk's flag covers the whole chunked prefill
        bad = ~torch.isfinite(logits).all()
        safe = torch.where(bad, 0.0, logits)
        tok = sampling.sample(safe, self.gen, temperature=temp,
                              top_k=self.top_k, top_p=self.top_p)[0]
        # every call samples and books the slot's length, but the host
        # only *fetches* the token (and flips the slot active) on the
        # final chunk — until then decode keeps the slot masked out and
        # re-zeroes these
        self.lengths[slot].fill_(offset + chunk_len)
        self._last[slot, 0] = tok
        return tok, bad

    @torch.no_grad()
    def _spec(self, tokens, active, poison, draft_len):
        """Speculative verify (DESIGN.md §10): ``tokens`` is a
        (B, 1 + k_pad) panel — the last committed token followed by
        each slot's padded draft. One chunk-style forward scores every
        position against the paged prefix WITHOUT writing pages, and
        acceptance runs on the device. Returns ``(next, n_acc, bad,
        states)``; the caller writes the accepted prefix
        (:meth:`_insert_accepted`) once the counts are on the host, so a
        rejected draft never touches the pool (exact for sliding-window
        rings, which a write-then-undo could not be)."""
        sc = tokens.shape[1]
        dev = tokens.device
        # inactive slots score a width-1 panel at offset 0 (the
        # scratch-page decode equivalent); a width-0 row would leave
        # both attention partials fully masked
        clen = torch.where(active, 1 + draft_len, 1)
        logits, states = lm.verify_states(
            self.params, self.cache, tokens, self.rcfg, offset=self.lengths,
            chunk_len=clen, pages=self._tables_dev)
        logits = torch.where(poison[:, None, None], torch.nan, logits)
        rows = torch.arange(sc, device=dev)[None, :]
        finite = torch.isfinite(logits).all(dim=-1)
        bad = ~(finite | (rows >= clen[:, None])).all(dim=-1)
        safe = torch.where(bad[:, None, None], 0.0, logits)
        nxt, n_acc = accept_drafts(safe, tokens, self._temps, draft_len,
                                   self.gen, top_k=self.top_k,
                                   top_p=self.top_p)
        n_acc = torch.where(active, n_acc, 0)
        self.lengths = torch.where(active, self.lengths + 1 + n_acc, 0)
        return nxt, n_acc, bad, states

    @torch.no_grad()
    def _insert_accepted(self, states, offset, n_keep):
        """Write ONLY the committed token plus the accepted prefix of a
        verify panel (host ``offset`` and ``n_keep``: no device read)."""
        self.cache = lm.insert_verify(self.rcfg, self.cache, states,
                                      pages=self._tables_host,
                                      offset=offset, n_keep=n_keep)

    def submit(self, req: Request):
        if not isinstance(req.prompt, np.ndarray):
            # the one sanctioned device->host transfer for a prompt:
            # once per submission, never per admission attempt
            p = req.prompt
            if isinstance(p, torch.Tensor):
                p = p.cpu().numpy()
            req = dataclasses.replace(req, prompt=np.asarray(p, np.int32))
        plen = int(req.prompt.shape[0])
        if not 0 < plen <= self.max_len:
            raise ValueError(f"prompt of length {plen} cannot decode "
                             f"within max_len={self.max_len}")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new} "
                             "(every request produces the prefill token)")
        if plen == self.max_len and req.max_new > 1:
            # prefill-only request: admission writes exactly max_len KV
            # rows and the prefill-sampled token retires it — there is
            # no in-bounds cache row left for a decode step to write
            req = dataclasses.replace(req, max_new=1)
        t0 = time.perf_counter()
        self.queue.append(_Pending(req=req, t0=t0,
                                   t_dl=self.placement.agreed(t0)))

    def compile_counts(self) -> dict:
        """Distinct shapes of the serving entry points — the host-side
        proxy the JAX engine falls back to (distinct padded prefill
        lengths / chunk panel shapes / decode table widths / verify
        panel widths, one compiled program each there; here, what CUDA
        graph captures would be keyed on). Bounded by ``n_buckets +
        n_chunk_shapes + 1`` plus ``len(spec_ladder(K))``. The ``spec``
        entry appears only when speculation is configured. The auditor
        (``repro_torch.analysis.compile_bound``) holds these against the
        static enumeration and the shapes the step programs really took."""
        counts = {"prefill": len(self._prefill_lens),
                  "chunk": len(self._chunk_shapes),
                  "step": len(self._step_widths)}
        if self.spec_k:
            counts["spec"] = len(self._spec_shapes)
        return counts

    def audit_entry_points(self):
        """The step programs with arguments shaped as the run loop passes
        them, for the auditor (``repro_torch.analysis``). Each entry is
        ``(name, fn, args, host)``: ``host`` the positions of the
        operands the program takes on the host by design (Python numbers
        and numpy block-table rows, from which the paged writes build
        their targets with no device read); every other operand is a
        tensor on the engine's device.

        The JAX package's auditor lowers these without running them; the
        port's auditor RUNS them, and they write the pools in place:
        every slot idle, the prefill and chunk aimed at slot 0's table
        row (its scratch page on a fresh engine). Audit an engine before
        it serves, and restore its step state after
        (:meth:`audit_state` / :meth:`restore_audit_state`)."""
        off = self._put(np.zeros((self.n_slots,), bool))
        row = self.pool.tables[0].copy()
        temp = float(self.temperature)
        entries = [("step", self._step, (off, off), ())]
        bl = self.buckets[0] if self.buckets else min(8, self.max_len)
        entries.append(
            ("prefill", self._admit,
             (self._put(np.zeros((1, bl), np.int64)), 0, row, bl, temp),
             (1, 2, 3, 4)))
        if self.prefill_chunk:
            c = self.prefill_chunk
            entries.append(
                ("chunk", self._chunk,
                 (self._put(np.zeros((1, c), np.int64)), 0, c, 0, row, temp,
                  0, 0), (1, 2, 3, 4, 5, 6, 7)))
        if self.spec_k:
            w = 1 + self.spec_ladder[0]
            entries.append(
                ("spec", self._spec,
                 (self._put(np.zeros((self.n_slots, w), np.int64)), off, off,
                  self._put(np.zeros((self.n_slots,), np.int64))), ()))
        return entries

    def audit_state(self):
        """The step state the entry points change: lengths, the last
        tokens, the temperatures."""
        return tuple(t.clone() for t in (self.lengths, self._last,
                                         self._temps))

    def restore_audit_state(self, state):
        self.lengths, self._last, self._temps = state

    def _req_temp(self, req: Request) -> float:
        return self.temperature if req.temperature is None else \
            req.temperature

    # -- lifecycle ------------------------------------------------------

    def _finish(self, pend: _Pending, tokens: List[int], status: str, *,
                ttft: float = 0.0, itl: Optional[List[float]] = None):
        """The single exit point: every accepted unit of work passes
        through here exactly once, whatever ended it."""
        assert status in TERMINAL_STATUSES, status
        assert not pend.finished, \
            f"rid {pend.req.rid} reached a second terminal completion"
        pend.finished = True
        self._terminal.add(pend.req.rid)
        now = time.perf_counter()
        self.completed.append(Completion(
            rid=pend.req.rid, tokens=tokens,
            prompt_len=int(pend.req.prompt.shape[0]),
            latency_s=now - pend.t0,
            ttft_s=ttft if ttft else (pend.ttft or 0.0),
            queue_s=(pend.admit_t - pend.t0
                     if pend.admit_t is not None else now - pend.t0),
            itl_s=itl if itl is not None else
            [b - a for a, b in zip(pend.prior_times,
                                   pend.prior_times[1:])],
            status=status))

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is (queued, mid-prefill, or
        decoding); returns False if the rid is unknown or already
        terminal. The completion carries any tokens already produced."""
        for slot, pend in enumerate(self.active):
            if pend is not None and pend.req.rid == rid:
                self._retire(slot, "cancelled")
                return True
        for slot, st in list(self.chunking.items()):
            if st.pend.req.rid == rid:
                del self.chunking[slot]
                self.pool.release(slot)
                self._finish(st.pend, list(st.pend.prior), "cancelled")
                return True
        for pend in list(self.queue):
            if pend.req.rid == rid:
                self.queue.remove(pend)
                self._finish(pend, list(pend.prior), "cancelled")
                return True
        return False

    def shutdown(self) -> List[Completion]:
        """Drain the engine: every outstanding rid gets a terminal
        ``preempted_requeued`` completion carrying its tokens so far
        (resubmittable), and the engine returns to a clean, fully
        serviceable state."""
        self._flush_outstanding("preempted_requeued")
        return self.completed

    def _flush_outstanding(self, status: str):
        """Terminal-complete every live slot and queued entry (slots in
        admission order, then queue order), releasing all pool pages."""
        live = sorted((s for s in range(self.n_slots)
                       if self.active[s] is not None or s in self.chunking),
                      key=lambda s: self._admit_seq[s])
        for slot in live:
            if self.active[slot] is not None:
                self._retire(slot, status)
            else:
                st = self.chunking.pop(slot)
                self.pool.release(slot)
                self._finish(st.pend, list(st.pend.prior), status)
        while self.queue:
            pend = self.queue.popleft()
            self._finish(pend, list(pend.prior), status)

    def _sweep_deadlines(self):
        # one clock reading for the sweep, the same on every rank
        now = self.placement.agreed(time.perf_counter())

        def over(p: _Pending) -> bool:
            return (p.req.deadline_s is not None
                    and now - p.t_dl > p.req.deadline_s)

        for slot in range(self.n_slots):
            pend = self.active[slot]
            if pend is not None and over(pend):
                self._retire(slot, "deadline")
        for slot in list(self.chunking):
            st = self.chunking[slot]
            if over(st.pend):
                del self.chunking[slot]
                self.pool.release(slot)
                self._finish(st.pend, list(st.pend.prior), "deadline")
        if any(over(p) for p in self.queue):
            keep: deque = deque()
            for pend in self.queue:
                if over(pend):
                    self._finish(pend, list(pend.prior), "deadline")
                else:
                    keep.append(pend)
            self.queue = keep

    # -- preemption -----------------------------------------------------

    def _pend_at(self, slot: int) -> _Pending:
        return self.active[slot] if self.active[slot] is not None \
            else self.chunking[slot].pend

    def _preempt_slot(self, slot: int):
        """Evict a live slot: pages back to the free list, the request
        back onto the queue (behind the blocked head) carrying its
        produced tokens for bit-identical greedy resume."""
        if self.active[slot] is not None:
            pend = self.active[slot]
            new = _Pending(req=pend.req, t0=pend.t0, t_dl=pend.t_dl,
                           prior=list(self.out_tokens[slot]),
                           prior_times=list(self._token_times[slot]),
                           ttft=self.ttft[slot], admit_t=pend.admit_t)
            self.active[slot] = None
            self.out_tokens[slot] = []
            self._token_times[slot] = []
            self._host_len[slot] = 0
        else:
            # chunked prefill in flight: its pages roll back and the
            # prompt replays from the top (no tokens produced yet)
            new = self.chunking.pop(slot).pend
        self.pool.release(slot)
        self.stats["preemptions"] += 1
        self.stats["recompute_tokens"] += (int(new.req.prompt.shape[0])
                                           + max(len(new.prior) - 1, 0))
        if self.queue:
            self.queue.insert(1, new)    # behind the blocked head
        else:
            self.queue.appendleft(new)

    def _maybe_preempt(self) -> bool:
        """Called when the queue head could not admit this iteration.
        Deadline inversion (a deadlined head starved by deadline-free or
        laxer residents) always preempts; pure pool pressure preempts
        only after `preempt_patience` consecutive blocked iterations."""
        if not self.queue:
            return False
        live = [s for s in range(self.n_slots)
                if self.active[s] is not None or s in self.chunking]
        if not live:
            return False
        head = self.queue[0]
        if head.req.deadline_s is not None:
            def abs_dl(p: _Pending) -> float:
                return (p.t_dl + p.req.deadline_s
                        if p.req.deadline_s is not None else float("inf"))
            cands = [s for s in live if abs_dl(self._pend_at(s))
                     > abs_dl(head)]
            if cands:
                self._preempt_slot(max(cands,
                                       key=lambda s: self._admit_seq[s]))
                return True
        if (self.preempt_patience is not None
                and self._head_blocked >= self.preempt_patience):
            self._head_blocked = 0
            self._preempt_slot(max(live,
                                   key=lambda s: self._admit_seq[s]))
            return True
        return False

    # -- admission ------------------------------------------------------

    def _effective_prompt(self, pend: _Pending) -> np.ndarray:
        """The token rows admission must (re)compute: the prompt, plus —
        when resuming a preempted/recovered request — every produced
        token but the last, whose KV row was never written (the prefill
        sample re-derives it)."""
        p = np.asarray(pend.req.prompt, np.int32)
        if pend.prior:
            p = np.concatenate(
                [p, np.asarray(pend.prior[:-1], np.int32)])
        return p

    def _worst_case(self, pend: _Pending) -> int:
        # KV rows ever written: the prompt plus one row per decode step
        # (the final sampled token is returned, never written). Resume
        # preserves it: prior tokens move rows from the decode side to
        # the prompt side without changing the sum.
        plen = int(pend.req.prompt.shape[0])
        return min(self.max_len, plen + pend.req.max_new - 1)

    def _make_room(self, draws: int):
        """Evict LRU prefix-cache branches until the free list covers
        the ``draws`` page draws the caller is about to make. Must run
        BEFORE the transaction bracketing the draws: a rollback
        restores refcounts but cannot resurrect a dropped tree node, so
        an in-transaction eviction would strand the page forever."""
        if self.prefix_cache is not None and draws > len(self.pool.free):
            self.prefix_cache.reclaim(draws - len(self.pool.free))

    def _prefix_match(self, prompt: np.ndarray):
        """Walk the prefix cache for an admission candidate: returns
        ``(shared_pages, partial, hit_tokens)`` — physical ids covering
        fully-cached prompt pages, an optional ``(page, keep)`` COW
        candidate for the next partially-shared page, and the total
        cached token count. The hit is capped at ``plen - 1`` so at
        least one suffix token remains: its chunk forward produces the
        prompt's first-token logits (a fully-cached page-aligned prompt
        demotes its last full page to a COW partial)."""
        if self.prefix_cache is None:
            return [], None, 0
        plen = int(prompt.shape[0])
        pages, partial = self.prefix_cache.match(prompt)
        ps = self.page_size
        cap = plen - 1
        if len(pages) * ps > cap:
            partial = (pages[-1], cap - (len(pages) - 1) * ps)
            pages = pages[:-1]
        keep = partial[1] if partial is not None else 0
        keep = min(keep, cap - len(pages) * ps)
        partial = (partial[0], keep) if partial is not None and keep > 0 \
            else None
        hit = len(pages) * ps + (partial[1] if partial else 0)
        return pages, partial, hit

    def _share_defer(self, prompt: np.ndarray, hit: int) -> bool:
        """Duplicate-prefix admission race (two near-identical prompts
        in flight): True when some mid-prefill slot is computing a
        longer shared prefix than the tree serves today — by the time
        that provider activates (inserting its pages), re-matching maps
        them for free instead of recomputing them into private pages."""
        if self.prefix_cache is None:
            return False
        plen = int(prompt.shape[0])
        best = 0
        for st in self.chunking.values():
            m = min(plen, int(st.prompt.shape[0]))
            diff = np.flatnonzero(prompt[:m] != st.prompt[:m])
            n = int(diff[0]) if diff.size else m
            best = max(best, (n // self.page_size) * self.page_size)
        return min(best, plen - 1) > hit

    def _fill_slots(self) -> int:
        # heads that could NEVER admit retire as failed instead of
        # wedging the FIFO forever (the pool simply cannot hold them)
        while self.queue:
            pend = self.queue[0]
            if (self.pool._pages_for(self._worst_case(pend))
                    <= self.pool.n_pages):
                break
            self.queue.popleft()
            self._finish(pend, list(pend.prior), "failed")
        admitted = 0
        self._share_deferred = False
        for slot in range(self.n_slots):
            if (self.active[slot] is not None or slot in self.chunking
                    or not self.queue):
                continue
            pend = self.queue[0]
            req = pend.req
            worst = self._worst_case(pend)
            prompt = self._effective_prompt(pend)
            plen = int(prompt.shape[0])
            shared, partial, hit = self._prefix_match(prompt)
            if self._share_defer(prompt, hit):
                # an in-flight chunked prefill is building a longer
                # shared prefix than the tree holds today: admitting now
                # would recompute its pages into private copies — wait
                # for the provider instead. run() does not count this
                # as a blocked head, so the provider is never preempted
                # to "unblock" the head it is about to serve.
                self._share_deferred = True
                self.stats["share_deferrals"] += 1
                break
            if not self.pool.can_admit_pages(
                    self.pool._pages_for(worst)
                    + (1 if partial is not None else 0)):
                break                # FIFO: wait for pages, don't skip
            self.stats["prompt_tokens"] += plen
            if hit:
                # prefix-cache hit: map the shared pages (refcount++,
                # zero prefill FLOPs for those rows) and schedule only
                # the uncached suffix through the chunk path; a
                # partially-covered boundary page maps COW-pending (its
                # private replacement is the +1 page charged above)
                self.pool.begin()
                self.pool.admit(slot, worst)
                self.pool.map_shared(slot, shared)
                if partial is not None:
                    self.pool.map_shared(slot, [partial[0]],
                                         cow_tail=True)
                self.pool.commit()
                self.queue.popleft()
                if pend.admit_t is None:
                    pend.admit_t = time.perf_counter()
                self._seq += 1
                self._admit_seq[slot] = self._seq
                admitted += 1
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += hit
                self.chunking[slot] = _ChunkState(
                    pend=pend, prompt=prompt,
                    sched=[(hit + o, c, s) for o, c, s in
                           chunk_schedule(plen - hit, self.prefill_chunk,
                                          self.buckets)],
                    hit=hit, cow=partial is not None)
                continue
            if not (self.prefill_chunk and plen > self.prefill_chunk):
                # one-shot prefill draws the whole prompt inside the
                # transaction below — evict LRU branches first (never
                # inside: rollback can't resurrect a dropped node)
                self._make_room(self.pool._pages_for(plen))
            self.pool.begin()
            try:
                self.pool.admit(slot, worst)
                if self.prefill_chunk and plen > self.prefill_chunk:
                    # chunked prefill: reserve now, run the prompt as
                    # row panels across engine steps (_advance_chunks) —
                    # pages are charged per chunk, and admission itself
                    # costs no forward, so co-resident decode slots
                    # never stall on the monolithic bucket program
                    self.pool.commit()
                    self.queue.popleft()
                    if pend.admit_t is None:
                        pend.admit_t = time.perf_counter()
                    self._seq += 1
                    self._admit_seq[slot] = self._seq
                    admitted += 1
                    self.chunking[slot] = _ChunkState(
                        pend=pend, prompt=prompt,
                        sched=chunk_schedule(plen, self.prefill_chunk,
                                             self.buckets))
                    continue
                self.pool.ensure(slot, plen)
            except AllocFault:
                self.pool.rollback()
                self.stats["alloc_faults"] += 1
                break                # retry the same head next iteration
            self.pool.commit()
            self.queue.popleft()
            if pend.admit_t is None:
                pend.admit_t = time.perf_counter()
            self._seq += 1
            self._admit_seq[slot] = self._seq
            admitted += 1
            bl = bucket_for(plen, self.buckets) if self.buckets else plen
            self._prefill_lens.add(bl)
            padded = np.zeros((1, bl), np.int64)
            padded[0, :plen] = prompt
            try:
                first, bad = self._fetch(*self._admit(
                    self._put(padded), slot, self.pool.tables[slot].copy(),
                    plen, float(self._req_temp(req))))
            except Exception:
                # the admit program itself died: restore the pool and
                # the queue head before the recovery boundary takes over,
                # so the rid is never lost and no pages leak
                self.pool.release(slot)
                self.queue.appendleft(pend)
                raise
            if bad:
                # non-finite prefill logits: quarantine before the slot
                # ever joins the lockstep batch
                self.pool.release(slot)
                self.stats["nan_quarantined"] += 1
                self._finish(pend, list(pend.prior), "failed")
                continue
            self._activate(slot, pend, int(first))
        return admitted

    def _activate(self, slot, pend: _Pending, first: int):
        """A slot's prefill (one-shot or final chunk) produced its first
        token: move it to decode, book TTFT, retire if already done. On
        resume, `first` re-derives the last pre-preemption token and the
        earlier ones are restored from the host-side record."""
        req = pend.req
        if self.prefix_cache is not None:
            # adopt the slot's freshly written full prompt pages into
            # the radix tree (shared prefixes keep their incumbent
            # node). Decode never writes them: the decode write lands
            # at page plen_eff // ps, past every *full* prompt page.
            prompt = self._effective_prompt(pend)
            if int(prompt.shape[0]) >= self.page_size:
                self.prefix_cache.insert(prompt, self.pool.tables[slot])
        self._temps[slot].fill_(float(self._req_temp(req)))
        self.active[slot] = pend
        self.out_tokens[slot] = list(pend.prior[:-1]) + [first]
        self.started[slot] = pend.t0
        now = time.perf_counter()
        if pend.ttft is None:
            pend.ttft = now - pend.t0
        self.ttft[slot] = pend.ttft
        self._token_times[slot] = list(pend.prior_times[:-1]) + [now]
        self._host_len[slot] = (int(req.prompt.shape[0])
                                + max(len(pend.prior) - 1, 0))
        # the prefill-sampled token can already finish the request
        if first == self.eos_id:
            self._retire(slot, "eos")
        elif len(self.out_tokens[slot]) >= req.max_new:
            self._retire(slot, "ok")

    def _advance_chunks(self) -> int:
        """Advance mid-prefill slots by one bounded row panel each,
        oldest admission first, under the optional Sarathi-style
        per-step prefill token budget (``paging.prefill_token_budget``:
        padded chunk tokens per step; the oldest slot always advances,
        so prefill can't fully starve — the budget trades prefill
        throughput for decode cadence when cache-miss suffixes of mixed
        lengths pile up). Returns the number of chunks processed."""
        advanced = 0
        spent = 0
        budget = self.prefill_token_budget
        for slot in sorted(self.chunking,
                           key=lambda s: self._admit_seq[s]):
            st = self.chunking[slot]
            off, clen, shape = st.sched[0]
            if budget and advanced and spent + shape > budget:
                self.stats["budget_deferred_chunks"] += 1
                continue
            draws = max(0, self.pool._pages_for(off + clen)
                        - int(self.pool.n_alloc[slot]))
            if st.cow:
                draws += 1           # worst case: the COW private copy
            self._make_room(draws)
            cow_src = cow_dst = 0
            self.pool.begin()
            try:
                self.pool.ensure(slot, off + clen)   # charged per chunk
                if st.cow:
                    # first suffix chunk always writes into the
                    # partially-shared boundary page (off == hit lands
                    # mid-page): remap it before the scatter
                    src, dst = self.pool.cow(slot,
                                             st.hit // self.page_size)
                    if src != dst:
                        cow_src, cow_dst = src, dst
                        self.stats["cow_copies"] += 1
                    else:
                        self.stats["cow_in_place"] += 1
            except AllocFault:
                self.pool.rollback()
                self.stats["alloc_faults"] += 1
                continue             # same panel (and COW) retries next
            self.pool.commit()
            st.cow = False
            if self.prefix_cache is not None:
                for lp in range(off // self.page_size,
                                (off + clen - 1) // self.page_size + 1):
                    pg = int(self.pool.tables[slot, lp])
                    assert self.pool.refs[pg] == 1, (
                        f"chunk would scatter into shared page {pg}")
            self._chunk_shapes.add(shape)
            padded = np.zeros((1, shape), np.int64)
            padded[0, :clen] = st.prompt[off:off + clen]
            tok, bad = self._chunk(
                self._put(padded), off, clen, slot,
                self.pool.tables[slot].copy(),
                float(self._req_temp(st.pend.req)), cow_src, cow_dst)
            spent += shape
            st.sched.pop(0)
            advanced += 1
            if not st.sched:
                # final chunk: the ONLY chunk whose outputs the host
                # fetches — intermediate chunks stay fully async (a NaN
                # they wrote reaches this chunk's logits via the prefix
                # gather, so one flag covers the whole prefill)
                tok, bad = self._fetch(tok, bad)
                del self.chunking[slot]
                if bad:
                    self.pool.release(slot)
                    self.stats["nan_quarantined"] += 1
                    self._finish(st.pend, list(st.pend.prior), "failed")
                else:
                    self._activate(slot, st.pend, int(tok))
        return advanced

    def _retire(self, slot, status: str):
        pend = self.active[slot]
        times = self._token_times[slot]
        self._finish(pend, list(self.out_tokens[slot]), status,
                     ttft=self.ttft[slot],
                     itl=[b - a for a, b in zip(times, times[1:])])
        self.pool.release(slot)
        self.active[slot] = None
        self.out_tokens[slot] = []
        self._token_times[slot] = []
        self._host_len[slot] = 0

    # -- speculation ----------------------------------------------------

    def _draft_budget(self, slot: int) -> int:
        """Max draft length worth proposing for a slot: the engine k-cap,
        the request's remaining ``max_new`` budget (a fully accepted
        draft emits k+1 tokens this step) and the KV cap (the verify
        step writes up to 1+k rows, and the ``max_len`` length
        retirement must keep firing on the final row exactly as plain
        decode would)."""
        pend = self.active[slot]
        return min(self.spec_k,
                   pend.req.max_new - len(self.out_tokens[slot]) - 1,
                   self.max_len - int(self._host_len[slot]) - 2)

    def _build_drafts(self, active):
        """Host side of a speculative step: run the prompt-lookup
        drafter per active slot and pack the (B, 1 + k_pad) verify
        panel — row 0 is the slot's last committed token (the host
        mirror of ``_last``), then its draft, padded up the documented
        spec ladder; true per-slot lengths travel in the ``draft_len``
        operand. Returns ``(panel, draft_len)`` numpy
        arrays, or None when nothing drafted (plain decode step)."""
        if not self.spec_k:
            return None
        props = {}
        for slot in np.flatnonzero(active):
            slot = int(slot)
            k = self._draft_budget(slot)
            if k <= 0:
                continue
            pend = self.active[slot]
            hist = np.concatenate(
                [np.asarray(pend.req.prompt, np.int32),
                 np.asarray(self.out_tokens[slot], np.int32)])
            d = spec.propose(hist, k)
            if d.size:
                props[slot] = d
        if not props:
            return None
        kpad = bucket_for(max(len(d) for d in props.values()),
                          self.spec_ladder)
        panel = np.zeros((self.n_slots, 1 + kpad), np.int32)
        dlen = np.zeros((self.n_slots,), np.int32)
        for slot in np.flatnonzero(active):
            panel[int(slot), 0] = self.out_tokens[int(slot)][-1]
        for slot, d in props.items():
            panel[slot, 1:1 + len(d)] = d
            dlen[slot] = len(d)
        return panel, dlen

    # -- device mirrors -------------------------------------------------

    def _table_width(self) -> int:
        """Decode block-table width: `max_pages`, or — under table-width
        bucketing — the batch max live pages rounded up to a power of
        two, so the per-step gather reads what's live, not the worst
        case. Safe for windowed rings: a slot's allocation always covers
        its length, so the ring never wraps earlier than it would at
        full width."""
        if not self._twb:
            return self.max_pages
        hi = int(self.pool.n_alloc.max(initial=0))
        width = 1 if hi <= 1 else 1 << (hi - 1).bit_length()
        return min(width, self.max_pages)

    def _ship_tables(self):
        """Mirror the block tables to the device when they changed.
        Mid-prefill slots' rows are masked to their scratch page: the
        lockstep decode step still writes a row for every slot, and the
        real table already names live pages the next chunk will fill —
        without the mask the decode write would land in them."""
        width = self._table_width()
        key = (self.pool.version, frozenset(self.chunking), width)
        if key == self._tables_key:
            return
        tables = self.pool.tables[:, :width]
        if self.chunking:
            tables = tables.copy()
            for s in self.chunking:
                tables[s, :] = self.pool.scratch[s]
        self._tables_host = np.array(tables)
        self._tables_dev = self._put(self._tables_host)
        self._tables_key = key

    # -- fault machinery ------------------------------------------------

    def _arm_alloc_fault(self, clock: int):
        """One-shot: the first page draw this iteration raises; later
        draws (and iterations) succeed, so forward progress resumes."""
        fired = []

        def hook():
            if not fired:
                fired.append(True)
                raise AllocFault(
                    f"injected allocation failure @clock {clock}")
        self.pool.alloc_hook = hook

    def _recover(self):
        """Recovery boundary: a step/admit/chunk raised, so the cache
        (written in place) and any in-flight device state are presumed
        lost. Rebuild
        device state from scratch and replay every live request from its
        host-side record — queued at the FRONT in admission order, so
        recompute happens before new work. A rid that keeps tripping the
        boundary retires as `failed` instead of looping forever."""
        while self.pool.in_transaction():
            self.pool.rollback()
        self.cache = self.placement.prepare_cache(self.cfg, self._init_cache)
        self._zero_device_state()
        live = sorted((s for s in range(self.n_slots)
                       if self.active[s] is not None or s in self.chunking),
                      key=lambda s: self._admit_seq[s])
        for slot in reversed(live):      # appendleft keeps admission order
            if self.active[slot] is not None:
                pend = self.active[slot]
                new = _Pending(req=pend.req, t0=pend.t0, t_dl=pend.t_dl,
                               prior=list(self.out_tokens[slot]),
                               prior_times=list(self._token_times[slot]),
                               ttft=self.ttft[slot],
                               admit_t=pend.admit_t)
                self.active[slot] = None
                self.out_tokens[slot] = []
                self._token_times[slot] = []
                self._host_len[slot] = 0
            else:
                new = self.chunking.pop(slot).pend
            self.pool.release(slot)
            rid = new.req.rid
            self._fail_counts[rid] = self._fail_counts.get(rid, 0) + 1
            if self._fail_counts[rid] > self.max_rid_failures:
                self._finish(new, list(new.prior), "failed")
            else:
                self.stats["recompute_tokens"] += (
                    int(new.req.prompt.shape[0])
                    + max(len(new.prior) - 1, 0))
                self.queue.appendleft(new)
        if self.prefix_cache is not None:
            # the rebuilt device cache is zeroed: cached pages no longer
            # hold the bytes their keys promise, so the tree drops too
            self.prefix_cache.reset()
        self._tables_key = None      # force a reship

    # -- the loop -------------------------------------------------------

    def run(self, max_steps: int = 10_000) -> List[Completion]:
        """Continuous-batching loop until queue + slots drain. One
        iteration = deadline sweep + admissions (preempting if a
        deadlined head is starved) + one chunk per mid-prefill slot +
        one lockstep decode step. Hitting `max_steps` does NOT drop
        work: everything outstanding terminal-completes as
        `preempted_requeued` (tokens so far attached) and the engine
        stays serviceable."""
        steps = 0
        recoveries = 0
        self.kv_trace = []           # fresh trace per run (bounded host mem)
        self.page_trace = []         # per-step (unique physical, mapped)
        while (any(a is not None for a in self.active) or self.queue
               or self.chunking):
            if steps >= max_steps:
                self._flush_outstanding("preempted_requeued")
                break
            steps += 1
            clock = self.clock
            self.clock += 1
            if self.faults.alloc_fails(clock):
                self._arm_alloc_fault(clock)
            slow = self.faults.slow_s(clock)
            if slow:
                time.sleep(slow)
            try:
                self._sweep_deadlines()
                admitted = self._fill_slots()
                if self.queue and admitted == 0:
                    # a share-deferred head is *waiting on* a resident
                    # prefill, not starved by it: counting it as blocked
                    # could preempt the very slot about to serve it
                    if not self._share_deferred:
                        self._head_blocked += 1
                        if self._maybe_preempt():
                            admitted += self._fill_slots()
                else:
                    self._head_blocked = 0
                self._advance_chunks()
                self.page_trace.append((self.pool.unique_live(),
                                        self.pool.live_pages()))
                active = np.asarray([a is not None for a in self.active])
                if not active.any():
                    if self.queue or self.chunking:
                        continue     # blocked or mid-prefill: next tick
                    break            # everything admitted retired at once
                drafts = self._build_drafts(active)
                dlen = (drafts[1] if drafts is not None
                        else np.zeros((self.n_slots,), np.int32))
                # rows this step may write: the decode position, plus —
                # speculating — the slot's full draft tail (rejected
                # tail pages roll back after the accepted counts land)
                need = {int(s): int(self._host_len[s]) + 1 + int(dlen[s])
                        for s in np.flatnonzero(active)}
                self._make_room(sum(
                    max(0, self.pool._pages_for(n)
                        - int(self.pool.n_alloc[s]))
                    for s, n in need.items()))
                self.pool.begin()
                try:
                    for s, n in need.items():
                        self.pool.ensure(s, n)      # lazy tail draws
                except AllocFault:
                    self.pool.rollback()
                    self.stats["alloc_faults"] += 1
                    continue         # whole step retries next iteration
                self.pool.commit()
                if self.prefix_cache is not None:
                    for s, n in need.items():
                        for lp in range(
                                int(self._host_len[s]) // self.page_size,
                                (n - 1) // self.page_size + 1):
                            pg = int(self.pool.tables[s, lp])
                            assert self.pool.refs[pg] == 1, (
                                f"decode write aimed at shared page {pg}")
                self._ship_tables()
                poison = np.zeros((self.n_slots,), bool)
                pslots = self.faults.poison_slots(clock)
                if pslots:
                    for s in pslots:
                        if s is None:
                            poison |= active
                        else:
                            poison[s] = True
                if self.faults.step_raises(clock):
                    raise StepFault(
                        f"injected step exception @clock {clock}")
                active_dev = self._put(active)
                poison_dev = self._put(poison)
                if drafts is not None:
                    self._spec_shapes.add(int(drafts[0].shape[1]))
                    nxt, n_acc, bad, states = self._spec(
                        self._put(drafts[0].astype(np.int64)), active_dev,
                        poison_dev, self._put(dlen.astype(np.int64)))
                    fetch = (nxt, bad, n_acc)
                else:
                    nxt, bad = self._step(active_dev, poison_dev)
                    self._step_widths.add(int(self._tables_dev.shape[1]))
                    fetch = (nxt, bad)
                self._last = nxt[:, None].to(torch.int64)
                self._stepped = True
                # the step's ONE device fetch (tokens + NaN flags — and,
                # on a speculative step, per-slot accepted counts — in
                # one transfer)
                got = self._fetch(*fetch)
                nxt_host, bad_host = got[0], got[1].astype(bool)
                acc_host = (got[2] if len(got) > 2
                            else np.zeros((self.n_slots,), np.int64))
                if drafts is not None:
                    # write ONLY the committed token plus the accepted
                    # prefix, from the counts just read: no second read
                    self._insert_accepted(
                        states, self._host_len.copy(),
                        np.where(active, 1 + acc_host, 0))
                now = time.perf_counter()
                if drafts is not None:
                    self.stats["spec_steps"] += 1
                    self.stats["spec_slot_steps"] += int(active.sum())
                    self.stats["spec_drafted"] += int(dlen[active].sum())
                    self.stats["spec_accepted"] += int(
                        acc_host[active].sum())
                self._host_len[active] += 1 + acc_host[active]
                self._host_len[~active] = 0
                self.kv_trace.append(
                    [int(self._host_len[s])
                     for s in np.flatnonzero(active)])
                for slot in np.flatnonzero(active):
                    slot = int(slot)
                    pend = self.active[slot]
                    if bad_host[slot]:
                        # quarantine: this slot's logits went non-finite;
                        # retire it alone, the lockstep batch moves on
                        self.stats["nan_quarantined"] += 1
                        self._retire(slot, "failed")
                        continue
                    emitted = [int(nxt_host[slot])]
                    if drafts is not None:
                        # accepted draft prefix first, then the verify
                        # step's own replacement/bonus token
                        emitted = [int(t) for t in drafts[0][
                            slot, 1:1 + int(acc_host[slot])]] + emitted
                    for tok in emitted:
                        self.out_tokens[slot].append(tok)
                        self._token_times[slot].append(now)
                        if tok == self.eos_id:
                            self._retire(slot, "eos")
                            break
                        if len(self.out_tokens[slot]) >= \
                                pend.req.max_new:
                            self._retire(slot, "ok")
                            break
                    if self.active[slot] is None:
                        continue     # retired mid-emission: pages freed
                    if int(self._host_len[slot]) >= self.max_len - 1:
                        self._retire(slot, "length")
                    elif drafts is not None:
                        # return the rejected draft tail's pages; the
                        # reservation survives (rollback_tail is legal
                        # outside a pool transaction)
                        self.pool.rollback_tail(
                            slot, int(self._host_len[slot]))
            except Exception as err:
                # recovery boundary: injected StepFault or a real device
                # error mid-step — the cache is presumed half written.
                # (AllocFault is handled transactionally at its draw
                # sites above and never reaches here.)
                self.errors.append(repr(err))
                self.stats["recoveries"] += 1
                recoveries += 1
                if recoveries > self.max_recoveries:
                    self._flush_outstanding("failed")
                    break
                self._recover()
            finally:
                self.pool.alloc_hook = None
        return self.completed
