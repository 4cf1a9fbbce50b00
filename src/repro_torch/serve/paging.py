"""Host-side paged-KV bookkeeping: page allocator + prefill buckets.

The port's own numpy copy of the JAX package's ``serve/paging.py``
(of its code, only the import of ``ModelConfig`` differs): the
allocator and the bucket, chunk and draft-width ladders that fill the
block tables the paged functions of ``models/lm.py`` read.

The device side (``models/lm.py`` / ``models/attention.py``) only ever
sees a page *pool* per attention layer and a per-slot block table; this
module owns the mutable host state that fills those tables:

  * :class:`PagePool` — a free-list allocator over the physical pages.
    Admission is *reservation-based*: a request is admitted only when
    the pool can cover its worst-case length (prompt + max_new, capped
    at max_len), so decode can allocate tail pages lazily and never
    deadlocks mid-sequence. Retiring a slot returns its pages to the
    free list and points its table row back at the slot's private
    scratch page.
  * bucket policy — prompts are padded to a small static set of lengths
    (powers of two up to max_len) so continuous batching compiles
    O(n_buckets) prefill programs instead of O(unique prompt lengths).

The pool is *transactional*: :meth:`PagePool.begin` snapshots the full
allocator state and :meth:`PagePool.rollback` restores it, so a
multi-step mutation (admission's admit+ensure, a speculative-decode
draft's tail growth) either lands completely or not at all —
allocation failures and preemption roll back instead of leaking pages.
:meth:`PagePool.rollback_tail` is the fine-grained form: return just a
slot's tail pages past a token count (rejected speculative drafts,
preempted requests keeping nothing).

Pages are *refcounted*: the prefix cache
(``serve/prefix_cache.py``) maps one physical page into many block
tables — and holds its own reference — so a page returns to the free
list only when its last reference drops. :meth:`PagePool.map_shared`
appends existing pages to a slot's table (refcount++),
:meth:`PagePool.cow` remaps a shared table entry to a freshly drawn
private page (copy-on-write; a sole-owner page is written in place
instead), and :meth:`PagePool.deref` is how the cache releases an
evicted branch. A ``reclaimer`` (the cache) extends
:meth:`can_admit`'s notion of "available" with LRU-evictable cached
pages; evictions themselves must happen OUTSIDE transactions — a
rollback restores refcounts but cannot resurrect a dropped tree node.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.types import ModelConfig


def default_buckets(max_len: int, min_bucket: int = 16) -> List[int]:
    """Power-of-two prefill padding lengths: min_bucket, ..., max_len."""
    out, b = [], min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def bucket_for(plen: int, buckets: List[int]) -> int:
    """Smallest bucket covering a prompt of length ``plen``."""
    for b in buckets:
        if plen <= b:
            return b
    raise ValueError(f"prompt length {plen} exceeds largest bucket "
                     f"{buckets[-1]}")


def chunk_schedule(plen: int, chunk_size: int,
                   buckets: List[int]) -> List[tuple]:
    """Chunked-prefill schedule for a prompt of length ``plen``:
    ``[(offset, chunk_len, padded_shape), ...]``.

    Full chunks run at the ``chunk_size`` shape; the final partial chunk
    pads to the smallest covering bucket — ``chunk_size`` sits on the
    bucket ladder, so every chunk shape is a ladder entry at or below
    it and mixed chunked/unchunked traffic compiles at most
    ``n_buckets + n_chunk_shapes + 1`` programs (one-shot buckets +
    chunk shapes + the decode step)."""
    out, off = [], 0
    while off < plen:
        clen = min(chunk_size, plen - off)
        shape = (chunk_size if clen == chunk_size
                 else bucket_for(clen, buckets))
        out.append((off, clen, shape))
        off += clen
    return out


def spec_ladder(k_max: int) -> List[int]:
    """Documented draft-width ladder for speculative decode: power-of-two
    widths 1, 2, ..., 2^ceil(log2(k_max)). A speculative step pads its
    widest per-slot draft up to the next ladder entry (true per-slot
    lengths travel in a traced ``draft_len`` operand), so the verify
    program compiles once per ladder entry — the compile bound grows by
    ``len(spec_ladder(k))`` and by nothing else (enforced by the
    ``compile_bound`` auditor pass)."""
    if k_max <= 0:
        return []
    return [1 << i for i in range((k_max - 1).bit_length() + 1)]


def supports_bucketing(cfg: ModelConfig) -> bool:
    """Tail-padding a prompt is exact only when every position's state
    is causal-attention KV: recurrent mixers (mamba/rwkv) fold the pad
    tokens into their running state, MoE token-choice routing competes
    padding against real tokens for expert capacity, and enc-dec /
    vision frontends consume positional extras. Those archs prefill at
    exact lengths instead (one compile per distinct prompt length)."""
    if cfg.encdec or cfg.frontend != "none" or cfg.moe is not None:
        return False
    return all(blk.mixer == "attn" and blk.ffn in ("mlp", "none")
               and not blk.cross_attn
               for stage in cfg.stages() for blk in stage.body)


def page_aligned_size(page_size: int, cfg: ModelConfig) -> int:
    """Largest size <= page_size dividing every sliding window in cfg
    (ring pages must tile the window exactly)."""
    ps = page_size
    for stage in cfg.stages():
        for blk in stage.body:
            if blk.mixer == "attn" and blk.window:
                ps = int(np.gcd(ps, blk.window))
    return max(ps, 1)


class PagePool:
    """Free-list page allocator with per-slot block tables.

    Physical ids 0..n_pages-1 are real pages; ids ``n_pages + slot`` are
    per-slot *scratch* pages idle table entries point at (lockstep
    decode writes from retired or mid-prefill slots land there). Each
    slot owns its scratch row, so idle-slot writes target disjoint
    storage instead of serializing on one shared trash page — XLA can
    overlap (or drop) them. ``tables`` is the host mirror the engine
    ships to the device each time it changes.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages: int):
        self.n_pages, self.page_size = n_pages, page_size
        self.scratch = n_pages + np.arange(n_slots, dtype=np.int64)
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.tables = np.repeat(self.scratch[:, None], max_pages,
                                axis=1).astype(np.int32)
        self.n_alloc = np.zeros(n_slots, np.int64)
        self.reserved = np.zeros(n_slots, np.int64)
        # per-page reference counts: #block-table rows naming the page
        # plus one per prefix-cache node holding it
        self.refs = np.zeros(n_pages, np.int64)
        # logical index of a slot's COW-pending shared page (-1 = none):
        # the page counts in n_alloc but its private replacement is a
        # draw the reservation must still cover (see can_admit_pages)
        self.cow_idx = np.full(n_slots, -1, np.int64)
        self.version = 0              # bumped on any table change
        # Fault-injection seam: called before every free-list draw; may
        # raise to simulate allocator exhaustion (see serve/faults.py).
        self.alloc_hook: Optional[Callable[[], None]] = None
        # Optional prefix cache: evictable() widens can_admit's notion
        # of available pages with LRU-reclaimable cached branches
        self.reclaimer = None
        self._snapshots: List[tuple] = []

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def available(self) -> int:
        """Pages admission may count on: the free list plus whatever the
        reclaimer (prefix cache) could evict under pressure."""
        extra = self.reclaimer.evictable() if self.reclaimer else 0
        return len(self.free) + extra

    def can_admit_pages(self, n_pages: int) -> bool:
        """True when ``n_pages`` fresh pages fit on top of every live
        slot's outstanding reservation (lazily-drawn remainder plus one
        owed private copy per COW-pending shared page)."""
        outstanding = int((self.reserved - self.n_alloc).sum()
                          + (self.cow_idx >= 0).sum())
        return self.available() - outstanding >= n_pages

    def can_admit(self, n_tokens: int) -> bool:
        """True when the pool can cover a worst-case ``n_tokens``
        sequence on top of every live slot's outstanding reservation."""
        return self.can_admit_pages(self._pages_for(n_tokens))

    def admit(self, slot: int, n_tokens: int) -> None:
        """Reserve worst-case capacity for a slot (caller checked
        :meth:`can_admit`); pages are drawn lazily by :meth:`ensure`."""
        assert self.n_alloc[slot] == 0 and self.reserved[slot] == 0
        self.reserved[slot] = self._pages_for(n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's table to cover ``n_tokens`` positions."""
        need = min(self._pages_for(n_tokens), self.tables.shape[1])
        while self.n_alloc[slot] < need:
            if self.alloc_hook is not None:
                self.alloc_hook()
            page = self.free.pop()
            self.refs[page] = 1
            self.tables[slot, self.n_alloc[slot]] = page
            self.n_alloc[slot] += 1
            self.version += 1

    def map_shared(self, slot: int, pages, cow_tail: bool = False) -> None:
        """Append already-referenced pages (a prefix-cache hit) to the
        slot's table: refcount++ per page, no free-list draw. With
        ``cow_tail`` the last mapped page is only *partially* covered by
        the slot's prompt — it is copy-on-write pending (:meth:`cow`
        must remap it before the first write into its range), and its
        private replacement stays charged against the reservation."""
        for p in pages:
            p = int(p)
            assert 0 <= p < self.n_pages and self.refs[p] >= 1, (
                f"mapping unreferenced page {p}")
            self.refs[p] += 1
            self.tables[slot, self.n_alloc[slot]] = p
            self.n_alloc[slot] += 1
            self.version += 1
        if cow_tail:
            assert pages, "cow_tail without mapped pages"
            self.cow_idx[slot] = self.n_alloc[slot] - 1

    def cow(self, slot: int, logical: int) -> tuple:
        """Copy-on-write a slot's table entry before its first write:
        draw a private page, remap the row, drop one reference on the
        shared original (the device copies the kept prefix rows —
        ``lm.cow_copy``). Returns ``(src, dst)``; a sole-owner page
        (refcount 1) is written in place instead — ``src == dst`` and
        nothing is drawn."""
        src = int(self.tables[slot, logical])
        assert logical < self.n_alloc[slot] and src < self.n_pages
        if self.cow_idx[slot] == logical:
            self.cow_idx[slot] = -1
        if self.refs[src] == 1:
            return src, src
        if self.alloc_hook is not None:
            self.alloc_hook()
        dst = self.free.pop()
        self.refs[dst] = 1
        self.refs[src] -= 1
        self.tables[slot, logical] = dst
        self.version += 1
        return src, dst

    def ref_page(self, page: int) -> None:
        """Take a reference on a live page (a prefix-cache node adopting
        a slot's written prompt page)."""
        assert self.refs[page] >= 1, f"ref on dead page {page}"
        self.refs[page] += 1

    def deref(self, page: int) -> bool:
        """Drop one reference; the page returns to the free list only
        when the last reference drops (returns True then)."""
        self.refs[page] -= 1
        assert self.refs[page] >= 0, f"refcount underflow on page {page}"
        if self.refs[page] == 0:
            self.free.append(int(page))
            return True
        return False

    def release(self, slot: int) -> None:
        """Retire a slot: drop one reference per table entry (pages the
        prefix cache still holds stay allocated), table back to the
        slot's scratch page."""
        n = int(self.n_alloc[slot])
        for p in self.tables[slot, :n]:
            self.deref(int(p))
        self.tables[slot, :] = self.scratch[slot]
        self.n_alloc[slot] = 0
        self.reserved[slot] = 0
        self.cow_idx[slot] = -1
        self.version += 1

    def live_pages(self) -> int:
        """Table-mapped logical pages (shared pages count once per slot
        mapping them — the gather-volume view the engine prices)."""
        return int(self.n_alloc.sum())

    def unique_live(self) -> int:
        """Distinct referenced physical pages (the occupancy view)."""
        return self.n_pages - len(self.free)

    # -- transactions --------------------------------------------------
    #
    # begin/commit/rollback bracket multi-step mutations (admission's
    # admit+ensure pair, speculative tail growth) so a failure midway —
    # injected or real — restores the exact prior allocator state
    # instead of leaking half an admission. Snapshots nest (LIFO).

    def begin(self) -> None:
        """Open a transaction: snapshot free list, tables, counters."""
        self._snapshots.append((list(self.free), self.tables.copy(),
                                self.n_alloc.copy(),
                                self.reserved.copy(), self.refs.copy(),
                                self.cow_idx.copy()))

    def commit(self) -> None:
        """Close the innermost transaction, keeping its mutations."""
        self._snapshots.pop()

    def rollback(self) -> None:
        """Abort the innermost transaction, restoring its snapshot.

        ``version`` still bumps monotonically — consumers key shipped
        block tables on it, and a rollback changes the tables even
        though it *restores* them, so reuse of a pre-transaction
        version number would leave stale device tables in place.

        Refcounts restore with the rest of the state, which is why
        prefix-cache evictions must happen *before* ``begin``: a
        rollback cannot resurrect the tree node that held the
        reference, so an in-transaction eviction would strand the
        restored refcount forever.
        """
        (free, tables, n_alloc, reserved, refs,
         cow_idx) = self._snapshots.pop()
        self.free, self.tables = free, tables
        self.n_alloc, self.reserved = n_alloc, reserved
        self.refs, self.cow_idx = refs, cow_idx
        self.version += 1

    def in_transaction(self) -> bool:
        return bool(self._snapshots)

    def rollback_tail(self, slot: int, n_tokens: int) -> int:
        """Shrink a slot's allocation back to ``n_tokens`` positions,
        returning tail pages to the free list (rejected speculative
        drafts; ``n_tokens=0`` strips a preempted slot bare while its
        reservation survives for re-admission). Returns the number of
        pages freed. The reservation is *not* shrunk: the sequence's
        worst case is unchanged by dropping its tail. Shared
        (prefix-cache) tail pages only lose this slot's reference —
        ``freed`` counts pages actually returned to the free list."""
        keep = self._pages_for(n_tokens)
        freed = 0
        while self.n_alloc[slot] > keep:
            self.n_alloc[slot] -= 1
            if self.deref(int(self.tables[slot, self.n_alloc[slot]])):
                freed += 1
            self.tables[slot, self.n_alloc[slot]] = self.scratch[slot]
            self.version += 1
        if self.cow_idx[slot] >= self.n_alloc[slot]:
            self.cow_idx[slot] = -1
        return freed

    def check_conservation(self) -> None:
        """Assert the allocator invariants under refcounting: every
        physical page is exactly-once free (refcount 0) or referenced
        (refcount ≥ 1), the free list holds no duplicates, and no block
        table names a page more often than its refcount covers."""
        assert len(self.free) == len(set(self.free)), "double-freed page"
        assert all(0 <= p < self.n_pages for p in self.free), (
            "foreign page id on free list")
        referenced = int((self.refs > 0).sum())
        assert len(self.free) + referenced == self.n_pages, (
            f"page leak: {len(self.free)} free + {referenced} "
            f"referenced != {self.n_pages}")
        assert all(self.refs[p] == 0 for p in self.free), (
            "free page with live refcount")
        mult = np.zeros(self.n_pages, np.int64)
        for s in range(self.tables.shape[0]):
            for p in self.tables[s, :int(self.n_alloc[s])]:
                assert 0 <= p < self.n_pages, "foreign page id in table"
                mult[int(p)] += 1
        assert (mult <= self.refs).all(), (
            "table names a page beyond its refcount")
