"""Host-side radix tree over token prefixes → shared KV pages.

The port's own copy of the JAX package's ``serve/prefix_cache.py``
(pure Python, over the port's :class:`~repro_torch.serve.paging.PagePool`).

The SGLang idea, scoped to the repo's paged pool: production traffic
concentrates on a handful of system prompts, so most prefill FLOPs and
most live pages recompute identical prefixes. This module remembers,
per *full page* of prompt tokens, which physical page already holds
that page's KV — admission then maps those pages straight into the new
slot's block table (:meth:`PagePool.map_shared`, refcount++) and
chunked prefill replays only the uncached suffix.

Granularity is deliberately page-level, not token-level: a node exists
only for a fully written page (``page_size`` tokens), keyed by the
exact token tuple it holds, so a cached page is byte-reusable as-is.
Within the *last* matched page a partial token-prefix match is still
worth a copy: :meth:`match` reports it as ``(page, keep)`` and the
engine maps it copy-on-write pending — the device copies the ``keep``
kept rows into a private page before the slot's first write
(:meth:`PagePool.cow` + ``lm.cow_copy``).

Eviction is LRU over leaf nodes whose page has no table mapping
(refcount 1 — only the tree's own reference): dropping the node derefs
the page back to the free list. :meth:`evictable` feeds
:meth:`PagePool.available` so admission counts reclaimable pages as
headroom; :meth:`reclaim` must run *outside* pool transactions — a
rollback restores refcounts but cannot resurrect a dropped node, so an
in-transaction eviction would strand the restored count forever.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    """One fully-cached prompt page: ``key`` is its exact token tuple
    (length = pool.page_size), ``page`` the physical id the tree holds
    a reference on. Children are keyed by their full token tuple —
    sibling fan-out is tiny in practice (divergent continuations of one
    system prompt), so a dict beats compressed-edge bookkeeping."""

    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix tree of cached prompt pages over a :class:`PagePool`.

    The cache owns one refcount per node page; the pool frees a page
    only when the last table mapping *and* the tree reference are gone.
    Install as ``pool.reclaimer`` so admission headroom includes
    evictable branches.
    """

    def __init__(self, pool):
        self.pool = pool
        self.ps = pool.page_size
        self.root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0
        self.evictions = 0

    # -- lookup --------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        while node is not None:
            node.last_use = self._clock
            node = node.parent

    def match(self, tokens) -> Tuple[List[int],
                                     Optional[Tuple[int, int]]]:
        """Walk the tree along ``tokens``: returns ``(pages, partial)``
        where ``pages`` are physical ids covering the longest run of
        fully matched prompt pages and ``partial`` is ``(page, keep)``
        for the deepest child sharing ``keep`` leading tokens of the
        next page (COW material), or None. Matched nodes are
        LRU-touched."""
        toks = [int(t) for t in tokens]
        pages: List[int] = []
        children, node, off = self.root, None, 0
        while off + self.ps <= len(toks):
            child = children.get(tuple(toks[off:off + self.ps]))
            if child is None:
                break
            node, children, off = child, child.children, off + self.ps
            pages.append(child.page)
        if node is not None:
            self._touch(node)
        # partial: deepest child sharing the longest strict token prefix
        # of the next (incomplete or mismatched) page
        rest = toks[off:off + self.ps]
        best, best_keep = None, 0
        for key, child in children.items():
            keep = 0
            for a, b in zip(rest, key):
                if a != b:
                    break
                keep += 1
            if keep > best_keep:
                best, best_keep = child, keep
        if best is not None:
            self._touch(best)
            return pages, (best.page, best_keep)
        return pages, None

    # -- insertion -----------------------------------------------------

    def insert(self, tokens, pages) -> int:
        """Record a slot's written prompt pages: one node per *full*
        page of ``tokens``, adopting the corresponding physical id from
        ``pages`` (the slot's block-table row). New nodes take a tree
        reference (:meth:`PagePool.ref_page`); where a node already
        exists the incumbent page is kept — the newcomer's copy stays
        private to its slot and dies at retire. Returns nodes added."""
        toks = [int(t) for t in tokens]
        children, node, added = self.root, None, 0
        for i in range(len(toks) // self.ps):
            key = tuple(toks[i * self.ps:(i + 1) * self.ps])
            child = children.get(key)
            if child is None:
                page = int(pages[i])
                self.pool.ref_page(page)
                child = _Node(key, page, node)
                children[key] = child
                added += 1
            node, children = child, child.children
        if node is not None:
            self._touch(node)
        return added

    # -- eviction ------------------------------------------------------

    def _leaves(self) -> List[Tuple[Dict, Tuple[int, ...], _Node]]:
        out, stack = [], [(self.root, k, n) for k, n in self.root.items()]
        while stack:
            parent, key, node = stack.pop()
            if node.children:
                stack.extend((node.children, k, n)
                             for k, n in node.children.items())
            else:
                out.append((parent, key, node))
        return out

    def evictable(self) -> int:
        """Pages reclaimable *right now* under cascaded LRU eviction:
        every node whose whole subtree holds only tree references
        (refcount 1). Eviction takes leaves first, so a node with any
        table-mapped descendant is pinned until that mapping retires —
        but a fully unreferenced branch drains end to end within one
        :meth:`reclaim` call, so it counts in full. Counting leaves
        alone would under-report headroom and deadlock an admission
        whose page need exceeds the current leaf fringe. This is what
        :meth:`PagePool.available` adds to the free list."""
        total = 0
        clean: Dict[int, bool] = {}
        stack = [(n, False) for n in self.root.values()]
        while stack:
            node, visited = stack.pop()
            if not visited:               # post-order: children first
                stack.append((node, True))
                stack.extend((c, False)
                             for c in node.children.values())
                continue
            ok = (self.pool.refs[node.page] == 1
                  and all(clean[id(c)]
                          for c in node.children.values()))
            clean[id(node)] = ok
            total += ok
        return total

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` pages, LRU leaf first, cascading into
        parents as branches empty. Must run outside pool transactions
        (see module docstring). Returns pages actually freed."""
        assert not self.pool.in_transaction(), (
            "prefix-cache eviction inside a pool transaction: rollback "
            "could not restore the dropped node")
        freed = 0
        while freed < n:
            cands = [(node.last_use, parent, key, node)
                     for parent, key, node in self._leaves()
                     if self.pool.refs[node.page] == 1]
            if not cands:
                break
            _, parent, key, node = min(cands, key=lambda c: c[0])
            del parent[key]
            assert self.pool.deref(node.page), (
                "evicted a still-referenced page")
            self.evictions += 1
            freed += 1
        return freed

    def reset(self) -> None:
        """Drop the whole tree, releasing every node's reference (used
        by engine fault recovery, which zeroes device KV — cached pages
        no longer hold the bytes their keys promise)."""
        stack = list(self.root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.deref(node.page)
        self.root = {}
