"""The port's paged serving core against the JAX package's, on CPU.

The host modules (``serve/paging.py``'s allocator and ladders,
``serve/sampling.py``), the pool writes and copies, the paged attention
partials and their merge, and whole serving schedules: at the
``reduced()`` sizes of deepseek-7b (global attention, 2 layers, d 64)
and gemma3-27b (gemma3-smoke: 8 layers, a 16-token window, so ring pages
wrap), bucketed one-shot prefill + ``insert_prefill``, chunked prefill
interleaved with lockstep paged decode, a retire and refill, a
speculative verify + ``insert_verify`` and a copy-on-write, the same
calls on both sides; rwkv6-smoke and whisper-smoke admitted at exact
lengths. The JAX side runs ``use_impl("ref")``. Weights come from the
JAX initializer with the norm gains and biases jittered in numpy; both
packages get the same arrays. Tolerances, each with its reason:

* logits of every call, the attention partials and every pool leaf
  after every call: rtol = atol = 2e-4, the JAX package's
  prefill/decode tolerance (only the order of fp32 sums differs);
* pool writes of given K/V, page copies, the allocator's state, the
  ladders and ``filter_logits``: exactly equal;
* greedy streams: exactly equal to ``conftest.manual_greedy`` (whisper:
  the same dense loop with its frames);
* sampled tokens: in the filtered support, and a chi-square test of
  their counts against the filtered softmax at p > 1e-3 (the streams
  of ``jax.random`` and a ``torch.Generator`` differ).
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy
from scipy import stats

from repro.configs import deepseek_7b, gemma3_27b, rwkv6_3b, whisper_base
from repro.core import runtime as jruntime
from repro.core.types import PagingConfig as JPagingConfig
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import paging as jpaging
from repro.serve import sampling as jsampling
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core.types import PagingConfig
from repro_torch.models import attention, lm
from repro_torch.serve import paging, sampling

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = {"deepseek-7b": deepseek_7b, "gemma3-27b": gemma3_27b,
         "rwkv6-3b": rwkv6_3b, "whisper-base": whisper_base}
PS, SLOTS, MAX_LEN, CHUNK = 4, 2, 64, 16
MAX_PAGES = MAX_LEN // PS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


_MODELS = {}


def _model(arch):
    """(jcfg, tcfg, jparams, tparams) of one reduced arch, the norm gains
    and biases jittered by 0.1, built once per module."""
    if arch not in _MODELS:
        jcfg, tcfg = ARCHS[arch].reduced(), get_reduced(arch)
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg,
                                dtype=jnp.float32)
        rng = np.random.default_rng(1)

        def jit(path, leaf):
            a = np.asarray(leaf)
            if path[-1].key in ("g", "b"):
                a = a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a
        tree = jax.tree_util.tree_map_with_path(
            jit, jax.tree_util.tree_map(np.asarray, params))
        _MODELS[arch] = (jcfg, tcfg,
                         jax.tree_util.tree_map(jnp.asarray, tree),
                         from_jax_params(tree, tcfg, device="cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _MODELS.clear()


# ------------------------------ host modules ----------------------------


def _pool_state(pool):
    return (list(pool.free), pool.tables.tolist(), pool.refs.tolist(),
            pool.n_alloc.tolist(), pool.reserved.tolist(),
            pool.cow_idx.tolist(), pool.version)


def _apply(pool, name, args):
    """(result, error type) of ``pool.name(*args)``."""
    try:
        return getattr(pool, name)(*args), None
    except (AssertionError, IndexError) as err:
        return None, type(err).__name__


def test_page_pool_matches_jax():
    """Both packages' allocators through one seeded random sequence of
    admit, ensure, map_shared, cow, ref_page / deref, release,
    begin / commit / rollback and rollback_tail: after every op their
    free lists, tables, refcounts, allocations, reservations, COW marks
    and versions are equal, as are the ops' results and errors and
    ``check_conservation``."""
    rng = np.random.default_rng(0)
    n_pages, n_slots, max_pages = 12, 3, 6
    mine = paging.PagePool(n_pages, 4, n_slots, max_pages)
    theirs = jpaging.PagePool(n_pages, 4, n_slots, max_pages)
    depth = 0
    for _ in range(400):
        slot = int(rng.integers(n_slots))
        live = [p for p in range(n_pages) if mine.refs[p] >= 1]
        kind = rng.choice(["admit", "ensure", "map_shared", "cow", "ref",
                           "deref", "release", "begin", "end", "tail"])
        if kind == "admit":
            if mine.n_alloc[slot] or mine.reserved[slot]:
                continue
            n = int(rng.integers(1, 4 * max_pages))
            assert mine.can_admit(n) == theirs.can_admit(n)
            if not mine.can_admit(n):
                continue
            op = ("admit", (slot, n))
        elif kind == "ensure":
            op = ("ensure", (slot, int(rng.integers(0, 4 * max_pages + 1))))
        elif kind == "map_shared":
            if not live or mine.n_alloc[slot] >= max_pages:
                continue
            k = int(rng.integers(1, min(3, max_pages - mine.n_alloc[slot])
                                 + 1))
            op = ("map_shared", (slot, [int(p) for p in rng.choice(live, k)],
                                 bool(rng.integers(2))))
        elif kind == "cow":
            if not mine.n_alloc[slot]:
                continue
            op = ("cow", (slot, int(rng.integers(mine.n_alloc[slot]))))
        elif kind in ("ref", "deref"):
            if not live:
                continue
            op = ("ref_page" if kind == "ref" else "deref",
                  (int(rng.choice(live)),))
        elif kind == "release":
            op = ("release", (slot,))
        elif kind == "begin":
            depth += 1
            op = ("begin", ())
        elif kind == "end":
            if not depth:
                continue
            depth -= 1
            op = (("commit", "rollback")[int(rng.integers(2))], ())
        else:
            op = ("rollback_tail", (slot, int(rng.integers(0, 20))))
        assert _apply(mine, *op) == _apply(theirs, *op), op
        assert _pool_state(mine) == _pool_state(theirs), op
        assert _apply(mine, "check_conservation", ()) == _apply(
            theirs, "check_conservation", ()), op
        assert mine.available() == theirs.available()
        assert mine.live_pages() == theirs.live_pages()
        assert mine.unique_live() == theirs.unique_live()
        assert mine.in_transaction() == theirs.in_transaction()


@pytest.mark.parametrize("max_len", [16, 64, 100, 2048])
def test_ladders_match_jax(max_len):
    """Buckets, the chunk schedule, the draft-width ladder, bucketing
    support and the page-aligned size, equal to the JAX package's."""
    buckets = paging.default_buckets(max_len)
    assert buckets == jpaging.default_buckets(max_len)
    assert paging.default_buckets(max_len, 4) == jpaging.default_buckets(
        max_len, 4)
    for plen in sorted({1, 7, 16, min(17, max_len), max_len}):
        assert paging.bucket_for(plen, buckets) == jpaging.bucket_for(
            plen, buckets)
        for chunk in (16, 256):
            assert paging.chunk_schedule(plen, chunk, buckets) == (
                jpaging.chunk_schedule(plen, chunk, buckets))
    with pytest.raises(ValueError):
        paging.bucket_for(max_len + 1, buckets)
    for k in range(0, 9):
        assert paging.spec_ladder(k) == jpaging.spec_ladder(k)
    for arch, mod in ARCHS.items():
        for mine, theirs in ((get_config(arch), mod.CONFIG),
                             (get_reduced(arch), mod.reduced())):
            assert paging.supports_bucketing(mine) == (
                jpaging.supports_bucketing(theirs))
            for ps in (8, 16, 48):
                assert paging.page_aligned_size(ps, mine) == (
                    jpaging.page_aligned_size(ps, theirs))
    assert paging.supports_bucketing(get_config("deepseek-7b"))
    assert not paging.supports_bucketing(get_config("rwkv6-3b"))
    assert [(f.name, f.default) for f in dataclasses.fields(PagingConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JPagingConfig)]


# ------------------------------ pool writes -----------------------------


def _pool(seed, n_phys, hkv=2, hd=4, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(lead + (n_phys, PS, hkv, hd)).astype(
        np.float32)


def _table(seed, b, n_log, n_phys):
    """Distinct physical pages per row, drawn from a permutation."""
    perm = np.random.default_rng(seed).permutation(n_phys)
    return perm[:b * n_log].reshape(b, n_log).astype(np.int32)


WRITE_CASES = {
    # write_pages: the decode token (pos per row)
    "decode": ("decode", dict(pos=[0, 5, 13], window=0)),
    "decode-ring-wraps": ("decode", dict(pos=[3, 17, 40], window=16)),
    # write_chunk_pages: offset, chunk_len per row, Sc
    "chunk-padding": ("chunk", dict(offset=[0, 6], clen=[5, 3], sc=8,
                                    window=0)),
    "chunk-len-0": ("chunk", dict(offset=[4, 9], clen=[0, 4], sc=8,
                                  window=0)),
    "chunk-ring-wraps": ("chunk", dict(offset=[14, 30], clen=[6, 8], sc=8,
                                       window=16)),
    "chunk-longer-than-window": ("chunk", dict(offset=[3, 0], clen=[24, 30],
                                               sc=32, window=16)),
    "chunk-limit-below-window": ("chunk", dict(offset=[2, 0], clen=[5, 9],
                                               sc=16, window=16)),
    # lm._insert_pages: a prefill of plen in a bucket of S_pad
    "insert-padding": ("insert", dict(plen=11, s_pad=16, window=0)),
    "insert-ring-wraps": ("insert", dict(plen=37, s_pad=64, window=16)),
    "insert-limit-below-window": ("insert", dict(plen=9, s_pad=16,
                                                 window=16)),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_pool_writes_match_jax(case):
    """``write_pages``, ``write_chunk_pages`` and ``lm._insert_pages``
    against JAX's on the same pool and K/V: every pool leaf equal, the
    writes in place. Padding rows, ``chunk_len = 0``, rows past the
    window and (JAX's out-of-range page id, dropped by its scatter) are
    not written."""
    kind, kw = WRITE_CASES[case]
    rng = np.random.default_rng(7)
    window = kw["window"]
    if kind == "decode":
        b = len(kw["pos"])
        n_phys = b * MAX_PAGES + b
        pk, pv = _pool(1, n_phys), _pool(2, n_phys)
        tbl = _table(3, b, MAX_PAGES, n_phys)
        kn, vn = (rng.standard_normal((b, 1, 2, 4)).astype(np.float32)
                  for _ in range(2))
        pos = np.array(kw["pos"], np.int32)
        want = jattn.write_pages(jattn.PagedKVCache(jnp.asarray(pk),
                                                    jnp.asarray(pv)),
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos), jnp.asarray(tbl), window)
        pool = attention.PagedKVCache(_t(pk), _t(pv))
        got = attention.write_pages(pool, _t(kn), _t(vn),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(tbl), window)
    elif kind == "chunk":
        b = len(kw["offset"])
        n_phys = b * MAX_PAGES + b
        pk, pv = _pool(1, n_phys), _pool(2, n_phys)
        tbl = _table(3, b, MAX_PAGES, n_phys)
        kn, vn = (rng.standard_normal((b, kw["sc"], 2, 4)).astype(np.float32)
                  for _ in range(2))
        off = np.array(kw["offset"], np.int32)
        clen = np.array(kw["clen"], np.int32)
        want = jattn.write_chunk_pages(
            jattn.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv)),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(off),
            jnp.asarray(clen), jnp.asarray(tbl), window)
        pool = attention.PagedKVCache(_t(pk), _t(pv))
        got = attention.write_chunk_pages(
            pool, _t(kn), _t(vn), torch.from_numpy(off),
            torch.from_numpy(clen), torch.from_numpy(tbl), window)
    else:
        n_phys = 2 * MAX_PAGES + 2
        pk, pv = _pool(1, n_phys, lead=(3,)), _pool(2, n_phys, lead=(3,))
        row = _table(3, 1, MAX_PAGES, n_phys)[0]
        kn, vn = (rng.standard_normal((3, 1, kw["s_pad"], 2, 4)).astype(
            np.float32) for _ in range(2))
        want = jlm._insert_pages(
            jattn.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv)),
            jnp.asarray(kn), jnp.asarray(vn), pages=jnp.asarray(row),
            plen=kw["plen"], window=window, page_size=PS)
        pool = attention.PagedKVCache(_t(pk), _t(pv))
        targets = attention.chunk_targets(
            0, kw["plen"], torch.from_numpy(row)[None], kw["s_pad"],
            (window,), PS)[window]
        got = lm._insert_pages(pool, _t(kn), _t(vn), targets)
    assert got.k is pool.k and got.v is pool.v
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    if case == "chunk-len-0":
        # row 0 writes nothing; row 1 its 4 rows
        assert (got.k.numpy() != pk).sum() == 4 * 2 * 4
    assert (got.k.numpy() != pk).any()


# --------------------------- paged attention ----------------------------


def _ring_pool(kd, vd, limit, window, n_phys, seed):
    """Pools holding the dense K/V (B, S, Hkv, hd) through a table: a
    global table at positions < limit, or a ring of the last ``window``
    positions below limit; unwritten rows are random."""
    b = kd.shape[0]
    pk, pv = _pool(seed, n_phys, kd.shape[2], kd.shape[3]), _pool(
        seed + 1, n_phys, kd.shape[2], kd.shape[3])
    tbl = _table(seed + 2, b, MAX_PAGES, n_phys)
    for row in range(b):
        lo = max(0, limit[row] - window) if window else 0
        for p in range(lo, limit[row]):
            r = p % window if window else p
            pk[tbl[row, r // PS], r % PS] = kd[row, p]
            pv[tbl[row, r // PS], r % PS] = vd[row, p]
    return pk, pv, tbl


@pytest.mark.parametrize("window", [0, 16], ids=["global", "ring"])
@pytest.mark.parametrize("sq", [1, 5], ids=["decode", "multi-query"])
@pytest.mark.parametrize("hkv", [4, 2])
def test_paged_fwd_matches_jax_and_dense(hkv, sq, window):
    """``_paged_fwd`` (out and log-sum-exp) against JAX's on the same
    pool and table, and its output against the port's dense
    ``chunked_attention`` over the same keys; rows below, at and past
    the window (``limit < window``: unwritten ring slots resolve to
    negative positions and mask out). Multi-query: queries at
    ``q_offset + i`` attend causally (and inside the window)."""
    b, hq, hd, s = 3, 4, 8, 48
    rng = np.random.default_rng(hkv + sq + window)
    limit = np.array([5, 16, 40], np.int32)
    kd, vd = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, hq, sq, hd)).astype(np.float32)
    n_phys = b * MAX_PAGES + b
    pk, pv, tbl = _ring_pool(kd, vd, limit, window, n_phys, 11)
    if window:
        tbl = tbl[:, :window // PS]
    q_offset = None if sq == 1 else limit
    want_o, want_l = jattn._paged_fwd(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tbl),
        jnp.asarray(limit), chunk=8,
        q_offset=None if q_offset is None else jnp.asarray(q_offset),
        window=window)
    got_o, got_l = attention._paged_fwd(
        _t(q), _t(pk), _t(pv), torch.from_numpy(tbl),
        torch.from_numpy(limit), chunk=8,
        q_offset=None if q_offset is None else torch.from_numpy(q_offset),
        window=window)
    _close(got_o, want_o)
    _close(got_l, want_l)
    kh, vh = _t(kd).transpose(1, 2), _t(vd).transpose(1, 2)
    for row in range(b):
        qr = _t(q)[row:row + 1]
        if sq == 1:
            lo = max(0, limit[row] - window) if window else 0
            dense = attention.chunked_attention(
                qr, kh[row:row + 1, :, lo:limit[row]],
                vh[row:row + 1, :, lo:limit[row]], causal=False)
        else:
            # the prefix keys only: positions below limit
            dense = attention.chunked_attention(
                qr, kh[row:row + 1, :, :limit[row]],
                vh[row:row + 1, :, :limit[row]], causal=True, window=window,
                q_offset=int(limit[row]))
        torch.testing.assert_close(got_o[row:row + 1], dense, **TOL)


def test_paged_chunked_attention_matches_jax():
    """``chunked_attention(pages=)``, the paged decode entry, against
    JAX's with a per-row ``kv_len``."""
    rng = np.random.default_rng(4)
    b, hq, hkv, hd = 2, 4, 2, 8
    n_phys = b * MAX_PAGES + b
    pk, pv = _pool(5, n_phys, hkv, hd), _pool(6, n_phys, hkv, hd)
    tbl = _table(7, b, MAX_PAGES, n_phys)
    q = rng.standard_normal((b, hq, 1, hd)).astype(np.float32)
    kv_len = np.array([1, 33], np.int32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(pk),
                                   jnp.asarray(pv), causal=False,
                                   kv_len=jnp.asarray(kv_len),
                                   pages=jnp.asarray(tbl))
    got = attention.chunked_attention(_t(q), _t(pk), _t(pv), causal=False,
                                      kv_len=torch.from_numpy(kv_len),
                                      pages=torch.from_numpy(tbl))
    _close(got, want)


def test_merge_partials_matches_jax():
    """The LSE merge of two partials against JAX's, and a fully masked
    partial (lse about -1e30: the prefix at offset 0) dropping out: the
    merge returns the other partial."""
    rng = np.random.default_rng(8)
    b, hq, hkv, sq, hd = 2, 4, 2, 3, 8
    q = rng.standard_normal((b, hq, sq, hd)).astype(np.float32)
    n_phys = b * MAX_PAGES + b
    pk, pv = _pool(9, n_phys, hkv, hd), _pool(10, n_phys, hkv, hd)
    tbl = _table(11, b, MAX_PAGES, n_phys)
    parts = []
    for limit in ([7, 20], [12, 3], [0, 0]):
        lim = np.array(limit, np.int32)
        parts.append(attention._paged_fwd(
            _t(q), _t(pk), _t(pv), torch.from_numpy(tbl),
            torch.from_numpy(lim), chunk=16, q_offset=torch.from_numpy(lim)))
    (oa, la), (ob, lb), (om, lm_) = parts
    assert (lm_ < -1e29).all()
    want = jattn._merge_partials(*(jnp.asarray(t.numpy())
                                   for t in (oa, la, ob, lb)))
    _close(attention._merge_partials(oa, la, ob, lb), want)
    torch.testing.assert_close(attention._merge_partials(oa, la, om, lm_),
                               oa, rtol=0, atol=0)
    torch.testing.assert_close(attention._merge_partials(om, lm_, ob, lb),
                               ob, rtol=0, atol=0)


def test_copy_page_and_cow_copy_match_jax():
    """``copy_page`` on the stored 5-D leaves against JAX's, in place;
    ``src == dst`` the identity; ``lm.cow_copy`` over a gemma3-smoke
    paged cache (every pool, local and global) against JAX's."""
    pk, pv = _pool(12, 10, lead=(3,)), _pool(13, 10, lead=(3,))
    pool = attention.PagedKVCache(_t(pk), _t(pv))
    for src, dst in ((3, 7), (4, 4)):
        want = jattn.copy_page(jattn.PagedKVCache(jnp.asarray(pk),
                                                  jnp.asarray(pv)),
                               jnp.int32(src), jnp.int32(dst))
        got = attention.copy_page(pool, src, dst)
        assert got.k is pool.k and got.v is pool.v
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
        pk, pv = got.k.numpy().copy(), got.v.numpy().copy()
    jcfg, tcfg = gemma3_27b.reduced(), get_reduced("gemma3-27b")
    jc = jlm.init_paged_cache(jcfg, SLOTS, MAX_LEN, page_size=PS,
                              dtype=jnp.float32)
    rng = np.random.default_rng(14)
    leaves = [rng.standard_normal(x.shape).astype(np.float32)
              for x in jax.tree_util.tree_leaves(jc)]
    jc = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jc),
                                      [jnp.asarray(a) for a in leaves])
    tc = lm.init_paged_cache(tcfg, SLOTS, MAX_LEN, page_size=PS,
                             dtype=torch.float32, device="cpu")
    for t, a in zip(_leaves(tc), leaves):
        t.copy_(torch.from_numpy(a))
    for src, dst in ((5, 30), (6, 6)):
        jc = jlm.cow_copy(jc, jnp.int32(src), jnp.int32(dst))
        tc = lm.cow_copy(tc, src, dst)
        for t, j in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_init_paged_cache_matches_jax():
    """Pools of (R, n_pages + n_slots, ps, Hkv, hd) for every attention
    layer (local and global alike), dense per-slot leaves for the rest;
    a window that is not a multiple of the page size raises."""
    for arch in ARCHS:
        jcfg, tcfg = ARCHS[arch].reduced(), get_reduced(arch)
        jc = jlm.init_paged_cache(jcfg, 3, 40, page_size=8, n_pages=5,
                                  dtype=jnp.float32)
        tc = lm.init_paged_cache(tcfg, 3, 40, page_size=8, n_pages=5,
                                 dtype=torch.float32, device="cpu")
        jl, tl = jax.tree_util.tree_leaves(jc), _leaves(tc)
        assert len(jl) == len(tl)
        for t, j in zip(tl, jl):
            assert tuple(t.shape) == j.shape and not t.any()
    tcfg = get_reduced("gemma3-27b")
    tc = lm.init_paged_cache(tcfg, 2, 40, page_size=8, device="cpu")
    assert isinstance(tc[0]["0"]["kv"], attention.PagedKVCache)
    assert tc[0]["0"]["kv"].k.shape[1] == 2 * 5 + 2
    with pytest.raises(ValueError, match="page_size"):
        lm.init_paged_cache(tcfg, 2, 40, page_size=12, device="cpu")


# ------------------------------ schedules -------------------------------


class _Pair:
    """One paged serving cache on each side, the same call to both: each
    call's logits held together and every pool leaf after it."""

    def __init__(self, arch):
        self.jcfg, self.tcfg, self.jp, self.tp = _model(arch)
        self.jc = jlm.init_paged_cache(self.jcfg, SLOTS, MAX_LEN,
                                       page_size=PS, dtype=jnp.float32)
        self.tc = lm.init_paged_cache(self.tcfg, SLOTS, MAX_LEN,
                                      page_size=PS, dtype=torch.float32,
                                      device="cpu")
        self.calls = collections.Counter()

    def _held(self, kind, tl, jl):
        _close(tl, jl)
        jleaves = jax.tree_util.tree_leaves(self.jc)
        tleaves = _leaves(self.tc)
        assert len(jleaves) == len(tleaves)
        for t, j in zip(tleaves, jleaves):
            _close(t, j)
        self.calls[kind] += 1
        return tl

    def admit(self, tokens, plen, slot, row):
        with jruntime.use_impl("ref"):
            jl, st = jlm.prefill_states(self.jp, jnp.asarray(tokens[None]),
                                        self.jcfg,
                                        last_pos=jnp.asarray([plen],
                                                             jnp.int32))
            self.jc = jlm.insert_prefill(self.jcfg, self.jc, st, slot=slot,
                                         pages=jnp.asarray(row), plen=plen,
                                         page_size=PS)
        tl, st = lm.prefill_states(self.tp,
                                   torch.from_numpy(tokens[None]).long(),
                                   self.tcfg, last_pos=torch.tensor([plen]))
        self.tc = lm.insert_prefill(self.tcfg, self.tc, st, slot=slot,
                                    pages=torch.from_numpy(row), plen=plen,
                                    page_size=PS)
        return self._held("admit", tl, jl)[0]

    def chunk(self, tokens, offset, clen, row):
        with jruntime.use_impl("ref"):
            jl, self.jc = jlm.prefill_chunk(
                self.jp, self.jc, jnp.asarray(tokens[None]), self.jcfg,
                offset=jnp.int32(offset), chunk_len=jnp.int32(clen),
                pages=jnp.asarray(row[None]))
        tl, self.tc = lm.prefill_chunk(
            self.tp, self.tc, torch.from_numpy(tokens[None]).long(),
            self.tcfg, offset=offset, chunk_len=clen,
            pages=torch.from_numpy(row[None]))
        return self._held("chunk", tl, jl)[0]

    def decode(self, tokens, lengths, tables):
        with jruntime.use_impl("ref"):
            jl, self.jc = jlm.decode_step(
                self.jp, self.jc, jnp.asarray(tokens[:, None]),
                jnp.asarray(lengths), self.jcfg, pages=jnp.asarray(tables))
        tl, self.tc = lm.decode_step(
            self.tp, self.tc, torch.from_numpy(tokens[:, None]).long(),
            torch.from_numpy(lengths), self.tcfg,
            pages=torch.from_numpy(tables))
        return self._held("decode", tl, jl)

    def verify(self, panel, offset, clen, n_keep_of, tables):
        """verify_states on both sides, then insert_verify with the
        n_keep the port's logits give (``n_keep_of``)."""
        with jruntime.use_impl("ref"):
            jl, jst = jlm.verify_states(
                self.jp, self.jc, jnp.asarray(panel), self.jcfg,
                offset=jnp.asarray(offset), chunk_len=jnp.asarray(clen),
                pages=jnp.asarray(tables))
        tl, tst = lm.verify_states(
            self.tp, self.tc, torch.from_numpy(panel).long(), self.tcfg,
            offset=torch.from_numpy(offset), chunk_len=torch.from_numpy(clen),
            pages=torch.from_numpy(tables))
        _close(tl, jl)
        for t, j in zip(_leaves(tst), jax.tree_util.tree_leaves(jst)):
            _close(t, j)
        n_keep = n_keep_of(tl)
        with jruntime.use_impl("ref"):
            self.jc = jlm.insert_verify(self.jcfg, self.jc, jst,
                                        pages=jnp.asarray(tables),
                                        offset=jnp.asarray(offset),
                                        n_keep=jnp.asarray(n_keep))
        self.tc = lm.insert_verify(self.tcfg, self.tc, tst,
                                   pages=torch.from_numpy(tables),
                                   offset=torch.from_numpy(offset),
                                   n_keep=torch.from_numpy(n_keep))
        return self._held("verify", tl, jl)

    def cow(self, src, dst):
        """cow_copy on both sides: every pool's page ``dst`` equal to its
        page ``src``, and every leaf held to JAX's."""
        self.jc = jlm.cow_copy(self.jc, jnp.int32(src), jnp.int32(dst))
        self.tc = lm.cow_copy(self.tc, src, dst)
        for t, j in zip(_leaves(self.tc), jax.tree_util.tree_leaves(self.jc)):
            torch.testing.assert_close(t[:, dst], t[:, src], rtol=0, atol=0)
            _close(t, j)


def _run_schedule(arch):
    """The host side of the JAX engine's step programs, on both
    packages: A (11 tokens) one-shot in bucket 16 into slot 0; B (37,
    past the window) in chunks of 16 into slot 1, each chunk followed by
    a lockstep decode step in which B's row points at its scratch page;
    A retires and C (20) refills slot 0 one-shot in bucket 32 on the
    freed pages; one verify step over a 4-token panel (C's drafts all
    right, B's second wrong); a copy-on-write of B's first page; decode
    to the end. Returns the pair, the streams and the oracle's."""
    pair = _Pair(arch)
    reqs = {"A": (_tokens(21, (11,)), 6), "B": (_tokens(22, (37,)), 12),
            "C": (_tokens(23, (20,)), 10)}
    with jruntime.use_impl("ref"):
        oracle = {r: manual_greedy(pair.jp, pair.jcfg, jnp.asarray(p), n,
                                   MAX_LEN) for r, (p, n) in reqs.items()}
    pool = paging.PagePool(SLOTS * MAX_PAGES, PS, SLOTS, MAX_PAGES)
    buckets = paging.default_buckets(MAX_LEN)
    slot_req = [None] * SLOTS
    lengths = np.zeros(SLOTS, np.int32)
    out = {r: [] for r in reqs}
    chunks = {}

    def admit_one_shot(slot, r):
        prompt, n_new = reqs[r]
        plen = prompt.shape[0]
        pool.admit(slot, plen + n_new)
        pool.ensure(slot, plen)
        toks = np.zeros(paging.bucket_for(plen, buckets), np.int32)
        toks[:plen] = prompt
        logits = pair.admit(toks, plen, slot, pool.tables[slot].copy())
        out[r].append(int(logits.argmax()))
        slot_req[slot], lengths[slot] = r, plen

    def active():
        return [s for s in range(SLOTS) if slot_req[s] is not None
                and s not in chunks]

    def tables():
        t = pool.tables.copy()
        for s in chunks:
            t[s] = pool.scratch[s]
        return t

    def retire_done():
        for s in active():
            r = slot_req[s]
            if len(out[r]) == reqs[r][1]:
                pool.release(s)
                slot_req[s], lengths[s] = None, 0

    def decode():
        act = active()
        for s in act:
            pool.ensure(s, int(lengths[s]) + 1)
        toks = np.array([out[slot_req[s]][-1] if s in act else 0
                         for s in range(SLOTS)], np.int32)
        dlen = np.where(np.isin(np.arange(SLOTS), act), lengths, 0).astype(
            np.int32)
        logits = pair.decode(toks, dlen, tables())
        for s in act:
            out[slot_req[s]].append(int(logits[s].argmax()))
            lengths[s] += 1
        retire_done()

    admit_one_shot(0, "A")
    prompt_b = reqs["B"][0]
    pool.admit(1, prompt_b.shape[0] + reqs["B"][1])
    slot_req[1] = "B"
    chunks[1] = paging.chunk_schedule(prompt_b.shape[0], CHUNK, buckets)
    assert [c[1] for c in chunks[1]] == [16, 16, 5]
    while chunks:
        off, clen, shape = chunks[1].pop(0)
        pool.ensure(1, off + clen)
        toks = np.zeros(shape, np.int32)
        toks[:clen] = prompt_b[off:off + clen]
        logits = pair.chunk(toks, off, clen, pool.tables[1].copy())
        if not chunks[1]:
            del chunks[1]
            out["B"].append(int(logits.argmax()))
            lengths[1] = off + clen
        decode()
    while slot_req[0] == "A":
        decode()
    admit_one_shot(0, "C")
    decode()
    # one verify step: the last token and 3 drafts a row
    k = 3
    panel = np.zeros((SLOTS, 1 + k), np.int32)
    want_acc = {"C": 3, "B": 1}
    for s in range(SLOTS):
        r = slot_req[s]
        j = len(out[r])
        drafts = list(oracle[r][j:j + k])
        if r == "B":
            drafts[1] = (drafts[1] + 1) % 256
        panel[s] = [out[r][-1]] + drafts
    pool.begin()
    for s in range(SLOTS):
        pool.ensure(s, int(lengths[s]) + 1 + k)
    pool.commit()
    clen = np.full(SLOTS, 1 + k, np.int32)
    got = {}

    def n_keep_of(logits):
        amax = logits.argmax(-1).numpy()                  # (B, 1 + k)
        acc = panel[:, 1:] == amax[:, :k]
        n_acc = np.cumprod(acc, axis=1).sum(1)
        got["n_acc"], got["amax"] = n_acc, amax
        return (1 + n_acc).astype(np.int32)
    pair.verify(panel, lengths.copy(), clen, n_keep_of, tables())
    for s in range(SLOTS):
        r, n_acc = slot_req[s], int(got["n_acc"][s])
        assert n_acc == want_acc[r], (r, n_acc)
        out[r] += list(panel[s, 1:1 + n_acc]) + [int(got["amax"][s, n_acc])]
        lengths[s] += 1 + n_acc
        pool.rollback_tail(s, int(lengths[s]))
    retire_done()
    # copy-on-write: B's first page shared (a prefix cache's reference),
    # then remapped to a private copy; a sole-owner page copies nothing
    src = int(pool.tables[1, 0])
    pool.ref_page(src)
    src, dst = pool.cow(1, 0)
    assert src != dst
    pair.cow(src, dst)
    assert pool.deref(src)
    same = pool.cow(1, 1)
    assert same[0] == same[1]
    pair.cow(*same)
    pool.check_conservation()
    while any(r is not None for r in slot_req):
        decode()
    pool.check_conservation()
    return pair, out, oracle


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-27b"])
def test_paged_schedule_matches_jax_and_manual_greedy(arch):
    """The whole schedule of :func:`_run_schedule`: the logits of every
    call (bucketed prefill, each chunk, each decode step, the verify
    panel) and every pool leaf after it equal JAX's within 2e-4; the
    verify step's states too; the copy-on-write exact; every greedy
    stream equal to ``manual_greedy``'s (gemma3-smoke: B's chunks cross
    the 16-token window, so the ring pages wrap mid-prompt)."""
    pair, out, oracle = _run_schedule(arch)
    assert pair.calls == {"admit": 2, "chunk": 3, "decode": 11,
                          "verify": 1}
    for r in out:
        assert out[r] == oracle[r], r


def _jax_greedy_frames(jparams, jcfg, prompt, frames, n_new, max_len):
    """``manual_greedy`` with the encoder's frames."""
    logits, cache = jlm.prefill(jparams, jnp.asarray(prompt[None]), jcfg,
                                extra={"frames": jnp.asarray(frames)},
                                alloc=max_len)
    toks = [int(jnp.argmax(logits[0]))]
    lengths = jnp.asarray([prompt.shape[0]], jnp.int32)
    for _ in range(n_new - 1):
        lg, cache = jlm.decode_step(jparams, cache,
                                    jnp.asarray([[toks[-1]]], jnp.int32),
                                    lengths, jcfg)
        toks.append(int(jnp.argmax(lg[0])))
        lengths = lengths + 1
    return toks


@pytest.mark.parametrize("arch", ["rwkv6-3b", "whisper-base"])
def test_exact_length_admit_and_paged_decode_match_greedy(arch):
    """The recurrent and encoder-decoder archs admit at exact lengths:
    ``prefill_states`` then ``insert_prefill`` writes the recurrent
    state (rwkv6) or the cross K/V (whisper) into the slot's row and the
    self-attention KV into its pages; lockstep ``decode_step(pages=)``
    then gives each request ``manual_greedy``'s stream (whisper: with
    its frames)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    prompts = [_tokens(31, (9,)), _tokens(32, (14,))]
    n_new = 8
    frames = [np.random.default_rng(33 + i).standard_normal(
        (1, tcfg.cross_len, tcfg.d_model)).astype(np.float32)
        for i in range(SLOTS)]
    with jruntime.use_impl("ref"):
        if tcfg.encdec:
            want = [_jax_greedy_frames(jparams, jcfg, p, f, n_new, MAX_LEN)
                    for p, f in zip(prompts, frames)]
        else:
            want = [manual_greedy(jparams, jcfg, jnp.asarray(p), n_new,
                                  MAX_LEN) for p in prompts]
    pool = paging.PagePool(SLOTS * MAX_PAGES, PS, SLOTS, MAX_PAGES)
    cache = lm.init_paged_cache(tcfg, SLOTS, MAX_LEN, page_size=PS,
                                dtype=torch.float32, device="cpu")
    out, lengths = [], np.zeros(SLOTS, np.int32)
    for s, p in enumerate(prompts):
        pool.admit(s, p.shape[0] + n_new)
        pool.ensure(s, p.shape[0])
        extra = {"frames": _t(frames[s])} if tcfg.encdec else None
        logits, states = lm.prefill_states(
            tparams, torch.from_numpy(p[None]).long(), tcfg, extra=extra)
        cache = lm.insert_prefill(tcfg, cache, states, slot=s,
                                  pages=torch.from_numpy(pool.tables[s]),
                                  plen=p.shape[0], page_size=PS)
        out.append([int(logits[0].argmax())])
        lengths[s] = p.shape[0]
    for _ in range(n_new - 1):
        for s in range(SLOTS):
            pool.ensure(s, int(lengths[s]) + 1)
        toks = torch.tensor([[o[-1]] for o in out])
        logits, cache = lm.decode_step(tparams, cache, toks,
                                       torch.from_numpy(lengths), tcfg,
                                       pages=torch.from_numpy(pool.tables))
        for s in range(SLOTS):
            out[s].append(int(logits[s].argmax()))
        lengths += 1
    assert out == want


def test_chunk_and_verify_refuse_other_blocks():
    """Chunk and verify modes need an attention mixer without
    cross-attention (recurrent state and the cross K/V prefill in one
    shot)."""
    from repro_torch.models import blocks
    x = torch.zeros(1, 4, 64)
    for arch in ("rwkv6-3b", "whisper-base"):
        blk = get_reduced(arch).stages()[0].body[0]
        for mode in ("chunk", "verify"):
            with pytest.raises(ValueError, match="causal-attention"):
                blocks.apply_block(blk, {}, x, cfg=get_reduced(arch),
                                   mode=mode)


# ------------------------------ sampling --------------------------------


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_k=50),
                                dict(top_k=80), dict(top_p=0.9),
                                dict(top_k=7, top_p=0.5)], ids=str)
def test_filter_logits_matches_jax(kw):
    """Top-k (k < V, k = V and k > V: clamped, keeps every token),
    nucleus, and both: the kept entries and their values equal JAX's,
    the rest -inf on both sides."""
    logits = np.random.default_rng(40).standard_normal((3, 2, 50)).astype(
        np.float32) * 3
    want = np.asarray(jsampling.filter_logits(jnp.asarray(logits), **kw))
    got = sampling.filter_logits(_t(logits), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if kw.get("top_k", 0) >= 50 and "top_p" not in kw:
        assert np.isfinite(got).all()


def test_sample_greedy_rows_take_the_argmax():
    """Per-row temperature: rows below ``GREEDY_EPS`` (0 and 1e-7)
    decode greedily from the raw logits, whatever the filter; a scalar
    temperature below it (and a 0-d tensor) is greedy for every row."""
    logits = _t(np.random.default_rng(41).standard_normal((4, 30)) * 2)
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 1e-7, 1.0, 2.0])
    for kw in (dict(), dict(top_k=3), dict(top_p=0.2)):
        toks = sampling.sample(logits, gen, temperature=temps, **kw)
        assert toks.dtype == torch.int32
        assert toks[:2].tolist() == logits[:2].argmax(-1).tolist()
    for t in (0.0, 5e-7, torch.tensor(0.0)):
        assert sampling.sample(logits, gen, temperature=t).tolist() == (
            logits.argmax(-1).tolist())
    assert sampling.GREEDY_EPS == jsampling.GREEDY_EPS


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=5),
                                dict(temperature=1.3, top_p=0.7),
                                dict(temperature=torch.full((1,), 1.0))],
                         ids=["top-k", "top-p", "per-row"])
def test_sample_follows_the_filtered_softmax(kw):
    """6000 draws from one row at a fixed generator seed: every token in
    the filtered support, and the counts pass a chi-square test against
    softmax(filter(logits / t)) at p > 1e-3."""
    n = 6000
    logits = _t(np.random.default_rng(42).standard_normal((1, 12)) * 1.5)
    t = kw["temperature"]
    tk = float(t) if not isinstance(t, torch.Tensor) else float(t[0])
    filt = sampling.filter_logits(logits / tk, top_k=kw.get("top_k", 0),
                                  top_p=kw.get("top_p", 1.0))
    probs = torch.softmax(filt, -1)[0].double().numpy()
    rows = logits.expand(n, 12)
    if isinstance(t, torch.Tensor):
        kw = dict(kw, temperature=t.expand(n))
    toks = sampling.sample(rows, torch.Generator().manual_seed(3),
                           **kw).numpy()
    support = np.flatnonzero(probs > 0)
    assert np.isin(toks, support).all()
    counts = np.bincount(toks, minlength=12)[support]
    expected = probs[support] / probs[support].sum() * n
    assert stats.chisquare(counts, expected).pvalue > 1e-3
