"""The port's serving engine and its host modules against the JAX
package's, on CPU.

The host modules first: ``serve/faults.py`` (plans parsed, drawn and
queried), ``serve/spec.py::propose`` and ``serve/prefix_cache.py`` (one
seeded sequence of inserts, matches, evictions and releases over both
packages' page pools) must equal the reference's exactly. Then whole
engine runs: the same requests on the same weights (the JAX
initializer's, converted by ``from_jax_params``) through the JAX engine
(``use_impl("ref")``) and the port's (``device="cpu"``), at the reduced
sizes of deepseek-7b, gemma3-27b (gemma3-smoke: a 16-token window, so
ring pages wrap), rwkv6-3b, zamba2-1.2b (page pools and Mamba2 state in
one cache) and qwen2-moe-a2.7b, and on a weight-only int8 deepseek-7b
tree. For every scenario each completion's
``(rid, tokens, status, prompt_len)``, the ``stats`` dict and the
shape counts (``compile_counts``, against JAX's jit cache sizes) must
be equal, and the greedy streams of some scenarios equal
``conftest.manual_greedy``. Sampled runs cannot match ``jax.random``
token for token: their statuses and lengths must be equal, and the
verify step's emitted token after a rejected draft must follow the
residual distribution (chi-square, p > 1e-3), its acceptances the
draft's probability (binomial, p > 1e-3). The serving CLI runs on the
CPU at the end.
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy
from scipy import stats

from repro.configs import (deepseek_7b, gemma3_27b, qwen2_moe, qwen2_vl,
                           rwkv6_3b, zamba2)
from repro.core import quant as jquant
from repro.core import runtime as jruntime
from repro.core.types import PagingConfig as JPagingConfig
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import paging as jpaging
from repro.serve import prefix_cache as jprefix_cache
from repro.serve import spec as jspec
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core.types import PagingConfig
from repro_torch.launch import serve as tserve
from repro_torch.serve import engine, faults, paging, prefix_cache, spec

ARCHS = {"deepseek-7b": deepseek_7b, "gemma3-27b": gemma3_27b,
         "rwkv6-3b": rwkv6_3b, "zamba2-1.2b": zamba2,
         "qwen2-moe-a2.7b": qwen2_moe, "qwen2-vl-2b": qwen2_vl}
JAX_SIDE = types.SimpleNamespace(
    Engine=jengine.Engine, Request=jengine.Request, Fault=jfaults.Fault,
    FaultPlan=jfaults.FaultPlan, Paging=JPagingConfig, kw={})
PORT_SIDE = types.SimpleNamespace(
    Engine=engine.Engine, Request=engine.Request, Fault=faults.Fault,
    FaultPlan=faults.FaultPlan, Paging=PagingConfig, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_MODELS = {}


def _model(arch):
    """(jcfg, tcfg, jparams, tparams) of one reduced arch, built once
    per module. ``<arch>-int8``: the weight-only int8 tree JAX's
    ``quantize_tree`` makes with ``lm_weight_predicate`` (key 4, as
    ``tests/test_fused_layout.py::test_quantized_tree_engine_smoke``
    builds it), converted leaf for leaf."""
    if arch not in _MODELS:
        base = arch.removesuffix("-int8")
        jcfg, tcfg = ARCHS[base].reduced(), get_reduced(base)
        int8 = base != arch
        params, _ = jlm.init_lm(jax.random.PRNGKey(4 if int8 else 0), jcfg,
                                dtype=jnp.float32)
        if int8:
            params = jquant.quantize_tree(params, jquant.lm_weight_predicate)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[arch] = (jcfg, tcfg, params,
                         from_jax_params(tree, tcfg, device="cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _MODELS.clear()


def _prompts(plens, seed, vocab=256, repetitive=False):
    rng = np.random.default_rng(seed)
    out = []
    for p in plens:
        if repetitive:
            phrase = rng.integers(0, vocab, 3)
            out.append(np.tile(phrase, -(-p // 3))[:p].astype(np.int32))
        else:
            out.append(rng.integers(0, vocab, p).astype(np.int32))
    return out


# ------------------------------ host modules ----------------------------


def _fields(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


@pytest.mark.parametrize("text", [
    "", "alloc@3,nan@5.1,exc@7,slow@2:0.01", " nan@4 , alloc@0,",
    "exc@6,nan@4.1,alloc@2", "slow@1:0.5,slow@1:0.25,nan@1.0,nan@1"])
def test_fault_plans_parse_as_jax(text):
    """``parse_plan``: the same faults field for field, the same
    ``describe``, the same answer to every query at every clock."""
    got, want = faults.parse_plan(text), jfaults.parse_plan(text)
    assert _fields(got) == _fields(want)
    assert got.describe() == want.describe() and len(got) == len(want)
    assert repr(got) == repr(want)
    assert got == faults.FaultPlan(got.faults) and got != want
    for step in range(-1, 10):
        assert got.alloc_fails(step) == want.alloc_fails(step)
        assert got.poison_slots(step) == want.poison_slots(step)
        assert got.step_raises(step) == want.step_raises(step)
        assert got.slow_s(step) == want.slow_s(step)
        assert ([dataclasses.astuple(f) for f in got.at(step)]
                == [dataclasses.astuple(f) for f in want.at(step)])
    assert got.max_step() == want.max_step()


@pytest.mark.parametrize("bad", ["boom@3", "nan@x", "alloc@-1",
                                 "slow@2:fast", "nan@1.x"])
def test_fault_plans_refuse_as_jax(bad):
    with pytest.raises(ValueError) as port:
        faults.parse_plan(bad)
    with pytest.raises(ValueError) as ref:
        jfaults.parse_plan(bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_fault_plans_equal_jax(seed):
    kw = dict(n_slots=3, p_alloc=0.25, p_nan=0.1, p_exc=0.08, p_slow=0.05,
              slow_s=1e-4)
    got = faults.FaultPlan.random(seed, 40, **kw)
    want = jfaults.FaultPlan.random(seed, 40, **kw)
    assert _fields(got) == _fields(want) and len(got) > 0
    assert got == faults.FaultPlan.random(seed, 40, **kw)
    assert got.describe() == want.describe()


def test_propose_matches_jax():
    """``spec.propose`` on random histories over small vocabularies (so
    n-grams recur), every k and n-gram cap: the same draft."""
    rng = np.random.default_rng(0)
    assert spec.MAX_NGRAM == jspec.MAX_NGRAM == 3
    for _ in range(300):
        hist = rng.integers(0, int(rng.integers(2, 6)),
                            int(rng.integers(0, 24))).astype(np.int32)
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 4))
        got = spec.propose(hist, k, max_ngram=n)
        want = jspec.propose(hist, k, max_ngram=n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _cache_state(pool, cache):
    def walk(children):
        return sorted((key, node.page, node.last_use, walk(node.children))
                      for key, node in children.items())
    return (list(pool.free), pool.refs.tolist(), pool.tables.tolist(),
            walk(cache.root), cache.evictions)


def test_prefix_cache_matches_jax():
    """Both packages' ``PrefixCache`` over their own ``PagePool``
    through one seeded sequence: admissions that fill a slot's pages and
    insert its prompt, matches of prompts sharing prefixes (full pages,
    a partial page, a miss), ``evictable``, ``reclaim`` with pinned and
    free branches, releases and a ``reset``: every result and the pool
    and tree after every op equal; the pool conserved."""
    ps, slots, max_pages = 4, 3, 6
    sides = []
    for pg, pc in ((paging, prefix_cache), (jpaging, jprefix_cache)):
        pool = pg.PagePool(24, ps, slots, max_pages)
        cache = pc.PrefixCache(pool)
        pool.reclaimer = cache
        sides.append((pool, cache))
    rng = np.random.default_rng(5)
    bases = [rng.integers(0, 9, 20).astype(np.int32) for _ in range(3)]

    def prompt():
        base = bases[int(rng.integers(3))]
        n = int(rng.integers(1, 21))
        p = base[:n].copy()
        if rng.random() < 0.3 and n > 1:
            p[int(rng.integers(n))] += 1
        return p

    live = set()
    for _ in range(150):
        op = rng.choice(["admit", "match", "reclaim", "release",
                         "evictable"], p=[0.3, 0.3, 0.15, 0.2, 0.05])
        p = prompt()
        slot = int(rng.integers(slots))
        n = int(rng.integers(1, 5))
        out = []
        for pool, cache in sides:
            if op == "admit":
                if slot in live or not pool.can_admit(len(p)):
                    out.append(None)
                    continue
                if pool._pages_for(len(p)) > len(pool.free):
                    cache.reclaim(pool._pages_for(len(p)) - len(pool.free))
                pool.admit(slot, len(p))
                pool.ensure(slot, len(p))
                out.append(cache.insert(p, pool.tables[slot]))
            elif op == "match":
                out.append(cache.match(p))
            elif op == "reclaim":
                out.append(cache.reclaim(n))
            elif op == "release":
                pool.release(slot)
                out.append(None)
            else:
                out.append(cache.evictable())
        if op == "admit" and out[0] is not None:
            live.add(slot)
        if op == "release":
            live.discard(slot)
        assert out[0] == out[1], (op, out)
        assert _cache_state(*sides[0]) == _cache_state(*sides[1]), op
        sides[0][0].check_conservation()
    for pool, cache in sides:
        cache.reset()
    assert _cache_state(*sides[0]) == _cache_state(*sides[1])


# ------------------------------ engine runs -----------------------------


def _engine(side, params, cfg, *, n_slots=2, max_len=64, page_size=8,
            n_pages=0, chunk=0, prefix=False, k=0, twb=False, budget=0,
            **kw):
    return side.Engine(params, cfg, n_slots=n_slots, max_len=max_len,
                       eos_id=-1, paging=side.Paging(
                           page_size=page_size, n_pages=n_pages,
                           prefill_chunk=chunk, prefix_cache=prefix,
                           speculate_k=k, table_width_bucketing=twb,
                           prefill_token_budget=budget),
                       **kw, **side.kw)


def _serve(eng, side, prompts, max_new, rid0=0, **kw):
    for i, p in enumerate(prompts):
        eng.submit(side.Request(rid=rid0 + i, prompt=p, max_new=max_new,
                                **kw))
    return list(eng.run())


def _simple(plens, seed, max_new, repetitive=False, **eng_kw):
    """A scenario: the prompts of ``plens`` served once on an engine of
    ``eng_kw``."""
    def run(side, params, cfg):
        eng = _engine(side, params, cfg, **eng_kw)
        return eng, _serve(eng, side, _prompts(plens, seed,
                                               repetitive=repetitive),
                           max_new)
    run.prompts = lambda: _prompts(plens, seed, repetitive=repetitive)
    run.max_new = max_new
    run.max_len = eng_kw.get("max_len", 64)
    return run


def _prefix_matrix(side, params, cfg):
    """The hit / miss / partial-page COW matrix: a donor miss fills the
    tree, a full hit maps its pages, a mid-page divergence copies on
    write, a cold miss, and the capped hit of a fully cached
    page-aligned prompt (its last page demoted to COW)."""
    sys_p, t1, t2, t3, t4 = _prompts([24, 8, 8, 12, 24], 3)
    prompts = [np.concatenate([sys_p, t1]), np.concatenate([sys_p, t2]),
               np.concatenate([sys_p[:20], t3]), t4, sys_p]
    eng = _engine(side, params, cfg, chunk=16, prefix=True)
    return eng, _serve(eng, side, prompts, 5)


def _prefix_duplicate(side, params, cfg):
    """Two identical prompts in one step: the second defers, then maps
    the first's pages."""
    (p,) = _prompts([40], 7)
    eng = _engine(side, params, cfg, chunk=16, prefix=True)
    return eng, _serve(eng, side, [p, p], 4)


def _prefix_preempt(side, params, cfg):
    """Pool-pressure preemption of slots admitted through prefix hits:
    the victim re-matches its shared pages on re-admission."""
    base, *tails = _prompts([8, 1, 2, 3], 9)
    eng = _engine(side, params, cfg, max_len=32, n_pages=6, chunk=16,
                  prefix=True, preempt_patience=2)
    done = _serve(eng, side, [base], 1, rid0=10)
    done += _serve(eng, side, [np.concatenate([base, t]) for t in tails], 8)
    return eng, done


def _faults(plan_specs, plens, seed, max_new, **eng_kw):
    """A scenario: the prompts served under a fixed fault plan."""
    def run(side, params, cfg):
        plan = side.FaultPlan.from_specs(*[side.Fault(*f)
                                           for f in plan_specs])
        eng = _engine(side, params, cfg, faults=plan, **eng_kw)
        return eng, _serve(eng, side, _prompts(plens, seed), max_new)
    return run


def _nan_then_clean(side, params, cfg):
    """All-slot poisoning retires both live requests as failed; the
    engine then serves a clean request."""
    prompts = _prompts([5, 7], 8)
    eng = _engine(side, params, cfg, max_len=32,
                  faults=side.FaultPlan.from_specs(side.Fault("nan", 2)))
    done = _serve(eng, side, prompts, 8)
    eng.faults = side.FaultPlan()
    return eng, done + _serve(eng, side, prompts[:1], 6, rid0=9)


def _cancel_deadline(side, params, cfg):
    """A cancelled queued request, an expired deadline, two served."""
    prompts = _prompts([5, 6, 7, 8], 13)
    eng = _engine(side, params, cfg, n_slots=1, max_len=32)
    for rid in (0, 1):
        eng.submit(side.Request(rid=rid, prompt=prompts[rid], max_new=4))
    eng.submit(side.Request(rid=2, prompt=prompts[2], max_new=4,
                            deadline_s=0.0))
    eng.submit(side.Request(rid=3, prompt=prompts[3], max_new=4))
    assert eng.cancel(1) and not eng.cancel(1) and not eng.cancel(42)
    return eng, list(eng.run())


def _deadline_inversion(side, params, cfg):
    """A deadlined head behind deadline-free residents preempts the
    youngest of them at once."""
    prompts = _prompts([9, 10, 9], 5)
    eng = _engine(side, params, cfg, max_len=32, n_pages=6)
    for rid, n in ((0, 12), (1, 12)):
        eng.submit(side.Request(rid=rid, prompt=prompts[rid], max_new=n))
    eng.submit(side.Request(rid=2, prompt=prompts[2], max_new=4,
                            deadline_s=30.0))
    return eng, list(eng.run())


def _max_steps(side, params, cfg):
    """``run(max_steps=3)`` flushes everything as preempted_requeued;
    the engine then serves a resubmission."""
    prompts = _prompts([5, 9], 17)
    eng = _engine(side, params, cfg, n_slots=1, max_len=32)
    for rid, p in enumerate(prompts):
        eng.submit(side.Request(rid=rid, prompt=p, max_new=8))
    done = list(eng.run(max_steps=3))
    eng.completed = []
    return eng, done + _serve(eng, side, prompts[:1], 8)


def _random_plan(side, params, cfg):
    """A seeded random plan (alloc, nan, exc, slow) under preemption
    pressure; the plans of both packages equal field for field."""
    plan = side.FaultPlan.random(11, 24, n_slots=2, p_alloc=0.25, p_nan=0.1,
                                 p_exc=0.08, p_slow=0.05, slow_s=1e-4)
    want = jfaults.FaultPlan.random(11, 24, n_slots=2, p_alloc=0.25,
                                    p_nan=0.1, p_exc=0.08, p_slow=0.05,
                                    slow_s=1e-4)
    assert _fields(plan) == _fields(want)
    eng = _engine(side, params, cfg, max_len=32, n_pages=6, faults=plan,
                  preempt_patience=3)
    return eng, _serve(eng, side, _prompts([3, 9, 6, 12, 5], 11), 5)


SCENARIOS = {
    # (arch, scenario, greedy-checked, check on the port's engine)
    "bucketed": ("deepseek-7b", _simple([5, 9, 20, 3], 0, 6), False,
                 lambda e: e.compile_counts()["prefill"] >= 2),
    "table-width": ("deepseek-7b", _simple([5, 9, 20, 3], 0, 6, twb=True),
                    False, lambda e: e.compile_counts()["step"] >= 2),
    "chunked": ("deepseek-7b", _simple([40, 20, 7, 33], 1, 6, chunk=16),
                True, lambda e: e.compile_counts()["chunk"] >= 1),
    "chunk-budget": ("deepseek-7b", _simple([48, 48], 11, 4, chunk=16,
                                            prefix=True, budget=16),
                     False, lambda e: e.stats["budget_deferred_chunks"]),
    "prefix-matrix": ("deepseek-7b", _prefix_matrix, False,
                      lambda e: e.stats["prefix_hits"] >= 2
                      and e.stats["cow_copies"] + e.stats["cow_in_place"]),
    "prefix-duplicate": ("deepseek-7b", _prefix_duplicate, False,
                         lambda e: e.stats["share_deferrals"]
                         and e.stats["prefix_hits"] == 1),
    "prefix-eviction": ("deepseek-7b", _simple(
        [32] * 6, 13, 4, max_len=48, n_pages=10, chunk=16, prefix=True),
        False, lambda e: e.prefix_cache.evictions > 0),
    "prefix-preempt": ("deepseek-7b", _prefix_preempt, False,
                       lambda e: e.stats["preemptions"]
                       and e.stats["prefix_hits"] >= 3),
    "spec-off": ("deepseek-7b", _simple([7, 10, 13], 2, 8,
                                        repetitive=True, max_len=48),
                 False, lambda e: "spec" not in e.compile_counts()),
    "spec-repetitive": ("deepseek-7b", _simple(
        [7, 10, 13], 2, 8, repetitive=True, max_len=48, k=4), False,
        lambda e: e.stats["spec_accepted"] > 0),
    "spec-incompressible": ("deepseek-7b", _simple(
        [7, 10, 13], 2, 8, max_len=48, k=4), False,
        lambda e: e.stats["spec_steps"] > 0),
    "spec-length-cap": ("deepseek-7b", _simple(
        [12], 6, 8, repetitive=True, max_len=18, k=4), False,
        lambda e: e.completed[0].status == "length"),
    # chunks across the 16-token window, the prefix cache opted out,
    # verify panels over ring pages
    "window-chunked-spec": ("gemma3-27b", _simple(
        [37, 13], 4, 8, repetitive=True, chunk=16, prefix=True, k=4),
        False, lambda e: e.prefix_cache is None
        and e.stats["spec_accepted"] > 0),
    "rwkv-exact": ("rwkv6-3b", _simple([5, 9, 3], 0, 6, max_len=32), True,
                   lambda e: e.buckets is None),
    # the shared block's page pools and the Mamba layers' per-slot state
    # in one cache; slots refill
    "zamba2-exact": ("zamba2-1.2b", _simple([5, 9, 3, 12], 0, 6,
                                            max_len=32), True,
                     lambda e: e.buckets is None
                     and e.prefix_cache is None),
    # idle slots' rows compete for the decode step's expert capacity
    "qwen2-moe-exact": ("qwen2-moe-a2.7b", _simple([5, 9, 3, 12], 1, 6,
                                                   max_len=32), True,
                        lambda e: e.buckets is None),
    # a vision frontend: text-only requests at exact lengths, decode
    # rotating by text positions (t = h = w)
    "qwen2-vl-exact": ("qwen2-vl-2b", _simple([5, 9, 3, 12], 2, 6,
                                              max_len=32), True,
                       lambda e: e.buckets is None
                       and e.prefix_cache is None),
    # a weight-only int8 tree: the cache in the config's bf16
    "int8-tree": ("deepseek-7b-int8", _simple([4, 5, 6], 4, 3, max_len=32),
                  True, lambda e: e.cache_dtype == torch.bfloat16),
    "preempt-patience": ("deepseek-7b", _simple(
        [9, 10, 11], 3, 8, max_len=32, n_pages=6, preempt_patience=2),
        False, lambda e: e.stats["preemptions"]),
    "spec-preempt": ("deepseek-7b", _simple(
        [9, 10, 11], 5, 8, repetitive=True, max_len=32, n_pages=6,
        preempt_patience=2, k=4), False, lambda e: e.stats["preemptions"]),
    "deadline-inversion": ("deepseek-7b", _deadline_inversion, False,
                           lambda e: e.stats["preemptions"]),
    "nan-then-clean": ("deepseek-7b", _nan_then_clean, False,
                       lambda e: e.stats["nan_quarantined"] == 2),
    "faults-seeded": ("deepseek-7b", _faults(
        [("alloc", 0), ("alloc", 2), ("nan", 4, 0), ("exc", 6)],
        [3, 9, 6, 12], 0, 6, max_len=32, page_size=4), False,
        lambda e: e.stats["alloc_faults"] >= 2 and e.stats["recoveries"]
        == 1 and e.stats["nan_quarantined"] == 1),
    "step-exception": ("deepseek-7b", _faults(
        [("exc", 3)], [3, 9, 6], 11, 6, max_len=32), False,
        lambda e: e.stats["recoveries"] == 1),
    "chunk-faults": ("deepseek-7b", _faults(
        [("alloc", 1), ("exc", 2)], [40, 20], 23, 4, chunk=16), False,
        lambda e: e.stats["recoveries"] == 1),
    "unserviceable": ("deepseek-7b", _simple([24, 5], 19, 8, max_len=32,
                                             n_pages=2), False,
                      lambda e: e.completed[0].status == "failed"),
    "cancel-deadline": ("deepseek-7b", _cancel_deadline, False,
                        lambda e: True),
    "max-steps": ("deepseek-7b", _max_steps, False, lambda e: True),
    "random-plan": ("deepseek-7b", _random_plan, False,
                    lambda e: e.stats["recoveries"] + e.stats[
                        "nan_quarantined"] + e.stats["alloc_faults"]),
}


def _summary(done):
    return [(c.rid, [int(t) for t in c.tokens], c.status, c.prompt_len)
            for c in done]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax(name):
    """The port's engine against the JAX engine on one scenario: every
    completion's (rid, tokens, status, prompt_len), ``stats`` and the
    shape counts equal; the pool conserved; where marked, every ``ok`` stream equal to ``manual_greedy``."""
    arch, scenario, greedy_checked, check = SCENARIOS[name]
    jcfg, tcfg, jparams, tparams = _model(arch)
    with jruntime.use_impl("ref"):
        jeng, jdone = scenario(JAX_SIDE, jparams, jcfg)
    teng, tdone = scenario(PORT_SIDE, tparams, tcfg)
    assert _summary(tdone) == _summary(jdone)
    assert teng.stats == jeng.stats
    assert teng.compile_counts() == jeng.compile_counts()
    assert teng.errors == jeng.errors
    assert check(teng), teng.stats
    teng.pool.check_conservation()
    for c in tdone:
        assert len(c.itl_s) == max(len(c.tokens) - 1, 0), c.rid
    if greedy_checked:
        prompts = scenario.prompts()
        with jruntime.use_impl("ref"):
            for c in tdone:
                if c.status == "ok":
                    assert c.tokens == manual_greedy(
                        jparams, jcfg, jnp.asarray(prompts[c.rid]),
                        scenario.max_new, scenario.max_len), c.rid


def test_engine_reads_the_device_once_a_call(monkeypatch):
    """Every admission, final chunk, decode step and speculative step
    reads the device exactly once; an intermediate chunk never: the
    reads counted equal the calls that fetch, with the prefix cache,
    chunked prefill and speculation all on."""
    _, tcfg, _, tparams = _model("deepseek-7b")
    calls = {"admit": 0, "chunk": 0, "step": 0, "spec": 0}
    for name in calls:
        orig = getattr(engine.Engine, f"_{name}")

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(engine.Engine, f"_{name}", counted)
    eng = _engine(PORT_SIDE, tparams, tcfg, chunk=16, prefix=True, k=3)
    prompts = _prompts([40, 9, 33], 2, repetitive=True)
    done = _serve(eng, PORT_SIDE, prompts + [prompts[0]], 8)
    assert all(c.status == "ok" for c in done)
    finals = len(done) - calls["admit"]      # one final chunk a chunked rid
    assert calls["chunk"] > finals and calls["spec"] > 0
    assert eng.device_reads == (calls["admit"] + finals + calls["step"]
                                + calls["spec"])


@pytest.mark.parametrize("case", [
    ("rwkv6-3b", dict(buckets=[16, 32])),
    ("deepseek-7b", dict(buckets=[16])),
    ("rwkv6-3b", dict(chunk=16)),
    ("deepseek-7b", dict(chunk=24)),
    ("deepseek-7b", dict(prefix=True)),
    ("rwkv6-3b", dict(k=2)),
    ("deepseek-7b", dict(k=2, twb=True)),
    ("zamba2-1.2b", dict(buckets=[16, 32])),
    ("zamba2-1.2b", dict(chunk=16)),
    ("qwen2-moe-a2.7b", dict(k=2)),
], ids=lambda c: f"{c[0]}-{'-'.join(c[1])}")
def test_engine_config_rejections_match_jax(case):
    """Every config the JAX engine refuses at construction, the port's
    refuses with the same message."""
    arch, kw = case
    jcfg, tcfg, jparams, tparams = _model(arch)
    with pytest.raises(ValueError) as ref:
        _engine(JAX_SIDE, jparams, jcfg, **kw)
    with pytest.raises(ValueError) as port:
        _engine(PORT_SIDE, tparams, tcfg, **kw)
    assert str(port.value) == str(ref.value)


def test_engine_windowed_and_device_choices():
    """A windowed arch opts out of the prefix cache silently, as in JAX;
    the cache dtype follows the override, else the embed leaf; the
    parameters must live on the engine's device."""
    jcfg, tcfg, jparams, tparams = _model("gemma3-27b")
    jeng = _engine(JAX_SIDE, jparams, jcfg, chunk=16, prefix=True)
    teng = _engine(PORT_SIDE, tparams, tcfg, chunk=16, prefix=True)
    assert jeng.prefix_cache is None and teng.prefix_cache is None
    assert teng.pool.reclaimer is None
    _, dcfg, _, dparams = _model("deepseek-7b")
    assert _engine(PORT_SIDE, dparams, dcfg).cache_dtype == torch.float32
    eng = _engine(PORT_SIDE, dparams, dcfg, cache_dtype="bfloat16")
    assert eng.cache_dtype == torch.bfloat16
    meta = dict(dparams, embed=dparams["embed"].to("meta"))
    with pytest.raises(ValueError, match="move them"):
        _engine(PORT_SIDE, meta, dcfg)


@pytest.mark.parametrize("k", [0, 2])
def test_sampled_runs_match_jax_in_shape(k):
    """Temperature, top-k and top-p, with and without speculation:
    ``jax.random`` and a ``torch.Generator`` draw different streams, so
    only the statuses and lengths must equal JAX's; every token is a
    real vocabulary id, and a seed replays its stream."""
    jcfg, tcfg, jparams, tparams = _model("deepseek-7b")
    prompts = _prompts([7, 12, 5], 3, repetitive=True)
    kw = dict(k=k, max_len=48, temperature=0.8, top_k=5, top_p=0.9,
              seed=3)
    with jruntime.use_impl("ref"):
        want = _serve(_engine(JAX_SIDE, jparams, jcfg, **kw), JAX_SIDE,
                      prompts, 6)
    got = _serve(_engine(PORT_SIDE, tparams, tcfg, **kw), PORT_SIDE,
                 prompts, 6)
    again = _serve(_engine(PORT_SIDE, tparams, tcfg, **kw), PORT_SIDE,
                   prompts, 6)
    assert (sorted((c.rid, c.status, len(c.tokens)) for c in got)
            == sorted((c.rid, c.status, len(c.tokens)) for c in want))
    assert _summary(got) == _summary(again)
    assert all(0 <= t < tcfg.vocab for c in got for t in c.tokens)


@pytest.mark.parametrize("filt", [dict(), dict(top_k=5)], ids=["full",
                                                               "top-k"])
def test_verify_step_follows_the_residual_distribution(filt):
    """``engine.accept_drafts`` on one fixed panel (a committed token,
    then a 1-token draft) over 20000 rows, i.e. 20000 draws of one
    generator: the draft is accepted with its probability under the
    (filtered) softmax of row 0 (binomial test), a rejection emits from
    row 0's distribution with the draft masked out (the residual) and an
    acceptance from row 1's (chi-square tests, p > 1e-3); a greedy row
    accepts exactly when the draft is row 0's argmax."""
    v, n = 8, 20000
    logits = torch.tensor([[1.2, 0.4, 0.9, -0.3, 0.1, 0.6, -1.0, 0.0],
                           [0.2, 1.1, -0.4, 0.5, 0.9, -0.2, 0.3, 0.0]])
    draft = 2
    safe = logits.expand(n, 2, v)
    tokens = torch.tensor([[0, draft]]).expand(n, 2)
    gen = torch.Generator().manual_seed(0)
    nxt, n_acc = engine.accept_drafts(
        safe, tokens, torch.ones(n), torch.ones(n, dtype=torch.int64), gen,
        **filt)
    probs = [torch.softmax(engine.sampling.filter_logits(
        row, **filt), dim=-1).double().numpy() for row in logits]
    acc = n_acc.numpy() == 1
    assert stats.binomtest(int(acc.sum()), n, probs[0][draft]).pvalue > 1e-3
    residual = probs[0].copy()
    residual[draft] = 0.0
    for rows, p in ((~acc, residual / residual.sum()), (acc, probs[1])):
        counts = np.bincount(nxt.numpy()[rows], minlength=v)
        keep = p > 0
        assert counts[~keep].sum() == 0
        want = p[keep] / p[keep].sum() * counts.sum()
        assert stats.chisquare(counts[keep], want).pvalue > 1e-3
    # greedy rows: accept iff the draft is the argmax, emit the argmax
    for d in (0, draft):
        g_nxt, g_acc = engine.accept_drafts(
            logits[None], torch.tensor([[0, d]]), torch.zeros(1),
            torch.ones(1, dtype=torch.int64), gen, **filt)
        assert int(g_acc) == int(d == 0)
        assert int(g_nxt) == int(logits[int(g_acc)].argmax())


# ------------------------------ the CLI ---------------------------------


def _cli(capsys, *args):
    done = tserve.main(["--smoke", "--device", "cpu", *args])
    return done, capsys.readouterr().out


def test_cli_serves_on_the_cpu(capsys):
    """``launch/serve.py`` on the CPU: deepseek-7b chunked with the
    prefix cache and speculation, rwkv6-3b at exact lengths — every
    request ok, the shape counts and the KV-traffic line printed as the
    JAX CLI prints them; at ``--mesh-shape model=2`` two ranks (gloo on
    the CPU) serve the same completions, and a mesh JAX refuses is
    refused."""
    done, out = _cli(capsys, "--arch", "deepseek-7b", "--requests", "6",
                     "--slots", "2", "--max-len", "64", "--page-size", "8",
                     "--max-new", "6", "--prefill-chunk", "16",
                     "--prompt-len", "30", "--prefix-cache",
                     "--speculate", "2")
    assert "statuses: {'ok': 6}" in out
    assert "placement=single-device device=cpu" in out
    kv = re.search(r"KV bytes/trace: paged=([\d,]+) dense=([\d,]+)", out)
    assert kv and 0 < int(kv[1].replace(",", "")) < int(
        kv[2].replace(",", ""))
    m = re.search(r"compiles: prefill=(\d+) chunk=(\d+) step=(\d+) "
                  r"spec=(\d+) buckets=\[16, 32, 64\] prefill_chunk=16", out)
    assert m and int(m[2]) >= 1 and int(m[3]) == 1 and int(m[4]) >= 1
    assert len(done) == 6 and all(len(c.tokens) == 6 for c in done)

    done, out = _cli(capsys, "--arch", "rwkv6-3b", "--requests", "4",
                     "--slots", "2", "--max-len", "32", "--page-size", "8",
                     "--max-new", "5", "--fault-plan", "alloc@1,nan@3.0")
    assert "statuses: {'failed': 1, 'ok': 3}" in out
    assert "faults: alloc@1,nan@3.0" in out
    assert ("KV traffic: n/a (no attention layers); compiles: prefill=4 "
            "chunk=0 step=1 spec=0 buckets=None prefill_chunk=0") in out
    for mesh, msg in (("data=1", "unknown mesh axis"), ("3", "cannot shard")):
        with pytest.raises(ValueError, match=msg):
            tserve.main(["--smoke", "--device", "cpu", "--mesh-shape",
                         mesh])
    deepseek = ["--arch", "deepseek-7b", "--requests", "6", "--slots", "2",
                "--max-len", "64", "--page-size", "8", "--max-new", "6",
                "--prefill-chunk", "16", "--prompt-len", "30"]
    _, out = _cli(capsys, *deepseek)
    rows = re.findall(r"rid=\d+ status=\w+ prompt_len=\d+ tokens=\[[^]]*\]",
                      out)
    done, out = _cli(capsys, *deepseek, "--mesh-shape", "model=2")
    assert done is None and "statuses: {'ok': 6}" in out
    assert "placement=tensor-parallel model=2 device=cpu" in out
    assert re.search(r"ranks: 2, every rank's completions [0-9a-f]{16}", out)
    assert re.findall(
        r"rid=\d+ status=\w+ prompt_len=\d+ tokens=\[[^]]*\]", out) == rows


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-moe-a2.7b"])
def test_cli_serves_the_hybrid_and_moe_archs(capsys, arch):
    """``launch/serve.py`` on the CPU for the Mamba2 hybrid and an MoE
    arch: exact-length prefill (no buckets), every request ok; a chunk
    size is refused as the JAX engine refuses it."""
    done, out = _cli(capsys, "--arch", arch, "--requests", "4", "--slots",
                     "2", "--max-len", "32", "--page-size", "8",
                     "--max-new", "5")
    assert "statuses: {'ok': 4}" in out
    assert ("compiles: prefill=4 chunk=0 step=1 spec=0 buckets=None "
            "prefill_chunk=0") in out
    assert len(done) == 4 and all(len(c.tokens) == 5 for c in done)
    with pytest.raises(ValueError, match="recurrent/MoE prefill state"):
        tserve.main(["--smoke", "--device", "cpu", "--arch", arch,
                     "--prefill-chunk", "16"])
