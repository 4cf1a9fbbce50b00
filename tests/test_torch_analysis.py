"""The port's auditor (``repro_torch.analysis``) against the JAX
package's, and each pass against a seeded violation.

Every pass gets the JAX package's treatment (``tests/test_analysis.py``):
a fixture that MUST fire with its documented RWA code, and clean code
(the shipped serving modules, the reduced engine) that MUST stay quiet.
Where the JAX pass is free of JAX (the transaction rules, the
compile-bound enumeration) the two packages give the same answer on the
same input. The engine's parameters come from JAX's initializer through
``convert.from_jax_params``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import compile_bound as jcb
from repro.analysis import rules as jrules
from repro.analysis.report import CODES as JCODES
from repro.configs import deepseek_7b as jdeepseek
from repro.models import lm as jlm
from repro_torch.analysis import (audit, compile_bound, dispatch, donation,
                                  rules, smem, sync)
from repro_torch.analysis.report import CODES, Diagnostic, PassResult
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import rowwise
from repro_torch.serve.engine import Engine, Request

ROOT = Path(__file__).resolve().parents[1]
SERVE = ROOT / "src" / "repro_torch" / "serve"


def _codes(result: PassResult):
    return sorted({d.code for d in result.diagnostics})


@pytest.fixture(scope="module")
def params():
    """deepseek-smoke's parameters from JAX's initializer (key 0, fp32)."""
    jp, _ = jlm.init_lm(jax.random.PRNGKey(0), jdeepseek.reduced(),
                        dtype=jax.numpy.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return from_jax_params(tree, get_reduced("deepseek-7b"), device="cpu")


@pytest.fixture
def engine(params):
    eng, cfg = audit.build_engine("deepseek-7b", params, "cpu")
    return eng


# ---------------------------------------------------------------- report

def test_diagnostic_rejects_unregistered_code():
    with pytest.raises(AssertionError):
        Diagnostic(code="RWA999", message="no such rule", path="x", line=1)


def test_pass_result_ok_tracks_error_severity():
    res = PassResult(name="sync")
    assert res.ok
    res.diagnostics.append(Diagnostic(code="RWA402", message="m", path="x",
                                      severity="warning"))
    assert res.ok
    res.diagnostics.append(Diagnostic(code="RWA101", message="m", path="x",
                                      line=1))
    assert not res.ok and len(res.errors()) == 1
    assert "RWA101" in str(res.errors()[0])


def test_codes_keep_the_jax_packages_where_the_meaning_carries_over():
    # the sync sinks, the bound, the transaction rules and the families
    same = ("RWA101", "RWA102", "RWA103", "RWA301", "RWA501", "RWA502",
            "RWA503")
    for code in same:
        assert CODES[code] == JCODES[code], code
    assert set(JCODES) <= set(CODES)
    assert {c[:4] for c in CODES} == {"RWA1", "RWA2", "RWA3", "RWA4",
                                      "RWA5"}


# ------------------------------------------------------------ rules pass

RULE_SNIPPETS = {
    "begin-without-commit": """
        def leak(pool, slot):
            pool.begin()
            pool.admit(slot, 1)
    """,
    "balanced-with-rollback": """
        def ok(pool, slot):
            pool.begin()
            try:
                pool.admit(slot, 1)
                pool.commit()
            except RuntimeError:
                pool.rollback()
                raise
    """,
    "eviction-inside-tx": """
        def bad(pool, slot):
            pool.begin()
            pool._make_room(3)
            pool.admit(slot, 1)
            pool.commit()
    """,
    "mutation-outside-tx": """
        def bad(pool, slot):
            pool.admit(slot, 1)
    """,
    "early-return-open": """
        def bad(self, slot):
            self.pool.begin()
            if slot:
                return 1
            self.pool.commit()
    """,
    "loop-imbalance": """
        def bad(self, slots):
            for s in slots:
                self.pool.begin()
                self.pool.ensure(s, 3)
    """,
    "jnp-concat": """
        import jax.numpy as jnp

        def fuse(parts):
            return jnp.concatenate(parts, axis=-1)
    """,
}


@pytest.mark.parametrize("name", sorted(RULE_SNIPPETS))
def test_rules_match_the_jax_package(name):
    src = textwrap.dedent(RULE_SNIPPETS[name])
    got = rules.audit_source(src, path="fixture.py")
    want = jrules.audit_source(src, path="fixture.py")
    assert _codes(got) == _codes(want)
    assert [(d.code, d.line) for d in got.diagnostics] == \
        [(d.code, d.line) for d in want.diagnostics]
    assert got.checked == want.checked
    if name == "balanced-with-rollback":
        assert got.ok and got.checked > 0
    else:
        assert not got.ok


def test_rules_torch_concat_fires_and_can_be_allowed():
    src = textwrap.dedent("""
        import torch

        def fuse(parts):
            return torch.cat(parts, dim=-1)

        def _fetch(self, *values):
            return torch.stack(values).cpu().numpy()
    """)
    res = rules.audit_source(src, path="fixture.py")
    assert _codes(res) == ["RWA504"] and len(res.diagnostics) == 2
    res = rules.audit_source(src, path="fixture.py", concat_allow=("_fetch",))
    assert len(res.diagnostics) == 1 and res.diagnostics[0].line == 5
    assert rules.audit_source(src, concat_rule=False).ok


@pytest.mark.parametrize("mod", audit.RULE_MODULES)
def test_shipped_serve_modules_rules_clean(mod):
    res = rules.audit_file(str(SERVE / mod),
                           concat_allow=audit.ENGINE_CONCAT_ALLOW)
    assert res.ok, [str(d) for d in res.errors()]


# ------------------------------------------------------------- sync pass

def _sync(src, **kw):
    return sync.audit_source(textwrap.dedent(src), path="fixture.py", **kw)


SYNC_CASES = {
    "RWA101": """
        def f(dev):
            x = torch.zeros(3, device=dev)
            return x.sum().item()
    """,
    "RWA102": """
        def f(self):
            y = self._step(1)
            return float(y[0])
    """,
    "RWA103": """
        def f(x):
            y = runtime.to_device(x, "cuda")
            return np.asarray(y * 2)
    """,
    "RWA105": """
        def f(x):
            torch.cuda.synchronize()
            return x
    """,
    "RWA107": """
        def f(self, a):
            out = torch.ones(2, device=self.device) + a
            return out.cpu()
    """,
}


@pytest.mark.parametrize("code", sorted(SYNC_CASES))
def test_sync_sink_fires(code):
    res = _sync(SYNC_CASES[code], policy=sync.SyncPolicy(
        host_read_allow={"f": 1}))
    assert code in _codes(res), [str(d) for d in res.diagnostics]


def test_sync_taint_flows_through_unknown_calls_and_self():
    res = _sync("""
        class E:
            def set(self):
                self.cache = torch.empty(4, device="cuda")

            def read(self):
                y = helper(self.cache, 3)
                return int(y)
    """)
    assert _codes(res) == ["RWA102"]


def test_sync_metadata_reads_and_host_tensors_are_not_syncs():
    res = _sync("""
        def f(dev):
            x = torch.zeros(3, 4, device=dev)
            n = int(x.shape[0]) + x.numel() + x.size(1) + x.dim()
            host = torch.tensor([1.0], dtype=torch.float64)
            return n, float(host[0]), x.to(torch.int64)
    """)
    assert res.ok and res.checked > 0


def test_sync_fetch_sites_are_held_to_the_allowlist():
    src = """
        class E:
            def run(self, a, b):
                x = self._fetch(a)
                y = self._fetch(b)
                return x, y
    """
    res = _sync(src, policy=sync.SyncPolicy(fetch_allow={"run": 1}))
    assert _codes(res) == ["RWA104"]
    assert _sync(src, policy=sync.SyncPolicy(fetch_allow={"run": 2})).ok


def test_shipped_serve_modules_sync_clean():
    for path, src in audit.serve_sources():
        policy = audit.engine_policy() if path.endswith("engine.py") \
            else sync.SyncPolicy()
        res = sync.audit_source(src, path=path, policy=policy)
        assert res.ok, f"{path}: {[str(d) for d in res.errors()]}"
        assert res.checked > 0


def test_engine_read_sites_are_the_allowlists():
    counts = sync.site_counts((SERVE / "engine.py").read_text())
    fetch = {f: n for f, (n, _) in counts.items() if n}
    reads = {f: n for f, (_, n) in counts.items() if n}
    assert fetch == audit.ENGINE_FETCH_ALLOW
    assert reads == audit.ENGINE_HOST_READ_ALLOW


def test_recorder_sees_host_reads():
    x = torch.arange(6.0)
    with dispatch.Recorder() as rec:
        y = (x * 2).sum()
        int(y)
        bool(y > 1)
        torch.nonzero(x > 2)
        torch.cat([x, x])
    assert len(rec.host_reads) == 3, rec.host_reads
    assert dispatch.count_op(rec, "cat") == 1
    assert dispatch.weight_concat(rec, 48) == [("aten.cat", 48)]
    assert dispatch.weight_concat(rec, 49) == []
    with dispatch.Recorder() as clean:
        (x * 2 + 1).relu()
    assert clean.host_reads == []


def test_entry_points_clean_and_seeded_host_read_fires(engine):
    runs = dispatch.run_entry_points(engine)
    assert [r.name for r in runs] == ["step", "prefill", "chunk", "spec"]
    res = sync.audit_entry_points(runs)
    assert res.ok and res.checked == 4
    # the engine's step state is restored after the audit's calls
    assert int(engine.lengths.abs().sum()) == 0

    def leaky(active, poison):
        nxt, bad = step(active, poison)
        int(bad.sum())                   # a host read inside the step
        return nxt, bad
    step = engine._step
    entries = [("step", leaky, runs[0].args, ())]
    res = sync.audit_entry_points(dispatch.run_entry_points(engine, entries))
    assert _codes(res) == ["RWA106"]


def test_entry_points_mirror_the_jax_engines(engine):
    """The port's entry points carry the JAX engine's names and its token
    operands' shapes (JAX: ``serve/engine.py::audit_entry_points``)."""
    entries = engine.audit_entry_points()
    assert [e[0] for e in entries] == ["step", "prefill", "chunk", "spec"]
    shapes = {name: tuple(args[0].shape) for name, _, args, _ in entries
              if name != "step"}
    assert shapes == {"prefill": (1, engine.buckets[0]),
                      "chunk": (1, engine.prefill_chunk),
                      "spec": (engine.n_slots, 1 + engine.spec_ladder[0])}


def test_submit_normalises_prompt_to_host(engine):
    """The one sanctioned read in ``submit``: a tensor prompt is taken to
    numpy once, at submission (JAX: ``test_submit_normalises_prompt_to_host``)."""
    engine.submit(Request(rid=0, prompt=torch.arange(5, dtype=torch.int32),
                          max_new=1))
    queued = engine.queue[-1].req.prompt
    assert isinstance(queued, np.ndarray) and queued.dtype == np.int32
    np.testing.assert_array_equal(queued, np.arange(5))


# --------------------------------------------------------- donation pass

def test_donation_shipped_engine_in_place(engine):
    runs = dispatch.run_entry_points(engine)
    res = donation.audit_runs(runs)
    assert res.ok, [str(d) for d in res.diagnostics]
    assert res.checked > 4 * 2


def _pool(engine):
    return engine.cache[0]["0"]["kv"]


def test_donation_rebound_leaf_fires(engine):
    def step(active, poison):
        out = engine._step(active, poison)
        kv = _pool(engine)
        engine.cache[0]["0"]["kv"] = type(kv)(kv.k.clone(), kv.v)
        return out
    runs = dispatch.run_entry_points(engine, [("step", step, (
        engine.audit_entry_points()[0][2]), ())])
    # the clone is a pool-sized allocation in the step too
    assert _codes(donation.audit_runs(runs)) == ["RWA201", "RWA204"]


def test_donation_fresh_pool_output_fires(engine):
    def step(active, poison):
        out = engine._step(active, poison)
        return out + (_pool(engine).k.clone(),)
    runs = dispatch.run_entry_points(engine, [("step", step, (
        engine.audit_entry_points()[0][2]), ())])
    assert set(_codes(donation.audit_runs(runs))) == {"RWA202", "RWA204"}


def test_donation_shared_storage_fires(engine):
    def step(active, poison):
        out = engine._step(active, poison)
        kv = _pool(engine)
        engine.cache[0]["0"]["kv"] = type(kv)(kv.k, kv.k)
        return out
    runs = dispatch.run_entry_points(engine, [("step", step, (
        engine.audit_entry_points()[0][2]), ())])
    assert "RWA203" in _codes(donation.audit_runs(runs))


def test_donation_peak_check():
    assert donation.peak_check(10, 11).ok
    assert _codes(donation.peak_check(11, 11)) == ["RWA204"]


# ---------------------------------------------------- compile-bound pass

GRID = [dict(max_len=ml, page_size=ps, prefill_chunk=pc, buckets=bk,
             table_width_bucketing=twb, speculate_k=sk)
        for ml, ps in ((64, 16), (100, 8), (512, 32))
        for pc in (0, 16, 64)
        for bk in (None, (8, 24, ml))
        for twb, sk in ((False, 0), (True, 0), (False, 3))]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_enumeration_matches_the_jax_package(kw):
    got = compile_bound.enumerate_programs(**kw)
    want = jcb.enumerate_programs(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.bound == want.bound
    audit_kw = dict(n_buckets=len(got.prefill_lens),
                    n_chunk_shapes=len(got.chunk_shapes),
                    max_pages=-(-kw["max_len"] // kw["page_size"]),
                    table_width_bucketing=kw["table_width_bucketing"],
                    n_spec_shapes=len(got.spec_shapes))
    for forged in ({}, {"n_buckets": audit_kw["n_buckets"] + 1}):
        a = compile_bound.audit_bound(got, **{**audit_kw, **forged})
        b = jcb.audit_bound(want, **{**audit_kw, **forged})
        assert _codes(a) == _codes(b) and a.checked == b.checked
    lens = [3, kw["max_len"] // 2, kw["max_len"] - 1, kw["max_len"]]
    for bucketing in (True, False):
        # the exact-length archs (no bucketing) admit whole, unchunked
        pk = dict(max_len=kw["max_len"], buckets=kw["buckets"],
                  prefill_chunk=kw["prefill_chunk"] if bucketing else 0,
                  bucketing=bucketing)
        assert compile_bound.predict_compile_counts(lens, **pk) == \
            jcb.predict_compile_counts(lens, **pk)


class _StubEngine:
    _prefill_lens = {16}
    _chunk_shapes = ()
    _step_widths = {4}

    def compile_counts(self):
        return {"prefill": 2, "chunk": 0, "step": 1}


def test_runtime_count_drift_fires():
    expected = compile_bound.predict_compile_counts([3, 5], max_len=64)
    assert expected == {"prefill": 1, "chunk": 0, "step": 1}
    res = compile_bound.check_engine_counts(
        _StubEngine(), expected, name="stub",
        signatures={"prefill": {1}, "chunk": set(), "step": {1, 2}})
    msgs = [d.message for d in res.diagnostics]
    assert _codes(res) == ["RWA303"]
    assert any("static enumeration" in m for m in msgs)
    assert any("step program took" in m for m in msgs)


def test_workload_signatures_match_the_prediction(engine, params):
    res = audit.workload_check(engine, get_reduced("deepseek-7b"), params)
    assert res.ok, [str(d) for d in res.diagnostics]
    assert res.checked == 7


def test_operand_audit_fires_on_hidden_host_copies(engine):
    runs = dispatch.run_entry_points(engine)
    assert compile_bound.operand_audit(runs).ok
    prefill = next(r for r in runs if r.name == "prefill")
    undeclared = dataclasses.replace(prefill, host=(1, 2, 3))
    assert _codes(compile_bound.operand_audit([undeclared])) == ["RWA302"]
    on_card = dataclasses.replace(runs[0], device=torch.device("cuda"))
    assert _codes(compile_bound.operand_audit([on_card])) == ["RWA302"]


# ------------------------------------------------------------ smem pass

def test_every_kernel_fits_the_h100():
    models = smem.kernel_models()
    assert len(models) == 62
    assert len({m.name for m in models}) == 62
    res = smem.audit_models(models)
    assert res.ok and res.checked == 62
    biggest = max(models, key=lambda m: m.smem)
    assert biggest.name == "layernorm_kernel_cta_wide<fp32,true>"
    assert biggest.smem == 227 * 1024 - 1024 + 256 <= smem.BUDGET


def test_overbudget_kernel_fires():
    seeded = dataclasses.replace(smem.kernel_models()[0],
                                 dynamic=smem.BUDGET + 1)
    assert _codes(smem.audit_models([seeded])) == ["RWA401"]


@pytest.mark.parametrize("case", [
    (4, 4096, 12288, "bf16", 1), (2048, 4096, 11008, "bf16", 2),
    (2048, 4096, 4096, "fp32", 1), (16, 4096, 11008, "fp32", 2),
    (2048, 4096, 4096, "int8", 1), smem.STRESS + ("fp32", 1),
    (1628, 11008, 4096, "bf16", 1), (200, 1024, 1000, "bf16", 1)], ids=str)
def test_plans_cover_their_kernels(case):
    m, k, n, dt, nw = case
    plan = rowwise.plan_matmul(m, k, n, dtype=dt, n_weights=nw)
    model = smem.model_of(plan, nw, dt)
    res = smem.crosscheck_plan(plan, model)
    assert res.ok and (plan.smem_dynamic, plan.smem_static) == (
        model.dynamic, model.static)
    forged = dataclasses.replace(plan, smem_dynamic=model.dynamic - 1,
                                 smem_static=model.static - 1)
    assert "RWA402" in _codes(smem.crosscheck_plan(forged, model))


def _source_constants(name):
    """The file-scope ``constexpr int`` constants of a ``csrc`` file,
    evaluated in order (integer arithmetic)."""
    text = (Path(rowwise.__file__).parent.parent / "csrc" / name).read_text()
    found = {}
    for key, expr in re.findall(r"^constexpr int (\w+) =\s*([^;]+);", text,
                                re.M):
        found[key] = eval(expr.split("//")[0], {}, dict(found))
    return found


def test_persistent_constants_match_the_source():
    """RWA402 on the CPU: the plan's persistent constants and its shared
    memory are the ``.cu`` file's, read from its source (the card holds
    them against the built library's query); the plan of the prefill's
    shapes covers the kernel's request and fits a block."""
    src = _source_constants("rowwise_matmul_persistent.cu")
    want = smem.PLAN_CONSTANTS["rowwise_matmul_persistent.cu"]
    got = {**src, "BN": src["BN_WIDE"]}
    assert {k: got[k] for k in want} == want
    assert src["SMEM_BYTES"] == rowwise.persistent_smem_bytes() <= smem.BUDGET
    assert smem.check_constants({**smem.PLAN_CONSTANTS}).ok
    for m, k, n, nw in ((1628, 4096, 12288, 1), (16384, 4096, 11008, 2),
                        (7084, 11008, 4096, 1), (3136, 3072, 768, 1)):
        plan = rowwise.plan_matmul(m, k, n, dtype="bf16", n_weights=nw)
        model = smem.model_of(plan, nw, "bf16")
        assert plan.design == "persistent"
        assert model.name.startswith("rowwise_matmul_kernel_persistent")
        assert smem.crosscheck_plan(plan, model).ok


def test_ssd_models_match_the_source():
    """The SSD kernels' constants are ``ssd.cu``'s, read from its source;
    their shared memory by hand from its structs: the C B^T kernel's two
    N x PITCH tiles (PITCH 68); the scan's state (N x P), two x tiles
    (K-step x P), two A / W tiles (K-step x max(N, PITCH)) and the
    chunk's cs and dt, the K-step 32 (16 at N 16). Two scan
    blocks fit an SM (its launch bounds), granite's (P 64, N 128)
    included."""
    src = _source_constants("ssd.cu")
    assert {k: src[k] for k in smem.PLAN_CONSTANTS["ssd.cu"]} == \
        smem.PLAN_CONSTANTS["ssd.cu"]
    models = {m.name: m for m in smem.kernel_models() if m.source == "ssd.cu"}
    assert len(models) == 12
    assert models["ssd_cb_kernel<128>"].dynamic == 2 * 128 * 68 * 4
    assert models["ssd_scan_kernel<64,128>"].dynamic == 4 * (
        128 * 64 + 2 * 32 * 64 + 2 * 32 * 128 + 2 * 256) == 83968
    assert models["ssd_scan_kernel<64,64>"].dynamic == 4 * (
        64 * 64 + 2 * 32 * 64 + 2 * 32 * 68 + 2 * 256)
    assert models["ssd_scan_kernel<32,16>"].dynamic == 4 * (
        16 * 32 + 2 * 16 * 32 + 2 * 16 * 68 + 2 * 256)
    for m in models.values():
        assert m.threads == 256 and m.static == 0
        if m.name.startswith("ssd_scan"):
            assert m.min_blocks == 2
            assert 2 * (m.dynamic + 1024) <= 228 * 1024


PTXAS = """== wkv.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115wkv_kernel_stepIfLi16EEEvNS_7WkvArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115wkv_kernel_stepIfLi16EEEvNS_7WkvArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
== layernorm.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121layernorm_kernel_rowsIfLi1EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121layernorm_kernel_rowsIfLi1EEEvNS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 256 bytes smem, 400 bytes cmem[0]
"""


def test_parse_ptxas():
    entries = smem.parse_ptxas(PTXAS)
    assert [(e.source, e.registers, e.smem, e.entry) for e in entries] == [
        ("wkv.cu", 40, 0, True), ("wkv.cu", 0, 0, False),
        ("layernorm.cu", 30, 256, True)]
    assert smem.spills(entries) == [("_Z6helperv", 8, 4)]


def _built(model, **kw):
    fields = dict(name=model.name, source=model.source,
                  threads=model.threads, min_blocks=model.min_blocks,
                  dynamic=model.dynamic, static=model.static, registers=32,
                  local_bytes=0, max_dynamic=model.dynamic,
                  max_threads=model.threads)
    return smem.Built(**{**fields, **kw})


def test_audit_build_clean_and_seeded():
    models = smem.kernel_models()
    built = [_built(m) for m in models]
    ptxas = [smem.PtxasEntry(m.source, f"k{i}", 32, m.static)
             for i, m in enumerate(models)]
    res = smem.audit_build(built, ptxas)
    assert res.ok and res.checked == 2 * 62 + len(smem.QUERIES)
    wg = models[0]
    for seeded, code in (
            (_built(wg, dynamic=wg.dynamic + 8), "RWA402"),
            (_built(wg, static=smem.BUDGET), "RWA401"),
            (_built(wg, registers=255), "RWA404")):
        res = smem.audit_build([seeded] + built[1:], ptxas)
        assert code in _codes(res), code
    spilled = ptxas[:1] + [dataclasses.replace(ptxas[1], spill_stores=4)] \
        + ptxas[2:]
    assert _codes(smem.audit_build(built, spilled)) == ["RWA403"]
    assert _codes(smem.audit_build(built[1:], ptxas)) == ["RWA402"]


def test_library_constants_checked():
    lib = {k: dict(v) for k, v in smem.PLAN_CONSTANTS.items()}
    assert smem.check_constants(lib).ok
    lib["rowwise_matmul_wgmma.cu"]["STAGES"] = 4
    assert _codes(smem.check_constants(lib)) == ["RWA402"]


# ------------------------------------------------------------ the CLI

def test_audit_cli_clean(tmp_path, capsys):
    out = tmp_path / "audit.json"
    assert audit.main(["--device", "cpu", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert [p["pass"] for p in rep["passes"]] == list(audit.PASSES)
    assert all(p["checked"] > 0 and p["ok"] for p in rep["passes"])
    assert [(e["name"], e["host_reads"]) for e in rep["entries"]] == [
        ("step", 0), ("prefill", 0), ("chunk", 0), ("spec", 0)]
    assert "audit: OK" in capsys.readouterr().out


def _bad_step(engine_cls):
    real = engine_cls.audit_entry_points

    def entries(self):
        out = real(self)
        name, fn, args, host = out[0]

        def step(active, poison):
            res = fn(active, poison)
            kv = self.cache[0]["0"]["kv"]
            self.cache[0]["0"]["kv"] = type(kv)(kv.k.clone(), kv.v)
            return res
        return [(name, step, args, host)] + out[1:]
    return entries


def _undeclared(engine_cls):
    real = engine_cls.audit_entry_points

    def entries(self):
        out = real(self)
        name, fn, args, host = out[1]
        return out[:1] + [(name, fn, args, host[:-1])] + out[2:]
    return entries


@pytest.mark.parametrize("pass_,code", [
    ("sync", "RWA101"), ("donation", "RWA201"), ("compile-bound", "RWA302"),
    ("smem", "RWA401"), ("rules", "RWA501")])
def test_audit_cli_fails_on_each_seeded_pass(pass_, code, monkeypatch,
                                             tmp_path, capsys):
    if pass_ == "sync":
        bad = textwrap.dedent(SYNC_CASES["RWA101"])
        srcs = audit.serve_sources() + [("bad.py", bad)]
        monkeypatch.setattr(audit, "serve_sources", lambda: srcs)
    elif pass_ == "donation":
        monkeypatch.setattr(Engine, "audit_entry_points", _bad_step(Engine))
    elif pass_ == "compile-bound":
        monkeypatch.setattr(Engine, "audit_entry_points",
                            _undeclared(Engine))
    elif pass_ == "smem":
        models = smem.kernel_models()
        monkeypatch.setattr(smem, "kernel_models", lambda: models + [
            dataclasses.replace(models[0], name="seeded",
                                dynamic=smem.BUDGET + 1)])
    else:
        bad = tmp_path / "bad.py"
        bad.write_text(textwrap.dedent(RULE_SNIPPETS["begin-without-commit"]))
        monkeypatch.setattr(audit, "RULE_MODULES",
                            audit.RULE_MODULES + (str(bad),))
    assert audit.main(["--device", "cpu", "--passes", pass_]) == 1
    out = capsys.readouterr().out
    assert code in out and "audit: FAIL" in out


def test_audit_cli_explain(capsys):
    assert audit.main(["--explain", "RWA401"]) == 0
    assert "232,448" in capsys.readouterr().out


def test_audit_cli_tensor_parallel_world(tmp_path):
    """``--mesh-shape 2``: two gloo ranks, each auditing its shard of the
    engine; rank 0 reports. In a process of its own, with a timeout."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--device",
         "cpu", "--mesh-shape", "2", "--passes",
         "sync,donation,compile-bound", "--dist-timeout", "120"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "tensor-parallel model=2" in out.stdout
    assert "audit: OK" in out.stdout
