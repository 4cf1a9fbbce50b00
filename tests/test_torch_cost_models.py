"""The port's cost models against the JAX package's: the Hopper tile
plan (``core/rowwise.py``), the paper's ASIC model, the rest of
``core/block_traffic.py``, ``configs/shapes.py``, ``launch/specs.py`` and
``launch/roofline.py``.

Where both packages compute the same thing from the same inputs the
answer is equal exactly: the ASIC model, the shapes, the parameter
counts, the model FLOPs and the flash-attention floor, every flop count
and the chunked-prefill and prefix-cache models. Where the two price a
kernel launch differently (the JAX package pads each operand to its TPU
tile, the port re-reads x once per column tile and the weights once per
row tile), the test names the term and holds each side to a closed form
written here.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.configs.swin_t import CONFIG as JSWIN
from repro.configs.swin_t import VIT_CONFIG as JVIT
from repro.core import asic_model as jasic
from repro.core import block_traffic as jbt
from repro.core import rowwise as jrw
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch.configs import get_config, get_reduced, shapes
from repro_torch.configs.swin_t import CONFIG as SWIN
from repro_torch.configs.swin_t import VIT_CONFIG as VIT
from repro_torch.core import asic_model, block_traffic as bt, rowwise
from repro_torch.kernels import rowwise_matmul as rm
from repro_torch.launch import roofline, specs
from repro_torch.models import lm

ARCHS = ["deepseek-7b", "gemma3-27b", "granite-20b", "internlm2-20b",
         "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b", "qwen2-vl-2b",
         "rwkv6-3b", "whisper-base", "zamba2-1.2b"]


# ------------------------------------------------------------- rowwise

@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 128, 2048])
def test_plan_takes_the_wrappers_design(m, dtype):
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.int8}[dtype]
    for nw in (1, 2):
        plan = rowwise.plan_matmul(m, 4096, 11008, dtype=dtype,
                                   n_weights=nw)
        assert plan.design == rm.pick_design(m, tdt, 11008, 4096)
        if plan.design == "wgmma":
            assert (plan.bm, plan.bn, plan.bk) == (
                128, 64 if nw == 2 else 128, 128 // {"bf16": 2,
                                                      "int8": 1}[dtype])
            assert plan.smem_dynamic == 165968 and plan.blocks_per_sm == 1
            assert plan.stages == 5
        elif plan.design == "persistent":
            # N = 11008 = 43 x 256: the wide tile, 128 gated
            assert (plan.bm, plan.bn, plan.bk) == (
                128, 128 if nw == 2 else 256, 64)
            assert plan.smem_dynamic == 230464 and plan.blocks_per_sm == 1
            assert plan.stages == 4 and plan.threads == 384
            units = -(-m // 256) * plan.n_pad // plan.bn
            assert plan.grid == (2 * min(units, 66), 1, 1)
            assert plan.waves == -(-units // 66)
            assert plan.group == min(-(-m // 256), 8)
        elif plan.design == "ffma":
            assert (plan.bm, plan.bn, plan.bk) == (64, 64, 16)
            assert plan.blocks_per_sm == (2 if nw == 2 else 3)
        else:
            splits, kc = rm.skinny_splits(11008, 4096, nw == 2, 132)
            assert (plan.k_splits, plan.bk, plan.bn) == (splits, kc, 64)
            assert plan.grid == (172, splits, nw)
        if plan.design != "persistent":
            assert plan.waves == math.ceil(
                plan.blocks / (132 * plan.blocks_per_sm))
        assert plan.flops == 2 * m * 4096 * 11008 * nw
        assert plan.utilization == pytest.approx(
            m * 4096 * 11008 / (plan.m_pad * plan.k_pad * plan.n_pad))


# (M, N, gated): ragged M and N, fewer tiles than SMs, N a multiple of
# 256 (the wide tile) and not, gated; the deepseek-7b prefill's shapes
WALK_SHAPES = [(1, 256, False), (130, 200, False), (1628, 12288, False),
               (7084, 4096, False), (16384, 11008, True), (257, 1000, True),
               (2047, 768, False)]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
def test_persistent_walk_visits_every_tile_once(shape):
    """The persistent plan's walk, as its clusters take it (cluster c the
    unit indices c, c + clusters, ...; its block r the unit's row panel
    r), visits every output tile exactly once, at the group the rule
    picks and at every group it can pick; past the last row panel only
    the odd panel count's spare block."""
    m, n, gated = shape
    c = rowwise.PERSISTENT_CLUSTER
    plan = rowwise.plan_matmul(m, 4096, n, dtype="bf16",
                               n_weights=2 if gated else 1,
                               design="persistent")
    mt, nt = plan.m_pad // plan.bm, plan.n_pad // plan.bn
    units = -(-mt // c) * nt
    assert plan.bn == (128 if gated or n % 256 else 256)
    assert plan.grid == (c * min(units, 132 // c), 1, 1)
    assert plan.waves == -(-units // (132 // c))
    assert plan.group == rowwise.persistent_group(mt) == min(
        -(-mt // c), rowwise.PERSISTENT_GROUP // c)
    every = sorted((r, col) for r in range(mt) for col in range(nt))
    clusters = plan.grid[0] // c
    for group in range(1, rowwise.PERSISTENT_GROUP // c + 1):
        if group > -(-mt // c):
            break
        walk = rowwise.persistent_walk(mt, nt, group)
        assert len(walk) == units
        taken = [(u * c + r, col) for cl in range(clusters)
                 for i in range(cl, units, clusters)
                 for u, col in [walk[i]] for r in range(c)]
        assert sorted(t for t in taken if t[0] < mt) == every, group
        assert all(r == mt for r, _ in taken if r >= mt)
    # a wave of the rule's walk spans the group's row panels
    first = rowwise.persistent_walk(mt, nt, plan.group)[:clusters]
    assert {u for u, _ in first} == set(range(min(plan.group,
                                                  -(-mt // c))))


def test_persistent_plan_refuses_what_it_cannot_take():
    for kw in (dict(dtype="int8"), dict(dtype="fp32"),
               dict(dtype="bf16", prologue=True)):
        with pytest.raises(ValueError, match="persistent"):
            rowwise.plan_matmul(2048, 4096, 4096, design="persistent", **kw)


def _port_bytes(m, k, n, db, *, bm, bn, n_w=1, residual=False,
                prologue=False, ob=None):
    """The port's closed form: x read once per column tile, the weights
    once per row tile, the output (and residual) once."""
    ob = ob or db
    total = (m * k * db * -(-n // bn) + k * n * db * n_w * -(-m // bm)
             + m * n * ob)
    return total + (m * n * ob if residual else 0) + (
        2 * k * 4 if prologue else 0)


def _jax_bytes(plan, db, *, n_w=1, residual=False, prologue=False, ob=None):
    """The JAX package's closed form: every operand padded to its TPU
    tile, x re-read once per column tile, the weights once unless the K
    axis splits."""
    ob = ob or db
    n_tiles = plan.n_pad // plan.bn
    w_factor = 1 if plan.k_splits == 1 else plan.m_pad // plan.bm
    total = (plan.k_pad * plan.n_pad * db * w_factor * n_w
             + plan.m_pad * plan.k_pad * db * n_tiles
             + plan.m_pad * plan.n_pad * ob)
    return total + (plan.m_pad * plan.n_pad * ob if residual else 0) + (
        2 * plan.k_pad * 4 if prologue else 0)


@pytest.mark.parametrize("mkn", [(128, 512, 128), (2048, 4096, 12288),
                                 (3136, 96, 288), (100, 200, 300)])
@pytest.mark.parametrize("kw", [{}, {"residual": True},
                                {"prologue": True}], ids=str)
def test_plan_bytes_against_the_jax_package(mkn, kw):
    m, k, n = mkn
    plan = rowwise.plan_matmul(m, k, n, dtype="bf16", **kw)
    jplan = jrw.plan_matmul(m, k, n, dtype_bytes=2, out_bytes=2, **kw)
    assert plan.flops == jplan.flops
    assert plan.bytes_moved == _port_bytes(m, k, n, 2, bm=plan.bm,
                                           bn=plan.bn, **kw)
    assert jplan.bytes_moved == _jax_bytes(jplan, 2, **kw)
    # operands that divide both tiles and a plan with no re-read: the
    # same reads, the same bytes
    if mkn == (128, 512, 128):
        assert plan.bytes_moved == jplan.bytes_moved


def test_skinny_bytes_closed_form():
    plan = rowwise.plan_matmul(4, 4096, 12288, dtype="bf16")
    s = plan.k_splits
    assert s > 1
    assert plan.bytes_moved == (4 * 4096 * 2 * 192 + 4096 * 12288 * 2
                                + 4 * 12288 * 2 + 2 * s * 4 * 12288 * 4)


def test_schedule_model_matches_the_jax_package():
    ops = asic_model.swin_ops(SWIN)
    jops = jasic.swin_ops(JSWIN)
    rep = rowwise.schedule_model(ops, dtype="bf16")
    jrep = jrw.schedule_model(jops)
    assert rep.total_flops == jrep.total_flops
    assert rep.dominant() == jrep.dominant()
    assert 0.5 < rep.utilization <= 1.0


# ---------------------------------------------------------- ASIC model

def _asic_fields(rep):
    return (rep.cycles, rep.total_macs, rep.time_s, rep.images_per_s,
            rep.utilization, rep.achieved_gops, rep.flops_shares())


@pytest.mark.parametrize("which", ["swin-t", "vit-b16"])
def test_asic_model_matches_the_jax_package(which):
    ops = asic_model.swin_ops(SWIN) if which == "swin-t" else \
        asic_model.vit_ops(VIT)
    jops = jasic.swin_ops(JSWIN) if which == "swin-t" else \
        jasic.vit_ops(JVIT)
    assert [dataclasses.astuple(o) for o in ops] == \
        [dataclasses.astuple(o) for o in jops]
    assert [asic_model.op_cycles(o) for o in ops] == \
        [jasic.op_cycles(o) for o in jops]
    assert _asic_fields(asic_model.run_asic(ops)) == \
        _asic_fields(jasic.run_asic(jops))


def test_asic_model_reproduces_the_paper():
    """The model of the paper's 40 nm ASIC (not a measurement): Table
    III's 403.2 GOPS, Table IV's Swin-T latency, Fig. 2's shares."""
    assert asic_model.ASIC.macs == 336
    assert asic_model.ASIC.peak_gops == jasic.ASIC.peak_gops
    assert abs(asic_model.ASIC.peak_gops - 403.2) < 1e-9
    rep = asic_model.run_asic(asic_model.swin_ops(SWIN))
    assert abs(rep.time_s * 1e3 - 22.4) / 22.4 < 0.05
    assert rep.flops_shares()["fc"] >= 0.95
    p = asic_model.swin_params(SWIN)
    assert p == jasic.swin_params(JSWIN)
    assert p["fc"] / sum(p.values()) >= 0.83


# --------------------------------------------------------- block traffic

def test_swin_t_stage_cases_match():
    for batch in (1, 8):
        assert bt.swin_t_stage_cases(batch) == jbt.swin_t_stage_cases(batch)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("db", [2, 4])
def test_swin_block_traffic(stage, fused, shifted, db):
    geo = bt.swin_t_stage_cases(8)[stage]
    got = bt.swin_block_traffic(**geo, fused=fused, shifted=shifted,
                                dtype_bytes=db)
    want = jbt.swin_block_traffic(**geo, fused=fused, shifted=shifted,
                                  dtype_bytes=db)
    assert [n for n, _ in got["ops"]] == [n for n, _ in want["ops"]]
    m = 8 * geo["grid_h"] * geo["grid_w"]
    c, f = geo["c"], 4 * geo["c"]
    bm = bn = 128 if db == 2 else 64
    mm = {"ln1+qkv(wide-N)": (c, 3 * c, dict(prologue=True)),
          "proj+residual": (c, c, dict(residual=True)),
          "ln2+mlp1+gelu": (c, f, dict(prologue=True)),
          "mlp2+residual": (f, c, dict(residual=True)),
          "qkv": (c, 3 * c, {}), "proj": (c, c, {}),
          "mlp1+gelu": (c, f, {}), "mlp2": (f, c, {})}
    for (name, b), (_, jb) in zip(got["ops"], want["ops"]):
        if name in mm:
            # a matmul: the port's re-reads per tile against the JAX
            # package's pad to its TPU tile
            k, n, kw = mm[name]
            # the tile of the design the call takes (bf16's persistent
            # one is 256 wide where N is a multiple of 256)
            plan = rowwise.plan_matmul(m, k, n, dtype={2: "bf16",
                                                        4: "fp32"}[db],
                                       prologue=kw.get("prologue", False))
            assert (plan.bm, plan.bn) in ((bm, bn), (bm, 256)), name
            assert b == _port_bytes(m, k, n, db, bm=plan.bm, bn=plan.bn,
                                    **kw), name
            jkw = dict(kw, wide_n=name.startswith("ln"))
            jplan = jrw.plan_matmul(m, k, n, dtype_bytes=db, out_bytes=db,
                                    **jkw)
            assert jb == _jax_bytes(jplan, db, **kw), name
        else:
            # norms, attention, residual adds: the same closed forms
            assert b == jb, name
    assert got["total"] == sum(b for _, b in got["ops"])


@pytest.mark.parametrize("plen,chunk,ps", [(100, 16, 16), (33, 32, 8),
                                           (512, 64, 32), (7, 16, 16)])
def test_chunked_prefill_traffic_matches(plen, chunk, ps):
    kw = dict(chunk_size=chunk, page_size=ps, n_global=3, n_local=2,
              window=40, n_kv_heads=4, head_dim=16, dtype_bytes=2)
    assert bt.chunked_prefill_traffic(plen, **kw) == \
        jbt.chunked_prefill_traffic(plen, **kw)
    for arch in ("deepseek-7b", "gemma3-27b"):
        assert bt.chunked_prefill_traffic_cfg(
            get_reduced(arch), plen, chunk_size=chunk, page_size=ps) == \
            jbt.chunked_prefill_traffic_cfg(
                _jreduced(arch), plen, chunk_size=chunk, page_size=ps)


def _jreduced(arch):
    """The JAX package's reduced config of ``arch``."""
    import importlib
    mod = {"deepseek-7b": "deepseek_7b", "gemma3-27b": "gemma3_27b",
           "qwen2-vl-2b": "qwen2_vl", "whisper-base": "whisper_base"}[arch]
    return importlib.import_module(f"repro.configs.{mod}").reduced()


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-27b",
                                  "qwen2-moe-a2.7b", "internlm2-20b"])
def test_prefix_models_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for plen, hit in ((1, 0), (100, 0), (100, 37), (4096, 4096), (513, 512)):
        assert bt.prefix_prefill_flops(cfg, plen, hit) == \
            jbt.prefix_prefill_flops(jcfg, plen, hit)
    reqs = [(100, 0), (100, 64), (37, 32), (512, 500)]
    assert bt.prefix_cache_traffic(cfg, reqs, page_size=16) == \
        jbt.prefix_cache_traffic(jcfg, reqs, page_size=16)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-27b"])
def test_spec_step_traffic(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    kw = dict(lengths=[100, 37, 512], accepted_total=4, page_size=16)
    got = bt.spec_step_traffic(cfg, **kw)
    want = jbt.spec_step_traffic(jcfg, **kw)
    for key in ("kv_bytes", "emitted"):
        assert got[key] == want[key], key
    # the weights: the port's panels read once, unpadded, at decode
    # (the skinny design); the JAX package pads them to its tile
    qo, kvo = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    d, f = cfg.d_model, cfg.d_ff
    per_block = (d * (qo + 2 * kvo) + qo * d + 2 * d * f + f * d) * 2
    n_blocks = sum(st.repeat * len(st.body) for st in cfg.stages())
    assert got["weight_bytes"] == n_blocks * per_block
    assert want["weight_bytes"] >= got["weight_bytes"]
    assert got["step_bytes"] == got["weight_bytes"] + got["kv_bytes"]
    assert got["bytes_per_accepted"] == got["step_bytes"] / got["emitted"]


# --------------------------------------------------------------- shapes

def test_shapes_match():
    for table, jtable in ((shapes.SHAPES, jshapes.SHAPES),
                          (shapes.SMOKE_SHAPES, jshapes.SMOKE_SHAPES)):
        assert list(table) == list(jtable)
        for name in table:
            assert dataclasses.astuple(table[name]) == \
                dataclasses.astuple(jtable[name])
            assert table[name].tokens == jtable[name].tokens


# ---------------------------------------------------------------- specs

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches(arch):
    assert specs.param_count(get_config(arch)) == \
        jspecs.param_count(jget_config(arch))


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2-vl-2b",
                                  "whisper-base"])
def test_input_specs_and_cache_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in shapes.SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, jshapes.SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    rcfg = get_reduced(arch)
    cache, _ = specs.abstract_cache(rcfg, 2, 8)
    jcache, _ = jspecs.abstract_cache(_jreduced(arch), 2, 8)
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in _leaves(cache)]
    want = [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(jcache)]
    assert got == want


def _leaves(tree):
    """Tensor leaves in JAX's pytree order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def test_abstract_init_and_train_state_on_meta():
    from repro_torch.train.step import TrainConfig
    cfg = get_reduced("deepseek-7b")
    params, specs_ = specs.abstract_init(cfg)
    leaves = _leaves(params)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert specs_ == lm.logical_specs(cfg)
    state, sspecs = specs.abstract_train_state(cfg, TrainConfig())
    sleaves = _leaves(state)
    assert all(t.device.type == "meta" for t in sleaves)
    assert sum(t.numel() for t in sleaves) >= 3 * sum(
        t.numel() for t in leaves)


# ------------------------------------------------------------- roofline

def test_bound_is_the_h100s():
    assert roofline.bound(989e12, 0, "bf16") == (1e3, "operations")
    assert roofline.bound(0, 3.35e12, torch.float32) == (1e3, "bytes")
    assert roofline.bound(67e12, 3.35e12 * 0.5, "fp32")[0] == 1e3
    assert roofline.PEAK_FLOPS == {"fp32": 67e12, "bf16": 989e12,
                                   "int8": 1979e12}
    assert roofline.PEAK_BYTES == 3.35e12


def test_chip_smoke_keeps_one_definition_of_the_bound():
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    names = {t.id for node in ast.parse(src).body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name)}
    assert not names & {"PEAK_FLOPS", "PEAK_BYTES"}
    assert "from repro_torch.launch.roofline import" in src


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_flash_min_bytes_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = specs.param_count(cfg)["active"] if arch == "deepseek-7b" else 10**9
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert roofline.model_flops(n, shape.tokens, shape.kind) == \
            jroof.model_flops(n, jshape.tokens, jshape.kind)
        for chips in (1, 4):
            assert roofline.flash_min_bytes(cfg, shape, chips) == \
                jroof.flash_min_bytes(jcfg, jshape, chips)


@pytest.mark.parametrize("sq,skv,causal,window,off", [
    (64, 64, True, 0, 0), (49, 49, False, 0, 0), (17, 300, True, 16, 283),
    (64, 1500, False, 0, 0), (100, 100, True, 7, 0)])
def test_attention_pairs_count_the_mask(sq, skv, causal, window, off):
    qpos = off + np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    allowed = np.ones((sq, skv), bool)
    if causal:
        allowed &= kpos <= qpos
    if window:
        allowed &= kpos > qpos - window
    assert roofline.attention_pairs(sq, skv, causal=causal, window=window,
                                    q_offset=off) == int(allowed.sum())


def test_records_price_the_calls():
    """The reduced deepseek-7b's prefill recorded on the CPU (its plain
    calls, noted unlaunched): each record's operations and bytes from its
    shapes, and the recording switch changes no output."""
    cfg = get_reduced("deepseek-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = lm.prefill(params, tokens, cfg)
        with roofline.recording() as recs:
            got, _ = lm.prefill(params, tokens, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert recs and not any(r["launched"] for r in recs)
    kinds = {r["kernel"] for r in recs}
    assert kinds == {"rowwise_matmul", "flash_attention", "layernorm"}
    for r in recs:
        flops, nbytes, dt = roofline.price(r)
        t = r["tensors"]
        assert dt == "fp32"
        assert nbytes == sum(int(np.prod(s)) * 4 for s, _ in t.values())
        if r["kernel"] == "rowwise_matmul":
            (m, k), n = t["x"][0], t["w"][0][1]
            assert flops == 2 * m * k * n * (2 if "w_gate" in t else 1)
    rep = roofline.report(recs, arch=cfg.name)
    by = rep.by_kernel()
    assert sum(e["launches"] for e in by.values()) == len(recs)
    assert rep.bound_ms == pytest.approx(sum(e["bound_ms"]
                                             for e in by.values()))
    assert rep.collective_t == 0
    # outside the block, nothing is recorded
    with torch.no_grad():
        lm.prefill(params, tokens, cfg)
    assert len(recs) == len(rep.launches)


def test_collective_bytes_price_on_nvlink():
    got = roofline.collective_bytes({"all_gather": 10, "tp_gather": 5,
                                     "all_reduce": 7, "tp_reduce": 1,
                                     "reduce_scatter": 3, "all_to_all": 2})
    assert got == {"all-gather": 15, "all-reduce": 8, "reduce-scatter": 3,
                   "all-to-all": 2, "collective-permute": 0}
    rep = roofline.report([], coll_bytes=got)
    assert rep.collective_t == 28 / 450e9


def test_roofline_cli_on_the_cpu(capsys):
    assert roofline.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "prefill B=2 x 16 bf16" in out and "decode step" in out
    assert "rowwise_matmul wgmma" in out and "rowwise_matmul skinny" in out
