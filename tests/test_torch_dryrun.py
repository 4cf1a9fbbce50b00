"""The dry run (``launch/dryrun.py``) against the JAX package's.

* The registry the dry run walks (``ARCHS``, ``REDUCED``, ``SHAPES``,
  ``SMOKE_SHAPES``, ``cell_applicable``, ``all_cells``) equals JAX's, and
  ``cell_rules`` equals JAX's for every arch x shape. JAX's
  ``launch/dryrun.py`` forces 512 host devices when imported, so its
  ``cell_rules`` is read from the source and run here alone.
* Every applicable cell's per-rank blocks (parameters or state, the
  decode cache, the inputs) from the port's ``resolve`` equal the blocks
  JAX's ``partitioning.resolve`` gives on a stand-in mesh, pod and
  multipod. One difference, by decision: a 5-dim cache leaf that the
  port reads whole (a sliding-window layer's ring, on the unsharded
  decode path; the cross K/V; a recurrent state, RWKV6's
  (H, P, P) or Mamba2's) is split by its layers and batch alone, where
  JAX names it (kv_seq, kv_heads) and GSPMD gathers it where it is read.
  The test counts those leaves and resolves the port's names on both
  sides.
* The CLI in a subprocess (the fake process group never opens in the
  test's process): cells write their JSON with every key, an
  inapplicable cell its skip, a failing cell ``ok: false`` and a
  non-zero exit; the op walk's CLI prints a cell's breakdown.
"""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import partitioning as jpart
from repro.core.types import ModelConfig as JModelConfig
from repro.core.types import ShapeSpec as JShapeSpec
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.core import partitioning as part
from repro_torch.core import tree as tree_lib
from repro_torch.core.types import jax_fields
from repro_torch.launch import dryrun, specs
from repro_torch.models import lm
from repro_torch.train import step as tsl

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@functools.cache
def _jax_cell_rules():
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "cell_rules")
    ns = {"ModelConfig": JModelConfig, "ShapeSpec": JShapeSpec}
    exec(compile(ast.Module([fn], []), "repro/launch/dryrun.py", "exec"),
         ns)
    return ns["cell_rules"]


def _shape_tuple(s):
    return (s.name, s.kind, s.seq_len, s.global_batch)


def test_registry_matches_jax():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert list(configs.REDUCED) == list(jconfigs.REDUCED)
    for arch in configs.ARCHS:
        assert jax_fields(configs.ARCHS[arch]) == \
            dataclasses.asdict(jconfigs.ARCHS[arch])
        assert configs.get_config(arch) is configs.ARCHS[arch]
        assert jax_fields(configs.REDUCED[arch]()) == \
            dataclasses.asdict(jconfigs.REDUCED[arch]())
    for mine, theirs in ((configs.SHAPES, jconfigs.SHAPES),
                         (configs.SMOKE_SHAPES, jconfigs.SMOKE_SHAPES)):
        assert {k: _shape_tuple(v) for k, v in mine.items()} == \
            {k: _shape_tuple(v) for k, v in theirs.items()}
        assert list(mine) == list(theirs)
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            assert configs.cell_applicable(arch, shape) == \
                jconfigs.cell_applicable(arch, shape)
    for skipped in (False, True):
        assert list(configs.all_cells(skipped)) == \
            list(jconfigs.all_cells(skipped))
    cells = list(configs.all_cells(True))
    assert len(cells) == 40 and len(list(configs.all_cells())) == 33
    # long_500k only for the sub-quadratic archs
    assert {a for a, s in configs.all_cells() if s == "long_500k"} == {
        a for a, c in configs.ARCHS.items() if c.subquadratic}


@pytest.mark.parametrize("arch,shape", list(configs.all_cells(True)))
def test_cell_rules_match_jax(arch, shape):
    want = _jax_cell_rules()(jconfigs.get_config(arch),
                             jconfigs.SHAPES[shape])
    assert dryrun.cell_rules(configs.get_config(arch),
                             configs.SHAPES[shape]) == want


@functools.cache
def _jax_params(arch):
    """JAX's parameter shapes and logical specs at full size (traced by
    ``eval_shape``; the specs are Python values made while tracing)."""
    box = {}

    def init(key):
        params, specs = jlm.init_lm(key, jconfigs.get_config(arch))
        box["specs"] = specs
        return params
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return (jax.tree_util.tree_leaves(shapes),
            jax.tree_util.tree_leaves(box["specs"],
                                      is_leaf=jpart._is_spec_leaf))


def _local(spec, shape, sizes):
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


def _port_blocks(cfg, spec, mesh, rules):
    """This rank's block shape of every argument leaf of a cell, from
    the dry run's own arguments and names: {key: [shape, ...]}."""
    args, names = dryrun.cell_arguments(cfg, spec,
                                        tsl.TrainConfig(remat=True))
    with part.use_mesh(mesh, rules):
        shardings = part.tree_shardings(mesh, names, like=args)
    return {k: [s.local_shape(tuple(t.shape)) for s, t in zip(
        tree_lib.leaves(shardings[k]), tree_lib.leaves(args[k]))]
        for k in args}


def _read_whole(cfg):
    """The 5-dim cache leaves the port reads whole: the rings' and the
    cross K/V's two each, a recurrent state one a block."""
    n = 0
    for stage in cfg.stages():
        for blk in stage.body:
            n += 2 * bool(blk.mixer == "attn" and blk.window)
            n += 2 * bool(blk.cross_attn)
            n += int(blk.mixer in ("rwkv6", "mamba2"))
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", list(configs.all_cells()))
def test_cell_blocks_match_jax(arch, shape, mesh):
    mshape, names = MESHES[mesh]
    sizes = dict(zip(names, mshape))
    jmesh = SimpleNamespace(axis_names=names, devices=np.empty(mshape))
    pmesh = part.MeshShape(mshape, names)
    cfg, spec = configs.get_config(arch), configs.SHAPES[shape]
    rules = dryrun.cell_rules(cfg, spec)
    got = _port_blocks(cfg, spec, pmesh, rules)

    jcfg, jspec = jconfigs.get_config(arch), jconfigs.SHAPES[shape]
    leaves, jnames = _jax_params(arch)
    want = {}
    with jpart.use_mesh(None, rules):
        def block(names_, shape_):
            return _local(jpart.resolve(tuple(names_), jmesh, shape=shape_),
                          tuple(shape_), sizes)
        params = [block(n, s.shape) for n, s in zip(jnames, leaves)]
        want["state" if spec.kind == "train" else "params"] = params
        if spec.kind == "decode":
            jcache = jax.eval_shape(lambda: jlm.init_cache(
                jcfg, jspec.global_batch, jspec.seq_len, jnp.bfloat16))
            cleaves = jax.tree_util.tree_leaves(jcache)
            cnames = jax.tree_util.tree_leaves(
                jlm.cache_logical_specs(jcache),
                is_leaf=jpart._is_spec_leaf)
            cache, _ = specs.abstract_cache(cfg, spec.global_batch,
                                            spec.seq_len)
            # in tree order (a dict's keys sorted, as JAX walks them)
            pnames = [sh.names for sh in tree_lib.leaves(part.tree_shardings(
                pmesh, lm.cache_logical_specs(cache, cfg)))]
            assert len(pnames) == len(cnames)
            whole = 0
            for pn, jn in zip(pnames, cnames):
                # a leaf the port reads whole: split by layers and batch
                if pn != jn:
                    assert pn == jn[:2] + (None,) * (len(jn) - 2)
                    whole += 1
            assert whole == _read_whole(cfg)
            want["cache"] = [block(n, c.shape)
                             for n, c in zip(pnames, cleaves)]
        jin = jspecs.input_specs(jcfg, jspec)
        want["inputs"] = [block(("batch",) + (None,) * (len(v.shape) - 1),
                                v.shape) for v in
                          jax.tree_util.tree_leaves(jin)]
    if spec.kind == "train":
        # the state's parameters lead its leaves; the moments repeat them
        n = len(want["state"])
        assert got["state"][:n] == want["state"]
        assert got["state"][n + 1:3 * n + 1] == want["state"] * 2
        got["state"] = got["state"][:n]
    assert got == want


def _cli(*argv, module="repro_torch.launch.dryrun", timeout=240):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


KEYS = {"arch", "shape", "mesh", "chips", "flops_per_device",
        "bytes_per_device", "coll_bytes_per_device", "model_flops",
        "attn_internal_bytes", "compute_t", "memory_t", "memory_t_fused",
        "collective_t", "bound", "step_time", "step_time_unfused", "mfu",
        "mfu_unfused", "useful_flops_ratio", "memory_analysis",
        "live_bytes_per_device", "fits_hbm_80g", "launches_by_kernel",
        "collectives", "params_total", "params_active", "rules", "seconds",
        "schedule", "call_bound_ms", "glue_bound_ms", "kernel_bound_ms",
        "ok"}


def test_cli_writes_each_cell(tmp_path):
    """rwkv6-3b's long_500k decode (B=1) on both meshes: one JSON a
    cell with every key, the WKV step design launched once a layer, the
    cache cut along the heads over ``data``; deepseek-7b's long_500k a
    documented skip."""
    out = _cli("--arch", "rwkv6-3b", "--shape", "long_500k", "--mesh",
               "both", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dry-run complete: 2 ok, 0 skipped, 0 FAILED" in out.stdout
    cfg = configs.get_config("rwkv6-3b")
    for mesh, chips in (("pod", 256), ("multipod", 512)):
        rec = json.loads((tmp_path / f"rwkv6-3b__long_500k__{mesh}.json")
                         .read_text())
        assert KEYS <= set(rec) and rec["ok"] and rec["chips"] == chips
        assert rec["schedule"] == "fsdp-by-hand"
        assert rec["launches_by_kernel"]["wkv step"]["launches"] == \
            cfg.n_layers
        assert rec["rules"]["kv_heads"] == "data" and \
            rec["rules"]["batch"] is None
        assert rec["collectives"]["counts"]["all_gather"] > 0
        mem = rec["memory_analysis"]
        assert rec["live_bytes_per_device"] == \
            mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        assert rec["fits_hbm_80g"] and rec["flops_per_device"] > 0
    skip = _cli("--arch", "deepseek-7b", "--shape", "long_500k", "--out",
                str(tmp_path))
    assert skip.returncode == 0
    assert json.loads((tmp_path / "deepseek-7b__long_500k__pod.json")
                      .read_text())["skipped"]


def test_cli_fails_loudly(tmp_path):
    """A cell that fails is recorded with its error and the exit code is
    non-zero (here a rank outside the world)."""
    out = _cli("--arch", "deepseek-7b", "--shape", "decode_32k", "--rank",
               "256", "--out", str(tmp_path))
    assert out.returncode == 1
    assert "1 FAILED" in out.stdout
    rec = json.loads((tmp_path / "deepseek-7b__decode_32k__pod.json")
                     .read_text())
    assert rec == {"ok": False,
                   "error": "ValueError: rank 256 of a world of 256"}


def test_op_cost_cli_prints_a_cell():
    out = _cli("--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--top",
               "5", module="repro_torch.launch.op_cost")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "== per-op traffic (qwen2-moe-a2.7b x decode_32k, pod" in \
        out.stdout
    assert "kernel rowwise_matmul wgmma" in out.stdout    # 8 rows a rank
    assert "== top 5 sites ==" in out.stdout
