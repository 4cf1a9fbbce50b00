"""The port's training mesh on the CPU: one 8-rank gloo world on the
(pod=2, data=2, model=2) mesh (``tests/torch_mesh_harness.py``), every
scenario run in it once, held against the JAX package's functions that
run on one device and against the port's one device:

* the sharded train step (``make_train_step(..., mesh=)``) of reduced
  deepseek-7b, zamba2-1.2b, rwkv6-3b and qwen2-vl-2b (fp32, B=4, so
  ``batch`` drops ``model`` and two ranks hold each row; qwen2-vl-2b's
  ``positions3`` split along its axis 1) against JAX's single-device
  ``_grads_and_metrics`` + ``_apply_update`` and the port's own step,
  over 3 steps with ``warmup_steps=1`` (JAX's dist scenario compares
  after one step, at ``lr_scale = 0``, where any update passes);
* cross-pod compression against a JAX oracle composed of functions that
  run on one device (each pod's ``_grads_and_metrics``, then
  ``compressed_pmean_tree`` under ``vmap(axis_name="pod")``, then
  ``_apply_update``), and against the exact step;
* expert parallelism (reduced phi3.5-moe, one row a rank) against JAX's
  and the port's ``_apply_local``, a dropping case against JAX's
  ``_apply_ep`` (8 host devices, a process of its own), and the
  gradient through both all-to-alls against one device's;
* the sequence-sharded decode (reduced deepseek-7b, B=2, 32 positions:
  16 a rank) against JAX's unsharded ``decode_step`` and the port's;
* a sharded state saved from (2,2,2), restored onto (4,2) bitwise, and
  read bitwise by JAX's ``ckpt.restore``;
* ``launch/train.py --mesh host`` (eight ranks it spawns): one device's
  losses, checkpoints it and one device resume from, and a
  ``--compress-pods`` run whose loss falls.

Tolerances, each with its reason (fp32 throughout):

* losses 1e-5 (the sums over ranks and rows in another order);
* step-0 gradients 1e-5 x max(1, max|g|) a leaf (the same);
* parameters after 3 steps: |diff| <= 2 lr (lr_scale_1 + lr_scale_2)
  everywhere, and within 1e-5 for all but 1e-3 of each leaf's elements.
  Adam divides by sqrt(v) + eps: where a gradient element is rounding
  noise (~1e-9, as a gradient summed over ranks in another order can
  be) its update is a ±lr step whose sign the noise picks, so a single
  element may move by up to 2 lr lr_scale a step; every other element
  agrees to fp32 rounding;
* compression against the composed oracle: loss 1e-5; the residual
  within 2e-3 x max|residual| (a thousandth of a quantization step)
  except where an element's int8 rounding sits on a .5 boundary and
  the two packages' gradients round it apart: a whole step there
  (counted: at most 1e-3 of a leaf, plus 2; 1-2 a leaf measured); the
  parameters as above (such an element's mean gradient moves by a
  step, its Adam update by up to 2 lr); against the exact step JAX's
  own limits where JAX applies them (the first step's loss 1e-4, each
  leaf's max relative difference < 0.1 after an update, the residual
  non-zero). The loss after an update is not held to 1e-4: Adam's
  first update moves every element by lr sign(g), and an element the
  int8 mean rounds to 0 stays, so compressed and exact part by ~1e-2
  nats there (JAX's scenario compares at ``lr_scale = 0``);
* the MoE output 1e-5, the aux loss 1e-6, gradients 1e-5 x max(1,
  max|g|); the decode's logits 1e-5.
"""
import contextlib
import io
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_harness as harness

from repro.checkpoint import checkpointer as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import tree as tree_lib
from repro_torch.launch import train as train_cli
from repro_torch.models import lm, moe
from repro_torch.optim import adamw
from repro_torch.train import step as tsl

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5
STRAY = 1e-3          # the share of a leaf's elements allowed past it


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results, and the one-device oracles computed while
    its ranks run."""
    out = tmp_path_factory.mktemp("mesh_world")
    inputs = harness.write_inputs(out)
    running = harness.start_world(out)
    try:
        oracles = _oracles(inputs)
    except BaseException:
        for p in running["procs"]:
            p.kill()
        raise
    ranks, jax_ep = harness.wait_world(running)
    return {"dir": out, "inputs": inputs, "ranks": ranks, "jax_ep": jax_ep,
            "oracles": oracles}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_steps(arch, params, batch, n):
    """JAX's single-device step, ``n`` times: (losses, step-0 gradients,
    final state, lr scales)."""
    cfg = jget_reduced(arch)
    tcfg = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=harness.LR),
                             **harness.tcfg_kw())
    gm = jax.jit(lambda p, b: jstep._grads_and_metrics(p, b, cfg, tcfg))
    up = jax.jit(lambda s, g, m: jstep._apply_update(s, g, m, cfg, tcfg))
    state = jstep.init_state(_jtree(params), tcfg)
    losses, scales, grads0 = [], [], None
    for i in range(n):
        g, m = gm(state.params, _jbatch(batch))
        grads0 = g if i == 0 else grads0
        state, m2 = up(state, g, m)
        losses.append(float(m["loss"]))
        scales.append(float(m2["lr_scale"]))
    return losses, grads0, state, scales


def _port_steps(arch, params, batch, n):
    cfg = get_reduced(arch)
    tcfg = tsl.TrainConfig(opt=adamw.AdamWConfig(lr=harness.LR),
                           **harness.tcfg_kw())
    step = tsl.make_train_step(cfg, tcfg)
    state = tsl.init_state(from_jax_params(params, cfg, device="cpu"), tcfg)
    tb = harness._torch_batch(batch)
    grads0, _ = tsl._grads_and_metrics(state.params, tb, cfg, tcfg)
    losses = []
    for _ in range(n):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    return losses, grads0, state


def _grads_close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        err = float(np.abs(a - b).max())
        assert err <= GRAD_TOL * max(1.0, float(np.abs(b).max())), (
            what, i, err)


def _params_close(got, want, bound, what):
    for i, (a, b) in enumerate(zip(got, want)):
        d = np.abs(a - b)
        assert float(d.max()) <= bound, (what, i, float(d.max()), bound)
        stray = float((d > PARAM_TOL).mean())
        assert stray <= STRAY, (what, i, stray)


def _oracles(inputs):
    """Every one-device result the tests hold the world against."""
    out = {}
    for arch in harness.FSDP_ARCHS:
        params = inputs["params"][arch]
        batch = inputs["batch"][arch]
        out["jax", arch] = _jax_steps(arch, params, batch, harness.STEPS)
        out["port", arch] = _port_steps(arch, params, batch, harness.STEPS)
    out["compress"] = _compress_oracle(inputs["params"]["deepseek-7b"],
                                       inputs["batch"]["compress"],
                                       harness.COMP_STEPS)
    out["moe"] = _moe_oracle(inputs["moe"])
    out["decode"] = _decode_oracle(inputs["decode"])
    return out


@pytest.mark.parametrize("arch", harness.FSDP_ARCHS)
def test_sharded_step_matches_one_device(world, arch):
    """The (2,2,2) step's losses, step-0 gradients and parameters after
    3 steps against JAX's single-device step and the port's."""
    got = world["ranks"][0]["fsdp", arch]
    j_losses, j_grads, j_state, scales = world["oracles"]["jax", arch]
    p_losses, p_grads, p_state = world["oracles"]["port", arch]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["losses"], p_losses, rtol=0,
                               atol=LOSS_TOL)
    # every rank reports the same (global) losses
    assert all(r["fsdp", arch]["losses"] == got["losses"]
               for r in world["ranks"])
    mine = [np.asarray(x) for x in tree_lib.leaves(got["grads0"])]
    _grads_close(mine, [np.asarray(x) for x in
                        jax.tree_util.tree_leaves(j_grads)], (arch, "jax"))
    _grads_close(mine, [x.numpy() for x in tree_lib.leaves(p_grads)],
                 (arch, "port"))
    bound = 2 * harness.LR * sum(scales) + PARAM_TOL
    final = [np.asarray(x) for x in tree_lib.leaves(got["params"])]
    _params_close(final, [np.asarray(x) for x in
                          jax.tree_util.tree_leaves(j_state.params)], bound,
                  (arch, "jax"))
    _params_close(final, [x.numpy() for x in
                          tree_lib.leaves(p_state.params)], bound,
                  (arch, "port"))
    # the blocks are local: no rank holds a whole sharded leaf
    full = [x.shape for x in final]
    assert any(tuple(s) != tuple(f) for s, f in
               zip(got["local_shapes"], full))
    # a step gathers each sharded read once forward and once more in the
    # remat, reduce-scatters it once, and launches the same collectives
    # every step
    c = got["counts"]
    assert c[0] == c[1] == c[2]
    assert c[0]["all_gather"] > c[0]["reduce_scatter"] > 0
    assert c[0]["staged"] == 0 and c[0]["all_to_all"] == 0


def _compress_oracle(params, batch, steps):
    """JAX's compressed step composed of one-device functions."""
    cfg = jget_reduced("deepseek-7b")
    tcfg = jstep.TrainConfig(opt=jadamw.AdamWConfig(lr=harness.LR),
                             compress_pods=True, **harness.tcfg_kw())
    gm = jax.jit(lambda p, b: jstep._grads_and_metrics(p, b, cfg, tcfg))
    up = jax.jit(lambda s, g, m: jstep._apply_update(s, g, m, cfg, tcfg))
    pmean = jax.jit(jax.vmap(
        lambda g, r: jcomp.compressed_pmean_tree(g, r, "pod"),
        axis_name="pod"))
    state = jstep.init_state(_jtree(params), tcfg)
    res = jax.tree_util.tree_map(lambda r: jnp.stack([r, r]),
                                 state.residual)
    b = _jbatch(batch)
    half = b["tokens"].shape[0] // 2
    losses = []
    for _ in range(steps):
        outs = [gm(state.params, {k: v[p * half:(p + 1) * half]
                                  for k, v in b.items()}) for p in (0, 1)]
        grads = jax.tree_util.tree_map(lambda *g: jnp.stack(g),
                                       *[o[0] for o in outs])
        mean, res = pmean(grads, res)
        metrics = jax.tree_util.tree_map(lambda *m: (m[0] + m[1]) / 2,
                                         *[o[1] for o in outs])
        state, _ = up(state, jax.tree_util.tree_map(lambda m: m[0], mean),
                      metrics)
        losses.append(float(metrics["loss"]))
    return losses, state, res


def test_compressed_step_matches_composed_oracle(world):
    losses, state, res = world["oracles"]["compress"]
    ranks = world["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["compress"]["losses"], losses, rtol=0,
                                   atol=LOSS_TOL)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.params)]
    bound = 2 * harness.LR * harness.COMP_STEPS + PARAM_TOL
    for pod, rank in ((0, 0), (1, 4)):
        got = ranks[rank]["compress"]
        _params_close([np.asarray(x) for x in tree_lib.leaves(got["params"])],
                      want, bound, ("compress", pod))
        wres = [np.asarray(x)[pod] for x in jax.tree_util.tree_leaves(res)]
        for a, b in zip(tree_lib.leaves(got["residual"]), wres):
            flips = int((np.abs(a - b) > 2e-3 * np.abs(b).max()).sum())
            assert flips <= STRAY * b.size + 2, (pod, flips, b.size)
    # the pods' residuals differ (each pod's own error)
    assert any(not np.array_equal(a, b) for a, b in zip(
        tree_lib.leaves(ranks[0]["compress"]["residual"]),
        tree_lib.leaves(ranks[4]["compress"]["residual"])))


def test_compressed_step_close_to_exact(world):
    """JAX's own limits for the lossy compressor, where JAX applies them:
    the first step's loss within 1e-4 and, after the steps (the second
    one updates), each leaf's max relative difference < 0.1 and the
    residual non-zero."""
    r0 = world["ranks"][0]
    exact, comp = r0["exact"], r0["compress"]
    assert abs(exact["losses"][0] - comp["losses"][0]) < 1e-4
    rel = [float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))
           for a, b in zip(tree_lib.leaves(exact["params"]),
                           tree_lib.leaves(comp["params"]))]
    assert 0 < max(rel) < 0.1, max(rel)
    assert sum(float(np.abs(r).sum()) for r in
               tree_lib.leaves(comp["residual"])) > 0
    assert all(r["int8_sum_exact"] for r in world["ranks"])


def _moe_oracle(m):
    """JAX's and the port's ``_apply_local`` over all the rows, and the
    port's gradients of sum(y w) + aux there."""
    cfg = get_reduced(harness.MOE_ARCH)
    jcfg = jget_reduced(harness.MOE_ARCH)
    jy, jaux = jax.jit(lambda p, x: jmoe._apply_local(p, x, cfg=jcfg))(
        _jtree(m["params"]), jnp.asarray(m["x"]))
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in m["params"].items()}
    x = torch.tensor(m["x"], requires_grad=True)
    y, aux = moe._apply_local(leaves, x, cfg=cfg)
    loss = (y * torch.tensor(m["w"])).sum() + aux
    grads = torch.autograd.grad(loss, list(leaves.values()) + [x])
    return {"jy": np.asarray(jy), "jaux": float(jaux),
            "py": y.detach().numpy(), "paux": float(aux),
            "grads": {k: g.numpy() for k, g in zip(leaves, grads[:-1])},
            "x_grad": grads[-1].numpy()}


def test_expert_parallel_matches_local(world):
    """Each rank's row of the EP output against JAX's and the port's
    ``_apply_local`` (capacity factor 4: nothing drops), 2 all-to-alls a
    forward; the dropping case against JAX's ``_apply_ep``."""
    o = world["oracles"]["moe"]
    drop = world["jax_ep"]
    moved = False
    for rank, r in enumerate(world["ranks"]):
        got = r["moe"]
        np.testing.assert_allclose(got["y"][0], o["jy"][rank], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["y"][0], o["py"][rank], rtol=0,
                                   atol=1e-5)
        assert abs(got["aux"] - o["jaux"]) <= 1e-6
        assert abs(got["aux"] - o["paux"]) <= 1e-6
        assert got["a2a_forward"] == 2
        np.testing.assert_allclose(got["y_drop"][0], drop["y"][rank],
                                   rtol=0, atol=1e-5)
        assert abs(got["aux_drop"] - drop["aux"]) <= 1e-6
        moved |= not np.allclose(got["y_drop"], got["y"], atol=1e-3)
    assert moved, "the capacity factor of the drop case dropped nothing"


def test_expert_parallel_gradients(world):
    """The gradient through both all-to-alls (summed over the ranks, each
    rank's loss its row's) against one device's over all the rows."""
    o = world["oracles"]["moe"]
    for rank, r in enumerate(world["ranks"]):
        got = r["moe"]
        _grads_close([got["grads"][k] for k in o["grads"]],
                     list(o["grads"].values()), ("moe", rank))
        _grads_close([got["x_grad"][0]], [o["x_grad"][rank]],
                     ("moe x", rank))


def _decode_oracle(d):
    """JAX's and the port's unsharded decode logits (B, steps, vocab)."""
    cfg = get_reduced("deepseek-7b")
    jcfg = jget_reduced("deepseek-7b")
    tokens = d["tokens"]
    b, s, n = harness.DEC_B, harness.DEC_PROMPT, harness.DEC_STEPS
    jp = _jtree(d["params"])
    _, cache = jlm.prefill(jp, jnp.asarray(tokens[:, :s]), jcfg,
                           alloc=harness.DEC_ALLOC)
    step = jax.jit(lambda p, c, t, ln: jlm.decode_step(p, c, t, ln, jcfg))
    lengths = jnp.full((b,), s, jnp.int32)
    jl = []
    for t in range(s, s + n):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, t:t + 1]), lengths)
        jl.append(np.asarray(lg))
        lengths = lengths + 1
    params = from_jax_params(d["params"], cfg, device="cpu")
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        _, pc = lm.prefill(params, tt[:, :s], cfg, alloc=harness.DEC_ALLOC)
        plen = torch.full((b,), s, dtype=torch.int32)
        pl = []
        for t in range(s, s + n):
            lg, pc = lm.decode_step(params, pc, tt[:, t:t + 1], plen, cfg)
            pl.append(lg.numpy())
            plen = plen + 1
    return np.stack(jl, 1), np.stack(pl, 1)


def test_seq_sharded_decode(world):
    """6 decode steps with each rank holding 16 of the cache's 32
    positions (batch over ``pod``), against JAX's and the port's
    unsharded decode."""
    jl, pl = world["oracles"]["decode"]
    layers = get_reduced("deepseek-7b").n_layers
    n = harness.DEC_STEPS
    for r in world["ranks"]:
        got = r["decode"]
        assert got["batch_axes"] == ("pod",)
        assert got["cache_rows"] == harness.DEC_ALLOC // 2
        np.testing.assert_allclose(got["logits"][0], jl[got["row"]],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["logits"][0], pl[got["row"]],
                                   rtol=0, atol=1e-5)
        # the partial softmaxes meet in 2 all-reduces a layer and step;
        # the cache is never gathered
        assert got["counts"]["all_reduce"] == 2 * layers * n
        assert got["counts"]["all_gather"] == 0


def test_elastic_restore_and_format(world):
    """A (2,2,2) state saved from its blocks and restored onto (4,2)
    equals it bitwise; JAX's ``ckpt.restore`` reads it bitwise."""
    el = world["ranks"][0]["elastic"]
    assert el["extra"] == {"data_step": 7}
    saved = tree_lib.leaves(el["saved"])
    for a, b in zip(saved, tree_lib.leaves(el["restored"])):
        np.testing.assert_array_equal(a, b)
    local_a = world["ranks"][0]["fsdp", "deepseek-7b"]["local_shapes"]
    assert el["shapes_b"][:len(local_a)] != local_a
    cfg = jget_reduced("deepseek-7b")
    tcfg = jstep.TrainConfig(**harness.tcfg_kw())
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    like = jstep.init_state(params, tcfg)
    restored, extra = jckpt.restore(el["dir"], 7, like)
    assert extra == {"data_step": 7}
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(restored)]
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# The train CLI's mesh: eight ranks it spawns itself (gloo on the CPU)
# ----------------------------------------------------------------------

CLI = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu", "--batch",
       "8", "--seq", "32"]


def _cli(argv):
    """``launch/train.py`` in this process (under a mesh it spawns the
    ranks and prints rank 0's lines): (stdout, its state or None)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train_cli.main(argv)
    return buf.getvalue(), state


def _losses(out):
    return re.findall(r"step (\d+): loss=([\d.]+)", out)


def test_train_cli_mesh(tmp_path):
    """``--mesh host`` prints one device's losses (4 decimals), writes
    one device's checkpoints, and resumes from them at ``data_step``:
    on the mesh and, elastic, on one device."""
    one, _ = _cli(CLI + ["--steps", "4"])
    d = tmp_path / "ck"
    mesh, state = _cli(CLI + ["--steps", "4", "--mesh", "host",
                              "--ckpt-dir", str(d), "--ckpt-every", "2"])
    assert state is None
    assert "mesh {'pod': 2, 'data': 2, 'model': 2} = 8 ranks" in mesh
    assert _losses(mesh) == _losses(one) and len(_losses(one)) == 2
    assert ckpt.all_steps(d) == [2, 4]
    for resume in (["--mesh", "host"], []):
        shutil.rmtree(d / "step_00000004")
        out, _ = _cli(CLI + ["--steps", "4", "--ckpt-dir", str(d)] + resume)
        assert "resumed from step 2" in out, out
        assert _losses(out)[-1] == _losses(one)[-1]
        assert ckpt.all_steps(d) == [2, 4]


def test_train_cli_compress_pods():
    """``--mesh host --compress-pods`` trains: the loss falls."""
    out, _ = _cli(CLI + ["--steps", "6", "--lr", "1e-2", "--mesh", "host",
                         "--compress-pods"])
    losses = [float(v) for _, v in _losses(out)]
    assert len(losses) == 2 and losses[1] < losses[0] - 0.2, out
