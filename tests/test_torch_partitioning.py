"""The training mesh's logical partitioning against the JAX package's,
without processes:

* every arch's logical spec tree (``lm.logical_specs``, from the config
  alone) equals the tree JAX's ``init_lm`` returns beside its
  parameters, at the reduced and at the full sizes (JAX's shapes from
  ``jax.eval_shape``), and ``lm.param_shapes`` gives JAX's shapes;
* ``resolve`` and ``tree_shardings`` equal JAX's ``resolve`` leaf by
  leaf on stand-in meshes (2,2,2), (4,2), (1,8) and (8,1,1): parameter
  trees, activation specs and dense-cache specs, ``pod`` manual too;
* ``adamw.state_specs`` and ``state_logical_specs`` have JAX's
  structure;
* ``shard_leaf`` cuts JAX's blocks;
* ``compressed_pmean`` and ``compressed_pmean_tree`` in one process,
  two threads joined by a fake two-pod group: the int8 payloads, their
  int32 sum, the scale and the mean equal JAX's under
  ``vmap(axis_name="pod")`` (the mean and the residual to 1e-7 of the
  leaf's scale: JAX divides the summed scales in another order).
"""
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.configs import get_config as jget_config
from repro.core import partitioning as jpart
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import partitioning as part
from repro_torch.core import tree as tree_lib
from repro_torch.models import lm
from repro_torch.optim import adamw, compression
from repro_torch.train import step as tsl

ARCHS = sorted(REDUCED)
MESHES = [((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model")),
          ((1, 8), ("data", "model")), ((8, 1, 1), ("pod", "data", "model"))]


def _jax_specs(cfg, full):
    """JAX's (shapes, logical specs) of ``init_lm``; at full size traced
    by ``eval_shape`` (the specs are Python values made while tracing)."""
    box = {}

    def init(key):
        params, specs = jlm.init_lm(key, cfg, dtype=jnp.float32)
        box["specs"] = specs
        return params
    if full:
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    else:
        shapes = init(jax.random.PRNGKey(0))
    return shapes, box["specs"]


def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=jpart._is_spec_leaf)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_jax(arch, full):
    jcfg = jget_config(arch) if full else REDUCED[arch]()
    cfg = get_config(arch) if full else get_reduced(arch)
    shapes, jspecs = _jax_specs(jcfg, full)
    specs = lm.logical_specs(cfg)
    assert jax.tree_util.tree_structure(
        specs, is_leaf=jpart._is_spec_leaf) == jax.tree_util.tree_structure(
        jspecs, is_leaf=jpart._is_spec_leaf)
    assert _spec_leaves(specs) == _spec_leaves(jspecs)
    mine = lm.param_shapes(cfg)
    assert [tuple(t.shape) for t in tree_lib.leaves(mine)] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    assert all(t.device.type == "meta" for t in tree_lib.leaves(mine))


def _stand_in(shape, names):
    """JAX's ``resolve`` reads only the axis names and the device grid."""
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])) if isinstance(m, tuple) else None)
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_matches_jax(arch, mesh):
    """Every parameter leaf of the full config, and the activation and
    cache specs, resolved on both packages' stand-in meshes."""
    shape, names = mesh
    jmesh, pmesh = _stand_in(shape, names), part.MeshShape(shape, names)
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes, jspecs = _jax_specs(jcfg, True)
    like = lm.param_shapes(cfg)
    got = [s.spec for s in tree_lib.leaves(
        part.tree_shardings(pmesh, lm.logical_specs(cfg), like=like))]
    want = [tuple(jpart.resolve(tuple(n), jmesh, shape=s.shape))
            for n, s in zip(_spec_leaves(jspecs),
                            jax.tree_util.tree_leaves(shapes))]
    assert got == want
    acts = [(("batch", "seq", "act_embed"), (4, 32, cfg.d_model)),
            (("batch", "seq", "act_embed"), (16, 2048, cfg.d_model)),
            (("batch", "seq", "vocab_act"), (8, 128, lm.padded_vocab(cfg))),
            (("batch",), (2,)), (("batch", None, "kv_heads"), (2, 1, 64))]
    for spec_names, s in acts:
        assert part.resolve(spec_names, pmesh, shape=s) == tuple(
            jpart.resolve(spec_names, jmesh, shape=s)), (spec_names, s)
    red, jred = get_reduced(arch), REDUCED[arch]()
    cache = lm.init_cache(red, 4, 32, dtype=torch.float32, device="meta")
    jcache = jlm.init_cache(jred, 4, 32, jnp.float32)
    for rules in (None, {"kv_seq": "model"}):
        with part.use_mesh(pmesh, rules), jpart.use_mesh(None, rules):
            got = [s.spec for s in tree_lib.leaves(part.tree_shardings(
                pmesh, lm.cache_logical_specs(cache), like=cache))]
            jspec = jlm.cache_logical_specs(jcache)
            want = [tuple(jpart.resolve(tuple(n), jmesh, shape=c.shape))
                    for n, c in zip(_spec_leaves(jspec),
                                    jax.tree_util.tree_leaves(jcache))]
        assert got == want, rules


def test_pod_manual_is_excluded():
    """Under cross-pod compression ``pod`` is manual: no spec takes it."""
    pmesh = part.MeshShape((2, 2, 2), ("pod", "data", "model"))
    with part.use_mesh(pmesh), part.manual_axes(("pod",)):
        assert part.resolve(("batch", "seq"), shape=(8, 16)) == (
            ("data", "model"), None)
        assert part.auto_axes() == ("data", "model")
    assert part.resolve(("batch", "seq"), pmesh, shape=(8, 16)) == (
        ("pod", "data", "model"), None)


def test_state_specs_structure():
    specs = lm.logical_specs(get_reduced("deepseek-7b"))
    st = adamw.state_specs(specs)
    jst = jadamw.state_specs(specs)
    assert type(st).__name__ == type(jst).__name__ == "AdamWState"
    assert st.step == () and st.mu is specs and st.nu is specs
    for comp in (False, True):
        tcfg = tsl.TrainConfig(compress_pods=comp)
        got = tsl.state_logical_specs(specs, tcfg)
        want = jstep.state_logical_specs(
            specs, jstep.TrainConfig(compress_pods=comp))
        assert got._fields == want._fields
        assert _spec_leaves(got) == _spec_leaves(want)
        assert (got.residual is specs) == comp and (got.residual == {}) != comp


def test_shard_leaf_cuts_jax_blocks():
    """A (2,2,2) rank's block of an (8, 6) leaf split ``(('pod','data'),
    'model')``: JAX's layout, the first axis major."""
    mesh = part.MeshShape((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(48.0).reshape(8, 6)
    for rank in range(8):
        mesh.coords = dict(zip(mesh.axis_names, part._coords(rank, (2, 2,
                                                                    2))))
        got = part.shard_leaf(x, part.Sharding(mesh, (("pod", "data"),
                                                      "model")))
        p, d, m = part._coords(rank, (2, 2, 2))
        row = p * 2 + d
        assert torch.equal(got, x[2 * row:2 * row + 2, 3 * m:3 * m + 3])


class _FakePods:
    """Two threads as the two pods of a group: ``all_reduce`` meets them
    at a barrier."""

    def __init__(self):
        self.slots = [None, None]
        self.barrier = threading.Barrier(2)
        self.local = threading.local()

    def all_reduce(self, t, op=None, group=None):
        rank = self.local.rank
        self.slots[rank] = t.clone()
        self.barrier.wait()
        both = torch.stack(self.slots)
        out = both.amax(0) if op == torch.distributed.ReduceOp.MAX \
            else both.sum(0)
        self.barrier.wait()
        t.copy_(out)


def _two_pods(monkeypatch, fn, inputs):
    fake = _FakePods()
    monkeypatch.setattr(part.dist, "all_reduce", fake.all_reduce)
    monkeypatch.setattr(compression.dist, "get_world_size", lambda g: 2)
    outs = [None, None]

    def run(rank):
        fake.local.rank = rank
        outs[rank] = fn(inputs[rank])
    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return outs


def test_compressed_pmean_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 48, 16)).astype(np.float32)
    g[1] *= 3.0
    jmean, jdeq = jax.vmap(lambda x: jcomp.compressed_pmean(x, "pod"),
                           axis_name="pod")(jnp.asarray(g))
    jq = [np.asarray(jcomp._quantize(jnp.asarray(g[p]))[0]) for p in (0, 1)]
    got = _two_pods(monkeypatch, lambda x: compression.compressed_pmean(
        x, "pods"), [torch.from_numpy(g[p]) for p in (0, 1)])
    sums = _two_pods(monkeypatch, lambda x: compression.int8_sum(
        compression._quantize(x)[0], "pods"),
        [torch.from_numpy(g[p]) for p in (0, 1)])
    want_sum = jq[0].astype(np.int32) + jq[1].astype(np.int32)
    for p in (0, 1):
        q, scale = compression._quantize(torch.from_numpy(g[p]))
        jqp, jscale = jcomp._quantize(jnp.asarray(g[p]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqp))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(sums[p].numpy(), want_sum)
        mean, deq = got[p]
        step = float(np.abs(g).max()) / 127
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean[p]),
                                   rtol=0, atol=1e-7 * step)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq[p]))


def test_compressed_pmean_tree_matches_jax(monkeypatch):
    rng = np.random.default_rng(1)
    tree = [{"a": rng.standard_normal((2, 8, 4)).astype(np.float32),
             "b": rng.standard_normal((2, 5)).astype(np.float32)}
            for _ in range(2)]
    grads = {k: np.stack([tree[0][k][p] for p in (0, 1)]) for k in "ab"}
    res = {k: 0.01 * np.stack([tree[1][k][p] for p in (0, 1)])
           for k in "ab"}
    jmean, jres = jax.vmap(
        lambda g, r: jcomp.compressed_pmean_tree(g, r, "pod"),
        axis_name="pod")(jax.tree_util.tree_map(jnp.asarray, grads),
                         jax.tree_util.tree_map(jnp.asarray, res))
    got = _two_pods(
        monkeypatch,
        lambda gr: compression.compressed_pmean_tree(gr[0], gr[1], "pods"),
        [({k: torch.from_numpy(grads[k][p]) for k in "ab"},
          {k: torch.from_numpy(res[k][p]) for k in "ab"}) for p in (0, 1)])
    for p in (0, 1):
        mean, new_res = got[p]
        for k in "ab":
            step = float(np.abs(grads[k] + res[k]).max()) / 127
            np.testing.assert_allclose(mean[k].numpy(),
                                       np.asarray(jmean[k][p]), rtol=0,
                                       atol=1e-7 * step)
            np.testing.assert_allclose(new_res[k].numpy(),
                                       np.asarray(jres[k][p]), rtol=0,
                                       atol=1e-7 * step)
    zeros = compression.init_residual({"w": torch.ones(3, 2)})
    assert zeros["w"].dtype == torch.float32 and not zeros["w"].any()
