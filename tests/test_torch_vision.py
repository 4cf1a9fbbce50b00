"""The port's Swin/ViT forwards against the JAX package's, on CPU.

Weights come from the JAX initializers through ``from_jax_params``
(with their vector leaves jittered, so biases and norm gains are not
the initializer's constants), images from a numpy seed; both sides run
their plain paths (JAX ``ref``; the port's wrappers on CPU tensors) in
fp32 at rtol = atol = 2e-4, the JAX package's own fused-vs-unfused
tolerance; one bf16 check holds the unfused window attention's dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import swin_t as jcfg
from repro.core import runtime as jruntime
from repro.models import vision as jvision
from repro_torch.configs import swin_t as tcfg
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime, trace
from repro_torch.models import vision

TOL = dict(rtol=2e-4, atol=2e-4)
# depths (2, 2), not reduced()'s (1, 1): stage 1 then has a shifted
# block, so the shift mask is exercised
SWIN = dict(img_size=56, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window=7, num_classes=10)
VIT = dict(img_size=32, patch=8, embed_dim=64, depth=2, num_heads=4,
           num_classes=10)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jittered(params, seed):
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if a.ndim != 2 or path[-1].key == "rel_bias":   # all but weights
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jit, params)


@pytest.fixture(scope="module")
def swin():
    cfg = jcfg.SwinConfig(**SWIN)
    params = _jittered(jvision.init_swin(jax.random.PRNGKey(0), cfg), 1)
    images = np.random.default_rng(2).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    return cfg, tcfg.SwinConfig(**SWIN), params, images


@pytest.fixture(scope="module")
def vit():
    cfg = jcfg.ViTConfig(**VIT)
    params = _jittered(jvision.init_vit(jax.random.PRNGKey(0), cfg), 3)
    images = np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    return cfg, tcfg.ViTConfig(**VIT), params, images


def _jax_logits(forward, params, images, cfg, fuse):
    """The JAX ``ref`` forward, jitted through a fresh closure so the
    fusion switch (read while tracing) is not served from a cache
    traced under the other setting."""
    with jruntime.use_impl("ref"), jruntime.use_pipeline_fusion(fuse):
        fn = jax.jit(lambda p, x: forward(p, x, cfg))
        return np.asarray(fn(params, jnp.asarray(images)))


def _counts():
    return (trace.launches("rowwise_matmul"),
            trace.launches("flash_attention"), trace.launches("layernorm"))


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_swin_forward_matches_jax(swin, fuse, impl, trace_on):
    jc, tc, params, images = swin
    want = _jax_logits(jvision.swin_forward, params, images, jc, fuse)
    tp = from_jax_params(params, tc, device="cpu")
    before = _counts()
    with runtime.use_impl(impl), runtime.use_pipeline_fusion(fuse):
        got = vision.swin_forward(tp, torch.from_numpy(images), tc)
    assert _counts() == before          # CPU tensors launch no kernel
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_vit_forward_matches_jax(vit, fuse):
    jc, tc, params, images = vit
    want = _jax_logits(jvision.vit_forward, params, images, jc, fuse)
    tp = from_jax_params(params, tc, device="cpu")
    with runtime.use_pipeline_fusion(fuse):
        got = vision.vit_forward(tp, torch.from_numpy(images), tc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_modules_match_functional_forward(swin, vit):
    for (jc, tc, params, images), fwd, cls in (
            (swin, vision.swin_forward, vision.SwinTransformer),
            (vit, vision.vit_forward, vision.VisionTransformer)):
        tp = from_jax_params(params, tc, device="cpu")
        model = cls(tc, tp, device="cpu")
        assert all(not p.requires_grad for p in model.parameters())
        x = torch.from_numpy(images)
        with torch.no_grad():
            torch.testing.assert_close(model(x), fwd(tp, x, tc),
                                       rtol=0, atol=0)


def test_helpers_match_jax():
    w = 7
    np.testing.assert_array_equal(
        vision._rel_pos_index(w, torch.device("cpu")).numpy(),
        np.asarray(jvision._rel_pos_index(w)))
    np.testing.assert_array_equal(
        vision._shift_mask(14, 21, w, 3, torch.device("cpu")).numpy(),
        np.asarray(jvision._shift_mask(14, 21, w, 3)))
    x = np.random.default_rng(0).standard_normal((2, 14, 21, 5)).astype(
        np.float32)
    xw = vision._window_partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(
        xw.numpy(), np.asarray(jvision._window_partition(jnp.asarray(x), w)))
    np.testing.assert_array_equal(
        vision._window_reverse(xw, w, 14, 21).numpy(), x)


def test_wmsa_bf16_shifted_matches_jax(swin):
    """The unfused window attention of a shifted block in bf16: JAX's
    shift mask is weakly typed, so it joins the bf16 scores without
    promoting them and the block's output stays bf16; the port keeps
    the same dtypes. Both sides round at bf16 steps of their own (bf16
    keeps 8 significant bits: one step is at most 2^-7 relative), hence
    a tolerance of four steps."""
    _jc, tc, params, _images = swin
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    jblk = jax.tree_util.tree_map(jnp.asarray, tree["stages"][0]["blocks"][1])
    tblk = from_jax_params(tree, tc, device="cpu")["stages"][0]["blocks"][1]
    x = np.random.default_rng(5).standard_normal((2, 14, 14, 32))
    w, shift, heads = 7, 3, 2
    with jruntime.use_impl("ref"):
        want = jvision._wmsa(jblk, jnp.asarray(x, jnp.bfloat16), heads, w,
                             shift, jvision._rel_pos_index(w),
                             jvision._shift_mask(14, 14, w, shift))
    cpu = torch.device("cpu")
    got = vision._wmsa(tblk, torch.from_numpy(x).to(torch.bfloat16), heads,
                       w, shift, vision._rel_pos_index(w, cpu),
                       vision._shift_mask(14, 14, w, shift, cpu))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -5, atol=2 ** -5)


@pytest.mark.parametrize("init", ["swin", "vit"])
def test_init_tree_matches_jax(init):
    """init_swin / init_vit build the JAX package's tree: the same keys,
    shapes and dtypes, with every stage's merge but the last."""
    if init == "swin":
        jtree = jvision.init_swin(jax.random.PRNGKey(0),
                                  jcfg.SwinConfig(**SWIN), jnp.bfloat16)
        ttree = vision.init_swin(tcfg.SwinConfig(**SWIN),
                                 torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.bfloat16)
    else:
        jtree = jvision.init_vit(jax.random.PRNGKey(0),
                                 jcfg.ViTConfig(**VIT), jnp.bfloat16)
        ttree = vision.init_vit(tcfg.ViTConfig(**VIT),
                                torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.bfloat16)
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16


def test_from_jax_params_keeps_none_and_bf16():
    cfg = jcfg.SwinConfig(**SWIN)
    tree = jax.tree_util.tree_map(
        np.asarray, jvision.init_swin(jax.random.PRNGKey(0), cfg,
                                      jnp.bfloat16))
    tree["norm_g"] = tree["norm_b"] = None
    out = from_jax_params(tree, tcfg.SwinConfig(**SWIN), device="cpu")
    assert out["norm_g"] is None and out["norm_b"] is None
    assert "merge" in out["stages"][0] and "merge" not in out["stages"][-1]
    assert out["patch_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["patch_w"].float().numpy(),
        np.asarray(tree["patch_w"]).astype(np.float32))
    with pytest.raises(ValueError, match="depths"):
        from_jax_params(tree, tcfg.SwinConfig(**{**SWIN, "depths": (2, 4)}),
                        device="cpu")
