"""Parameters of the JAX package, as the port's tensors.

The caller hands over the JAX parameter pytree as nested dicts and lists
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so the
port never sees JAX; both packages then compute the same function from
the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.swin_t import SwinConfig, ViTConfig
from repro_torch.core import runtime
from repro_torch.core.types import ModelConfig
from repro_torch.models.attention import proj_splits
from repro_torch.models.lm import padded_vocab


def _tensor(leaf, device):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":         # ml_dtypes' bfloat16
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))    # a writable copy
    return t.to(device)


def _convert(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _shape(leaf):
    return tuple((leaf["q"] if isinstance(leaf, dict) else leaf).shape)


def _check_lm(tree, cfg: ModelConfig):
    """Layer count, width, padded vocab and the attention panel's width
    (q, k and v heads) of an LM tree against cfg."""
    d, vp = cfg.d_model, padded_vocab(cfg)
    if _shape(tree["embed"]) != (vp, d):
        raise ValueError(f"embed {_shape(tree['embed'])} does not fit "
                         f"{cfg.name}: want {(vp, d)}")
    if not cfg.tie_embeddings and _shape(tree["lm_head"]) != (d, vp):
        raise ValueError(f"lm_head {_shape(tree['lm_head'])} does not fit "
                         f"{cfg.name}: want {(d, vp)}")
    stages = cfg.stages()
    if len(tree["stages"]) != len(stages):
        raise ValueError(f"tree has {len(tree['stages'])} stages; "
                         f"{cfg.name} has {len(stages)}")
    for si, (stage, sp) in enumerate(zip(stages, tree["stages"])):
        for i, blk in enumerate(stage.body):
            group = sp["shared" if blk.shared else "stacked"]
            g = group[str(i)]["norm1"]["g"]
            want = (d,) if blk.shared else (stage.repeat, d)
            if tuple(g.shape) != want:
                raise ValueError(f"stage {si} block {i}: norm1 "
                                 f"{tuple(g.shape)}; {cfg.name} wants "
                                 f"{want} ({cfg.n_layers} layers, d "
                                 f"{d})")
            if "attn" in group[str(i)]:
                got = _shape(group[str(i)]["attn"]["wqkv"])
                want = want[:-1] + (d, sum(proj_splits(cfg)))
                if got != want:
                    raise ValueError(
                        f"stage {si} block {i}: wqkv {got}; {cfg.name} "
                        f"wants {want} ({cfg.n_heads} q and "
                        f"{cfg.n_kv_heads} kv heads of {cfg.head_dim})")


def _check(tree, cfg):
    if isinstance(cfg, ModelConfig):
        _check_lm(tree, cfg)
        return
    if isinstance(cfg, SwinConfig):
        depths = tuple(len(s["blocks"]) for s in tree["stages"])
        merges = sum("merge" in s for s in tree["stages"])
        if depths != tuple(cfg.depths) or merges != len(cfg.depths) - 1:
            raise ValueError(f"tree has stage depths {depths} and {merges} "
                             f"merges; {cfg.name} wants {cfg.depths}")
    elif isinstance(cfg, ViTConfig):
        if len(tree["blocks"]) != cfg.depth:
            raise ValueError(f"tree has {len(tree['blocks'])} blocks; "
                             f"{cfg.name} wants {cfg.depth}")
    else:
        raise TypeError(f"no model config: {type(cfg).__name__}")
    if tree["patch_w"].shape != (cfg.patch * cfg.patch * cfg.in_chans,
                                 cfg.embed_dim):
        raise ValueError(f"patch_w {tuple(tree['patch_w'].shape)} does "
                         f"not fit {cfg.name}")


def from_jax_params(tree, cfg, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) as a tree of
    tensors on ``device``, each leaf in its own dtype (the fp32 ``u`` and
    ``w0`` of a bf16 RWKV6 tree stay fp32).

    ``cfg`` a ``SwinConfig``/``ViTConfig``: the vision tree; keys the JAX
    initializer leaves out (the last stage's ``merge``) stay out, and
    ``None`` leaves (``norm_g``/``norm_b`` before they are set) stay
    ``None``. ``cfg`` a ``ModelConfig``: the LM tree ``{"embed",
    "stages": [{"stacked", "shared"}], "final_norm", "lm_head"}`` (the
    dense blocks' ``attn`` {``wqkv``, ``wo``}, ``ffn`` {``wgi`` or
    ``wi``, ``wo``}, norms with an optional ``b``; ``lm_head`` absent
    when the embedding is tied), checked for its layer count, d_model,
    padded vocab and ``wqkv`` width."""
    device = runtime.resolve_device(device)
    out = _convert(tree, device)
    _check(out, cfg)
    return out
