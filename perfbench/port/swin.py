"""The port's Swin forward (``repro_torch.models.vision.swin_forward``)
over the harness's weights: the port's parameter tree holds the same
tensors under the port's keys, nothing is derived."""
from __future__ import annotations

import torch

from repro_torch.configs.swin_t import SwinConfig
from repro_torch.models import vision


def port_config(c: dict) -> SwinConfig:
    return SwinConfig(name=c["name"], img_size=c["img_size"],
                      patch=c["patch_size"], in_chans=c["in_chans"],
                      embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                      num_heads=tuple(c["num_heads"]),
                      window=c["window_size"], mlp_ratio=c["mlp_ratio"],
                      num_classes=c["num_classes"], qkv_bias=c["qkv_bias"])


def port_params(w: dict) -> dict:
    stages = []
    for st in w["stages"]:
        stage = {"blocks": [{
            "ln1_g": b["norm1_g"], "ln1_b": b["norm1_b"],
            "qkv": b["qkv_w"], "qkv_b": b["qkv_b"],
            "proj": b["proj_w"], "proj_b": b["proj_b"],
            "ln2_g": b["norm2_g"], "ln2_b": b["norm2_b"],
            "mlp1": b["fc1_w"], "mlp1_b": b["fc1_b"],
            "mlp2": b["fc2_w"], "mlp2_b": b["fc2_b"],
            "rel_bias": b["table"]} for b in st["blocks"]]}
        if "merge_w" in st:
            stage["merge"] = st["merge_w"]
        stages.append(stage)
    return {"patch_w": w["patch_w"], "patch_b": w["patch_b"],
            "stages": stages, "norm_g": w["norm_g"], "norm_b": w["norm_b"],
            "head": w["head_w"], "head_b": w["head_b"]}


class System:
    def __init__(self, cfg: SwinConfig, params: dict, device):
        self.cfg, self.params, self.device = cfg, params, device

    @torch.no_grad()
    def classify(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, classes), fp32, on the card."""
        return vision.swin_forward(self.params, images, self.cfg)

    def release(self) -> None:
        self.params = None


def build(config: dict, weights: dict, device) -> System:
    return System(port_config(config), port_params(weights), device)
