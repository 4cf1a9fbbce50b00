"""Quickstart on the PyTorch port: the row-wise primitive, int8 mode,
and a tiny LM trained three steps (the JAX package's
``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the card (``--device cuda``, the default; with no card it
raises) or, with ``--device cpu``, the plain PyTorch path.
"""
import argparse

import torch

from repro_torch.core import runtime
from repro_torch.core.quant import quantize_per_channel, quantize_per_row
from repro_torch.core.rowwise import plan_matmul
from repro_torch.core.types import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.train import step as tsl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. The paper's dot-product primitive: plan + execute a matmul.
    plan = plan_matmul(3136, 96, 288, dtype="fp32")   # a Swin-T FC layer
    print(f"row-wise plan: design={plan.design} bm={plan.bm} bk={plan.bk} "
          f"bn={plan.bn} grid={plan.grid} util={plan.utilization:.3f} "
          f"smem={plan.smem_bytes / 1e3:.1f}KB")
    x = torch.randn((3136, 96), generator=gen, device=dev)
    w = torch.randn((96, 288), generator=gen, device=dev)
    y = ops.matmul(x, w, activation="gelu")
    print("matmul+gelu:", tuple(y.shape), y.dtype)

    # 2. 8-bit weights/activations (the paper's precision).
    xq, xs = quantize_per_row(x)
    wq, ws = quantize_per_channel(w)
    y8 = ops.matmul_int8(xq, wq, xs, ws)
    exact = ops.matmul(x, w, impl="ref")
    err = (y8 - exact).abs().max() / exact.abs().max()
    print(f"int8 W8A8 relative error: {float(err):.4f}")

    # 3. A tiny LM: three train steps on the synthetic pipeline.
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=64, act="silu", norm="rms")
    params = lm.init_lm(cfg, gen, device=dev, dtype=torch.float32)
    tcfg = tsl.TrainConfig(remat=False, total_steps=100)
    state = tsl.init_state(params, tcfg)
    step = tsl.make_train_step(cfg, tcfg)
    ds = SyntheticLM(DataConfig(vocab=64, seq_len=32, global_batch=4))
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch(i).items()}
        state, m = step(state, batch)
        print(f"step {i}: loss={float(m['loss']):.4f} "
              f"acc={float(m['accuracy']):.3f}")


if __name__ == "__main__":
    main()
