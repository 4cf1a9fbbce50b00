"""End-to-end training driver example on the PyTorch port: trains a
~100M-param llama-style model (or a CPU-sized preset) for a few hundred
steps with checkpointing and exact resume (the JAX package's
``examples/train_lm.py``).

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu  # CPU preset
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m # on the card

Checkpoints go to ``--ckpt-dir`` (by default the checkout's
``build/train_lm``); run it again to resume.
"""
import argparse
from pathlib import Path

from repro_torch.launch import train as train_driver

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu", choices=["cpu", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.preset == "100m":
        # ~100M params: deepseek-family dims scaled down, handed to the
        # driver machinery as a config of its own
        from repro_torch.core.types import ModelConfig
        cfg = ModelConfig(name="llama-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=12,
                          d_ff=2048, vocab=32000, act="silu", norm="rms")
        train_driver.main(["--steps", str(args.steps),
                           "--batch", "8", "--seq", "512",
                           "--ckpt-dir", args.ckpt_dir,
                           "--device", args.device], cfg=cfg)
    else:
        train_driver.main(["--arch", "deepseek-7b", "--smoke",
                           "--steps", str(args.steps),
                           "--batch", "8", "--seq", "128",
                           "--ckpt-dir", args.ckpt_dir,
                           "--device", args.device])


if __name__ == "__main__":
    main()
