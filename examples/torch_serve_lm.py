"""Serving example on the PyTorch port: paged-KV continuous batching over
a mixed request stream (bucketed prefill, block-table decode, page
reclamation), the JAX package's ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

It runs on the card (``--device cuda``, the default; with no card it
raises) or, with ``--device cpu``, the plain PyTorch path.
"""
import argparse

from repro_torch.launch import serve as serve_driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve_driver.main(["--arch", "deepseek-7b", "--smoke",
                       "--requests", "10", "--slots", "4",
                       "--max-new", "12", "--page-size", "16",
                       "--device", args.device])


if __name__ == "__main__":
    main()
