"""The paper's own workload on the PyTorch port: the ASIC reproduction
report (Tables III/IV, Fig. 2), the same GEMMs under the H100 row-wise
schedule, and a reduced Swin forward through the row-wise kernels (the
JAX package's ``examples/vit_rowwise.py``).

Run:  PYTHONPATH=src python examples/torch_vit_rowwise.py [--device cpu]

It runs on the card (``--device cuda``, the default; with no card it
raises) or, with ``--device cpu``, the plain PyTorch path.
"""
import argparse
import time

import torch

from repro_torch.configs.swin_t import CONFIG as SWIN_T, reduced
from repro_torch.core import runtime
from repro_torch.core.asic_model import ASIC, run_asic, swin_ops, swin_params
from repro_torch.core.rowwise import schedule_model
from repro_torch.models import vision


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)

    # 1. Faithful reproduction: walk Swin-T through the ASIC cycle model.
    rep = run_asic(swin_ops(SWIN_T))
    print("=== paper reproduction (TSMC 40nm ASIC model) ===")
    print(f"peak throughput : {ASIC.peak_gops:.1f} GOPS "
          f"(paper: 403.2)")
    print(f"swin-t latency  : {rep.time_s * 1e3:.2f} ms (paper: ~22.4)")
    print(f"swin-t images/s : {rep.images_per_s:.1f} (paper: 44.5)")
    print(f"utilization     : {rep.utilization:.4f} (paper: ~0.99)")
    shares = rep.flops_shares()
    p = swin_params(SWIN_T)
    pt = sum(p.values())
    print(f"Fig.2 FLOPs     : fc={shares['fc']:.3f} "
          f"conv={shares['conv']:.3f} attn={shares['attn']:.3f}")
    print(f"Fig.2 params    : fc={p['fc'] / pt:.3f}")

    # 2. The same GEMMs under the H100 row-wise schedule (bf16: the
    # design each shape takes, its tiles' padding).
    sched = schedule_model(swin_ops(SWIN_T))
    designs = sorted({pl.design for pl in sched.plans})
    print("\n=== H100 row-wise schedule (same GEMM walk) ===")
    print(f"utilization     : {sched.utilization:.3f} "
          f"(designs {', '.join(designs)}: the small ViT GEMMs pad "
          "against 128-row wgmma tiles; the ASIC's 4-wide rows fit them "
          "exactly)")

    # 3. Run a reduced Swin end-to-end through the row-wise kernels.
    cfg = reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = vision.init_swin(cfg, gen, device=dev)
    img = torch.randn((8, cfg.img_size, cfg.img_size, 3), generator=gen,
                      device=dev)

    def fwd():
        with torch.no_grad():
            out = vision.swin_forward(params, img, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    logits = fwd()
    t0 = time.perf_counter()
    for _ in range(3):
        fwd()
    dt = (time.perf_counter() - t0) / 3
    print(f"\nswin-smoke fwd on {dev.type}: {tuple(logits.shape)}, "
          f"{8 / dt:.1f} img/s")
    assert bool(torch.isfinite(logits).all())


if __name__ == "__main__":
    main()
