"""Readings for the limits of a cell's correctness check, on the card:

    python3 perfbench/calibrate.py --workload deepseek_7b.prefill_mix \
        --seeds 11 12 13 --seconds 20 [--control]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` on the port, then the check's numbers of what the port
produced and, with ``--control``, the control's (the plain reference
computed one precision lower, in the port's place, on the same inputs).
One JSON line a seed. The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness, trace
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.resolve(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = harness.prepare(cell, seed, dev)
        window = driver.window(args.seconds, trace.Tracer(False))
        numbers, check_s = harness.judge(cell, driver, seed, dev,
                                         control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "units": len(window.units), "check_s": check_s,
                          "seconds": time.perf_counter() - t0, **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
