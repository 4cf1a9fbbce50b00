"""Run one cell of the port's benchmark once, on the card:

    python3 perfbench/run.py --workload swin_t.batch64 --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. Prints one JSON line as the last line of
standard output (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``) and each number its correctness
check compared, beside its limit, as the last lines of standard error.
Exits non-zero with no result where no card (or too few) is present,
where the port is missing, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        from perfbench import harness
        cell = harness.resolve(args.workload, ROOT)
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device is available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        result = harness.run_cell(
            cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=torch.device("cuda", 0),
            t_start=T_START)
    except Exception:  # noqa: BLE001 - the run's one boundary
        traceback.print_exc()
        return 1
    sys.stdout.flush()
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
