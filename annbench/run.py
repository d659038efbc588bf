"""Run one cell of the benchmark once and print its result line.

    python3 annbench/run.py --workload sift100m.batch --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout: the program under test is
``src/repro_torch``; its kernels build into ``build/`` there on the first
run.  Exits 1, printing no result, without a CUDA device (or with fewer
than the cell asks for), when the run cannot be judged, or when the
process has loaded JAX or the JAX package.  The last line of standard
output is the result; the numbers compared, each beside its limit, are
also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from annbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"annbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START,
                      log=lambda s: print(s, file=sys.stderr))
    bad = harness.forbidden_modules()
    if bad:
        print(f"annbench: the process loaded {bad}; no result",
              file=sys.stderr)
        return 1
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
