"""The controls of the check ``quantized_ivfpq``, at a cell's own size.

    python3 annbench/calibrate_u8.py --workload sift100m-u8lut.batch \
        --seeds 11,12,13 --tables f32,u7

For each seed it draws the cell's index and query pool as a run does,
samples ``check_sample`` queries, and puts the uint8 reference with
another table (``reference_u8.py``: ``"f32"`` unquantized, ``"u7"`` 7-bit)
in the program's place: its answers are judged by the uint8 reference
exactly as the program's are.  One JSON line per (seed, table) with
``dist_gap`` and ``id_gap`` in counts; the limits in the configuration's
``"check"`` lie between the program's readings (its runs) and these.
Needs a CUDA device; the benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def control_readings(cell, seed: int, tables, device: str,
                     seconds: float = 10.0) -> list:
    import numpy as np
    import torch

    from annbench.checks.quantized_ivfpq import gaps as judge_gaps
    from annbench.reference_u8 import ReferenceU8

    cfg = cell.config
    drawn = cell.draw.draw(cfg, cell.traffic, seed, device,
                           cell.kind.pool_size(cell.traffic, seconds))
    index, pool = drawn.index, drawn.queries
    rng = np.random.default_rng([seed, 0xC4EC])
    n = min(cell.traffic["check_sample"], len(pool))
    rows = np.sort(rng.choice(len(pool), size=n, replace=False))
    q = pool[torch.as_tensor(rows, device=pool.device)]
    nprobe, k = cfg["service"]["nprobe"], cfg["service"]["k"]
    ref = ReferenceU8(index, nprobe, k)
    out = []
    for table in tables:
        t0 = time.perf_counter()
        r = ReferenceU8(index, nprobe, k, table=table).search(q)
        gaps = judge_gaps(ref, q, r.low.cpu().numpy(), r.ids.cpu().numpy())
        out.append({"workload": cell.name, "seed": seed, "table": table,
                    **gaps, "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--tables", default="f32,u7")
    args = ap.parse_args(argv)
    import torch

    from annbench import harness
    if not torch.cuda.is_available():
        print("calibrate_u8: needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in control_readings(cell, seed, args.tables.split(","),
                                     "cuda"):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
