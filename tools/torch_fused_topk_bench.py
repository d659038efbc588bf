#!/usr/bin/env python3
"""Replay the first sharded launch of E and F (the fused DC+TS kernels)
on one NVIDIA GPU and time variants of their constants against it.

    python3 chip_smoke.py        # writes build/sharded_launch.pt
    python tools/torch_fused_topk_bench.py --variant kThreadsF32=128 \\
        --variant kInsertMax=4,kThreadsU8=64

The launch is the one ``chip_smoke.py`` captures in the sharded path:
its slots, the rows of the code slots they read, each placed at its own
slot of zero-filled (P, C, M) shard tensors, and the tables rebuilt by
A and B from the step's residuals (bit for bit the step's own).

Each ``--variant NAME=VALUE[,NAME=VALUE...]`` rebuilds
``csrc/pq_scan_topk.cu`` with ``constexpr int NAME = VALUE;`` in place of
each such line, into ``build/kernel_variants/``, checks that its output
equals the source's bit for bit, and times it.  Prints one JSON line:
the card and its power limit, then for E and F the bound
(``chip_smoke.fused_bytes_ops``) and CUDA-event means of the source's
kernel before and after the variants and of each variant.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def load_launch(torch, path: Path) -> dict:
    """{name: (lut, codes, ids, sizes, k, slots)} on the card."""
    from repro_torch.core.adc import QuantizedLUT
    from repro_torch.kernels import ops
    saved = torch.load(path)
    out = {}
    for name, lc in (("pq_scan_topk", ops.lut_build),
                     ("pq_scan_topk_q", ops.lut_build_q)):
        x = {k: v.cuda() if torch.is_tensor(v) else v
             for k, v in saved[name].items()}
        p, c, m = x["P"], x["codes"].shape[1], x["codes"].shape[2]
        codes = torch.zeros((p, c, m), dtype=x["codes"].dtype, device="cuda")
        ids = torch.zeros((p, c), dtype=torch.int32, device="cuda")
        sizes = torch.zeros((p,), dtype=torch.int32, device="cuda")
        codes[x["used"]], ids[x["used"]] = x["codes"], x["ids"]
        sizes[x["used"]] = x["sizes"]
        lut = lc(x["residuals"], x["books"], x["sqn"])
        assert isinstance(lut, QuantizedLUT) == name.endswith("_q")
        out[name] = (lut, codes, ids, sizes, x["k"], x["slots"])
    return out


def variant_library(spec: str):
    """csrc/pq_scan_topk.cu with constexpr ints changed, built into build/
    and loaded with the wrapper's signatures."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "pq_scan_topk.cu").read_text()
    try:
        src = _build.with_constants(src, spec)
    except ValueError as e:
        raise SystemExit(str(e))
    return _build.build_variant("pq_scan_topk", src)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,...]: constexpr ints of pq_scan_topk.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_topk_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import LAUNCH_FILE, bound_ms, event_ms, fused_bytes_ops
    from repro_torch.kernels import _build, ops
    from repro_torch.util import next_pow2
    if not LAUNCH_FILE.exists():
        print(f"torch_fused_topk_bench: no {LAUNCH_FILE}; run chip_smoke.py "
              f"first", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    out = {"card": smi.strip().splitlines()[0]}
    libs = {"source": _build.library("pq_scan_topk")}
    libs.update((v, variant_library(v)) for v in args.variant)
    for name, (lut, codes, ids, sizes, k, slots) in load_launch(
            torch, LAUNCH_FILE).items():
        def call():
            return ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
        nbytes, nops, _ = fused_bytes_ops(codes, sizes,
                                          next_pow2(max(k, 8)),
                                          name.endswith("_q"), slots)
        row = {"bound_ms": bound_ms(nbytes, nops)[0],
               "source_ms": event_ms(call, reps=20)}
        want = call()
        try:
            for v, lib in libs.items():
                if v == "source":
                    continue
                _build._LIBS["pq_scan_topk"] = lib
                got = call()
                row[f"same[{v}]"] = (torch.equal(got[0], want[0])
                                     and torch.equal(got[1], want[1]))
                row[f"ms[{v}]"] = event_ms(call, reps=20)
        finally:
            _build._LIBS["pq_scan_topk"] = libs["source"]
        row["source_ms_again"] = event_ms(call, reps=20)
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
