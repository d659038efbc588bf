#!/usr/bin/env python3
"""Replay the first sharded launch of E, F and E-bf16 (the fused DC+TS
kernels) on one NVIDIA GPU and time variants of their source against it.

    python3 chip_smoke.py        # writes build/sharded_launch.pt
    mkdir -p build/old && git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x -C build/old
    python tools/torch_fused_topk_bench.py --variant kThreadsF32=128 \\
        --variant kInsertMax=4,kThreadsU8=64 --probe no-selection \\
        --baseline build/old/src/repro_torch/kernels/csrc \\
        --kernel pq_scan_topk_bf16 --kernel pq_scan_topk_bf16_d1

The sharded launch is the one ``chip_smoke.py`` captures in the sharded
path: its slots, the rows of the code slots they read, each placed at
its own slot of zero-filled (P, C, M) shard tensors, and the tables
rebuilt by A and B from the step's residuals (bit for bit the step's
own).  E-bf16 replays E's launch on E's table cast to bf16, as
``chip_smoke.py``'s bf16 report does.  ``pq_scan_topk_bf16_d1`` is
E-bf16's launch in the dry-run's drim cell (D1: rank 0's shard at the
100M shape, ``launch/dryrun.py::drim_inputs`` from seed 0, the bf16
table from ``_task_lut``), made here on the card.

Each ``--variant NAME=VALUE[,NAME=VALUE...]`` rebuilds
``csrc/pq_scan_topk.cu`` with ``constexpr int NAME = VALUE;`` in place of
each such line; ``--baseline DIR`` builds the ``pq_scan_topk.cu`` and
headers of another copy of ``csrc/`` (an older interface is fine as long
as it has the entry points the launches call); ``--probe NAME`` builds
the source with one cost taken out (``PROBES``), to show what the time
is made of.  Each goes into ``build/kernel_variants/``, is checked for
output equal to the source's bit for bit (not a probe, whose output
differs by design), and is timed.  ``--kernel`` replays only the named
launches (default all four).  Prints one JSON line: the card and its
power limit, registers and spills of each build's instances, then for
each launch its bound (``chip_smoke.fused_bytes_ops``), the kernel
instance the wrapper picks, and CUDA-event means (queued behind a
device-side sleep) of the source's kernel before and after the others
and of each other build.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KERNELS = ("pq_scan_topk", "pq_scan_topk_q", "pq_scan_topk_bf16",
           "pq_scan_topk_bf16_d1")

# Diagnostic builds (--probe): the sources with one cost taken out, as
# {file: (pattern, replacement) edits}.  Their output differs from the
# source's by design; they show what a kernel's time is made of and
# nothing ships them.
PROBES = {
    # bf16 tables: lane l reads entry 2l or 2l + 1 of each subspace (the
    # low bit of its code kept, so the loads still depend on the row),
    # so a warp's 32 lookups fall in 32 distinct banks: no bank conflict.
    # The row's codes, folded into one 24-bit number, are added to its
    # sum, so rows keep distinct random distances and the selection does
    # the work it does on real rows (two more operations a row).
    "conflict-free": {"pq_row.cuh": (
        (r"const int code = (__byte_perm\(w\[m >> 2\], 0, 0x4440 \+ "
         r"\(m & 3\)\));",
         r"int code = \1;\n    if constexpr (kKind == kBF16)\n"
         r"      code = ((int)(threadIdx.x & 31) << 1) | (code & 1);"),
        (r"(  if constexpr \(kKind == kBF16\) acc = round_bf16\(acc\);\n"
         r"  return acc;\n\}\n\n// One code row of any M)",
         r"  if constexpr (kKind == kBF16)\n"
         r"    acc += (float)((v.x ^ v.y ^ v.z ^ v.w) >> 8);\n\1"),)},
    # a running min a lane in place of the top-k selection
    "no-selection": {"pq_scan_topk.cu": (
        (r"const bool keep = key < thr;.*?thr = kth<KPL>\(v, kp\);",
         "v[0] = kmin(v[0], key);"),)},
    # the first task's table only: no table is staged or waited for after
    # a block's first task
    "pre-staged": {"pq_scan_topk.cu": (
        (r"if \(t1 < T\)\s*pqrow::stage_table_async<[^;]*;", ""),)},
}


def probe_sources(name: str) -> dict:
    """{file: edited text} of probe ``name``'s files under csrc/."""
    from repro_torch.kernels import _build
    out = {}
    for fname, edits in PROBES[name].items():
        text = (_build.CSRC / fname).read_text()
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if n == 0:
                raise SystemExit(f"probe {name}: no {pattern!r} in {fname}")
        out[fname] = text
    return out


def probe_library(name: str):
    from repro_torch.kernels import _build
    files = probe_sources(name)
    src = files.pop("pq_scan_topk.cu",
                    (_build.CSRC / "pq_scan_topk.cu").read_text())
    return _build.build_variant("pq_scan_topk", src, label=f"probe {name}",
                                headers=files)


def d1_launch(torch):
    """E-bf16's launch in the D1 drim cell: (lut, codes, ids, sizes, k,
    slots) on the card, as ``_shard_tasks_fn(lut_dtype="bf16")`` makes
    it from ``drim_inputs`` at rank 0's shard of the 100M shape."""
    from repro_torch.configs import drim_ann
    from repro_torch.core import sharded_search as ss
    from repro_torch.launch import dryrun
    shp = dryrun._drim_shape(drim_ann.config(), 256)
    x = dryrun.drim_inputs(shp, torch.device("cuda"), 0)
    si = x["sidx"].clamp(0, x["codes"].shape[0] - 1).long()
    lut = ss._task_lut(x["cluster_of"], x["qidx"], si, x["queries"],
                       x["centroids"], x["codebook"], None, False, "bf16")
    return (lut, x["codes"], x["ids"], x["sizes"], shp["k"],
            ss._task_slots(si, x["qidx"] >= 0))


def load_launch(torch, path: Path, names) -> dict:
    """{name: (lut, codes, ids, sizes, k, slots)} on the card."""
    from repro_torch.core.adc import QuantizedLUT
    from repro_torch.kernels import ops
    saved = torch.load(path)
    out = {}
    if "pq_scan_topk_bf16_d1" in names:
        out["pq_scan_topk_bf16_d1"] = d1_launch(torch)
    for name, key, lc in (("pq_scan_topk", "pq_scan_topk", ops.lut_build),
                          ("pq_scan_topk_q", "pq_scan_topk_q",
                           ops.lut_build_q),
                          ("pq_scan_topk_bf16", "pq_scan_topk",
                           ops.lut_build)):
        if name not in names:
            continue
        x = {k: v.cuda() if torch.is_tensor(v) else v
             for k, v in saved[key].items()}
        p, c, m = x["P"], x["codes"].shape[1], x["codes"].shape[2]
        codes = torch.zeros((p, c, m), dtype=x["codes"].dtype, device="cuda")
        ids = torch.zeros((p, c), dtype=torch.int32, device="cuda")
        sizes = torch.zeros((p,), dtype=torch.int32, device="cuda")
        codes[x["used"]], ids[x["used"]] = x["codes"], x["ids"]
        sizes[x["used"]] = x["sizes"]
        lut = lc(x["residuals"], x["books"], x["sqn"])
        assert isinstance(lut, QuantizedLUT) == name.endswith("_q")
        if name.endswith("_bf16"):
            lut = lut.to(torch.bfloat16)
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
    return _build.build_variant("pq_scan_topk", src, label=spec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,...]: constexpr ints of pq_scan_topk.cu")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another copy of csrc/ (its pq_scan_topk.cu and "
                         "headers)")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES),
                    help="a diagnostic build of the source (not bit-equal)")
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="replay only this launch (default: all four)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_topk_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import (LAUNCH_FILE, bound_ms, event_ms, fused_bytes_ops,
                            ptxas_instances)
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
    for d in args.baseline:
        d = Path(d)
        libs[f"baseline {d}"] = _build.build_variant(
            "pq_scan_topk", (d / "pq_scan_topk.cu").read_text(),
            label=f"baseline {d}", require_all=False,
            headers={h.name: h.read_text() for h in d.glob("*.cuh")})
    libs.update((f"probe {p}", probe_library(p)) for p in args.probe)
    out["ptxas"] = {label: {k: [regs, st + ld] for k, regs, _, st, ld
                            in ptxas_instances(text)}
                    for label, text in _build.build_log.items()}
    for name, (lut, codes, ids, sizes, k, slots) in load_launch(
            torch, LAUNCH_FILE, args.kernel or KERNELS).items():
        def call():
            return ops.pq_scan_topk(lut, codes, ids, sizes, k, slots=slots)
        nbytes, nops, _ = fused_bytes_ops(codes, sizes,
                                          next_pow2(max(k, 8)),
                                          name.endswith("_q"), slots,
                                          bf16="_bf16" in name)
        row = {"bound_ms": bound_ms(nbytes, nops)[0],
               "source_ms": event_ms(call, reps=20, queued=True)}
        want = call()
        try:
            for v, lib in libs.items():
                if v == "source":
                    continue
                _build._LIBS["pq_scan_topk"] = lib
                got = call()
                if not v.startswith("probe "):     # differs by design
                    row[f"same[{v}]"] = (torch.equal(got[0], want[0])
                                         and torch.equal(got[1], want[1]))
                row[f"ms[{v}]"] = event_ms(call, reps=20, queued=True)
        finally:
            _build._LIBS["pq_scan_topk"] = libs["source"]
        row["source_ms_again"] = event_ms(call, reps=20, queued=True)
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
