#!/usr/bin/env python3
r"""Kernels C, D and C-bf16 (``csrc/pq_scan.cu``) at the benchmark's chunk
on one NVIDIA GPU: their output against another build bit for bit, and
their time against variants of the source.

    mkdir -p build/old && git archive <commit> src/repro_torch/kernels/csrc \
        | tar -x -C build/old
    python tools/torch_dc_layout_bench.py \
        --baseline build/old/src/repro_torch/kernels/csrc \
        --probe padding-last --variant kThreads=128

The chunk is ``chip_smoke.dc_inputs_at_cell``'s: 256 queries x 96 probes
over 65,536 code slots of C = 6,200 rows, the cells' log-normal sizes.
``--baseline DIR`` builds the ``pq_scan.cu`` and headers of another copy
of ``csrc/``; ``--variant NAME=VALUE[,...]`` rebuilds the source with
``constexpr int NAME = VALUE;``; ``--probe NAME`` builds it with one
edit of ``PROBES`` (a layout to time against the source's, with the
same output).  Each build's output must equal the source's bit for bit
(C, D and C-bf16; by slot, dense on ``gather_slots``' copy with sizes
and without): at the chunk with uint8 codes and with int32 codes, and
on every case of ``tests/test_torch_dc_layout.py`` (both code types,
all three tables).  Then each table's slot-form launch at the chunk is
timed (CUDA-event means of 20 warm launches, queued behind a
device-side sleep) in every build, the source's before and after the
others, beside the bound of ``annbench/roofline.py`` (f32),
``roofline_u8.py`` (u8) or their bf16 count.  Prints one JSON line: the
card and its power limit, registers and spills of each build's
instances, the compares and the times.  Exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# Layouts to time against the source's (--probe): {name: ((pattern,
# replacement), ...)} edits of csrc/pq_scan.cu.  Their output is the
# source's.
PROBES = {
    # the padding written after the scan, not while the table's copy lands
    "padding-last": (
        (r"  write_padding\(o, rows, C\);\n  if \(rows == 0\) return;\n",
         "  if (rows == 0) {\n    write_padding(o, rows, C);\n    return;\n"
         "  }\n"),
        (r"(score_rows<[^;]*;\n)", r"\1  write_padding(o, rows, C);\n")),
}


def probe_source(name: str) -> str:
    from repro_torch.kernels import _build
    text = (_build.CSRC / "pq_scan.cu").read_text()
    for pattern, repl in PROBES[name]:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise SystemExit(f"probe {name}: no {pattern!r} in pq_scan.cu")
    return text


def builds(args) -> dict:
    """{label: library} of the source and every other build asked for."""
    from repro_torch.kernels import _build
    libs = {"source": _build.library("pq_scan")}
    src = (_build.CSRC / "pq_scan.cu").read_text()
    for spec in args.variant:
        try:
            text = _build.with_constants(src, spec)
        except ValueError as e:
            raise SystemExit(str(e))
        libs[spec] = _build.build_variant("pq_scan", text, label=spec)
    for name in args.probe:
        libs[f"probe {name}"] = _build.build_variant(
            "pq_scan", probe_source(name), label=f"probe {name}")
    for d in map(Path, args.baseline):
        libs[f"baseline {d}"] = _build.build_variant(
            "pq_scan", (d / "pq_scan.cu").read_text(),
            label=f"baseline {d}",
            headers={h.name: h.read_text() for h in d.glob("*.cuh")})
    return libs


def test_cases():
    spec = importlib.util.spec_from_file_location(
        "test_torch_dc_layout", ROOT / "tests" / "test_torch_dc_layout.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forms(ops, table, codes, sizes, slots):
    """C / D / C-bf16 by slot, dense on the gathered copy, and dense on
    it without sizes."""
    gcodes, _, gsizes = ops.gather_slots(codes, None, sizes, slots)
    return (ops.pq_scan_dc(table, codes, sizes, slots=slots),
            ops.pq_scan_dc(table, gcodes, gsizes),
            ops.pq_scan_dc(table, gcodes, None))


def compare(torch, ops, libs, label, table, codes, sizes, slots, out):
    """out[label][build] = every form equal to the source's bit for bit."""
    from repro_torch.kernels import _build
    want = forms(ops, table, codes, sizes, slots)
    row = out.setdefault(label, {})
    try:
        for v, lib in libs.items():
            if v == "source":
                continue
            _build._LIBS["pq_scan"] = lib
            got = forms(ops, table, codes, sizes, slots)
            row[v] = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
    finally:
        _build._LIBS["pq_scan"] = libs["source"]
    del want
    torch.cuda.empty_cache()


def tables(torch, lut, q):
    return {"f32": lut, "u8": q, "bf16": lut.to(torch.bfloat16)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another copy of csrc/ (its pq_scan.cu and headers)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,...]: constexpr ints of pq_scan.cu")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES), help="another layout to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_dc_layout_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from annbench import roofline, roofline_u8
    from chip_smoke import (CB, M, bound_ms, dc_inputs_at_cell, event_ms,
                            ptxas_instances)
    from repro_torch.kernels import _build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    out = {"card": smi.strip().splitlines()[0]}
    libs = builds(args)
    out["ptxas"] = {label: {k: [regs, st + ld] for k, regs, _, st, ld
                            in ptxas_instances(text)}
                    for label, text in _build.build_log.items()}
    same = {}
    cases = test_cases()
    for case in cases.CASES:
        for code_dtype in (torch.uint8, torch.int32):
            for kind in ("f32", "u8", "bf16"):
                lut, codes, sizes, slots = cases.layout_inputs(
                    case, code_dtype, kind, "cuda")
                compare(torch, ops, libs, f"{case} {kind} "
                        f"{str(code_dtype)[6:]}", lut, codes, sizes, slots,
                        same)
    cell = {}
    for code_dtype in (torch.int32, torch.uint8):   # u8 last: timed below
        lut, q, codes, sizes, slots = dc_inputs_at_cell(ops, args.seed,
                                                        code_dtype)
        for kind, table in tables(torch, lut, q).items():
            compare(torch, ops, libs, f"cell {kind} {str(code_dtype)[6:]}",
                    table, codes, sizes, slots, same)
        if code_dtype == torch.int32:
            del lut, q, codes
            torch.cuda.empty_cache()
    out["same"] = same
    t = slots.shape[0]
    real = int(ops.gather_slots(codes, None, sizes, slots)[2].sum())
    counts = {"f32": roofline.dc_bytes_ops(t, M, CB, real),
              "u8": roofline_u8.dc_u8_bytes_ops(t, M, CB, real),
              "bf16": (t * M * CB * 2 + real * M + t * 4 + real * 4,
                       real * M)}
    cell["shape"] = {"T": t, "P": codes.shape[0], "C": codes.shape[1],
                     "real_rows": real}
    for kind, table in tables(torch, lut, q).items():
        def call():
            return ops.pq_scan_dc(table, codes, sizes, slots=slots)
        row = {"bound_ms": bound_ms(*counts[kind])[0],
               "source_ms": event_ms(call, reps=20, queued=True)}
        try:
            for v, lib in libs.items():
                if v != "source":
                    _build._LIBS["pq_scan"] = lib
                    row[f"ms[{v}]"] = event_ms(call, reps=20, queued=True)
        finally:
            _build._LIBS["pq_scan"] = libs["source"]
        row["source_ms_again"] = event_ms(call, reps=20, queued=True)
        cell[kind] = row
    out["cell"] = cell
    ok = all(all(r.values()) for r in same.values())
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
