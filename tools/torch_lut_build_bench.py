#!/usr/bin/env python3
"""Replay the LC kernels A (``lut_build``) and B (``lut_build_q``) on one
NVIDIA GPU and time variants of their source against them.

    python3 chip_smoke.py        # writes build/sharded_launch.pt
    git show <commit>:src/repro_torch/kernels/csrc/lut_build.cu > old.cu
    python tools/torch_lut_build_bench.py --baseline old.cu \\
        --variant kStreamStores=1 --variant kThreads=256

The inputs are those ``chip_smoke.py`` saved: the residuals of the
sharded step's first A and B launches (T = 65,536 at its configuration)
and of the local path's first chunk (T = 8,192), with the codebooks and
their norms.

Each ``--variant NAME=VALUE[,NAME=VALUE...]`` rebuilds
``csrc/lut_build.cu`` with ``constexpr int NAME = VALUE;`` in place of
each such line; ``--baseline FILE.cu`` builds another ``lut_build.cu``
with the same C interface; ``--probe NAME`` builds the source with one
cost taken out (``PROBES``: no stores, no division), to show what the
time is made of.  Each goes into ``build/kernel_variants/``, is checked
for output equal to the source's bit for bit (u8 table, scale and bias
for B; not a probe, whose output differs by design), and is timed.
Prints one JSON line: the card and its power limit, the registers and
spill bytes of each build's LC instances (nvcc ``-Xptxas -v``), then for
each launch its shape, bound (``chip_smoke.lut_bytes_ops``), the time of
``zero_`` on a tensor of its output's bytes (the write rate the card
reaches, as a yardstick), and CUDA-event means of the source's kernel
before and after the others and of each other build.
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

# Diagnostic builds (--probe): the source with one cost taken out, as
# (pattern, replacement) edits.  Their output differs from the source's by
# design; they show what a kernel's time is made of and nothing ships them.
PROBES = {
    # every entry computed, (almost) nothing stored: a store only of a
    # value that never occurs
    "no-stores": (
        (r"if \(ok\[k\]\) store4\(([^;]*), (v\[k\])\);",
         r"if (ok[k] && \2.x == -1.0f) store4(\1, \2);"),
        (r"(\*reinterpret_cast<uint32_t\*>\([^;]*\)) =\s*(pack\([^;]*\));",
         r"{ const uint32_t p_ = \2; if (p_ == 0x12345678u) \1 = p_; }")),
    # B: v - lo taken as the quotient, no division
    "no-division": ((r"__float2uint_rn\(\(v - lo\) / scale\)",
                     "__float2uint_rn(v - lo)"),),
}


def probe_source(source: str, name: str) -> str:
    for pattern, repl in PROBES[name]:
        source, n = re.subn(pattern, repl, source)
        if n == 0:
            raise SystemExit(f"probe {name}: no {pattern!r} in the source")
    return source


def load_inputs(torch, path: Path) -> dict:
    """{launch label: (kernel name, residuals, codebooks, norms)} on the
    card."""
    saved = torch.load(path)
    out = {}
    for label, key, name in (("A sharded step", "pq_scan_topk", "lut_build"),
                             ("B sharded step", "pq_scan_topk_q",
                              "lut_build_q"),
                             ("A local chunk", "lut_local", "lut_build"),
                             ("B local chunk", "lut_local", "lut_build_q")):
        x = saved[key]
        out[label] = (name, x["residuals"].cuda(), x["books"].cuda(),
                      x["sqn"].cuda())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,...]: constexpr ints of lut_build.cu")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another lut_build.cu with the same C interface")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES),
                    help="a diagnostic build of the source (not bit-equal)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_lut_build_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import (LAUNCH_FILE, bound_ms, event_ms,
                            lut_bytes_ops, ptxas_instances)
    from repro_torch.kernels import _build, ops
    if not LAUNCH_FILE.exists():
        print(f"torch_lut_build_bench: no {LAUNCH_FILE}; run chip_smoke.py "
              f"first", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    out = {"card": smi.strip().splitlines()[0]}
    source = (_build.CSRC / "lut_build.cu").read_text()
    libs = {"source": _build.library("lut_build")}
    for v in args.variant:
        try:
            libs[v] = _build.build_variant(
                "lut_build", _build.with_constants(source, v), label=v)
        except ValueError as e:
            raise SystemExit(str(e))
    for f in args.baseline:
        libs[f"baseline {f}"] = _build.build_variant(
            "lut_build", Path(f).read_text(), label=f"baseline {f}")
    for p in args.probe:
        libs[f"probe {p}"] = _build.build_variant(
            "lut_build", probe_source(source, p), label=f"probe {p}")
    # registers and spill bytes of each LC instance of each build
    out["ptxas"] = {label: {k: [regs, st + ld] for k, regs, _, st, ld
                            in ptxas_instances(text)}
                    for label, text in _build.build_log.items()}
    for label, (name, res, books, sqn) in load_inputs(
            torch, LAUNCH_FILE).items():
        fn = getattr(ops, name)

        def call():
            got = fn(res, books, sqn)
            return tuple(got) if name == "lut_build_q" else (got,)

        t, (m, cb, dsub) = res.shape[0], books.shape
        nbytes, nops = lut_bytes_ops(t, m, cb, dsub, name == "lut_build_q")
        quant = name == "lut_build_q"
        # the card's write rate on the kernel's output bytes: zero_ on a
        # tensor of that size (a yardstick only)
        fill = torch.empty(t * m * (cb + 8 if quant else cb * 4),
                           dtype=torch.uint8, device="cuda")
        row = {"kernel": name, "T": t, "M": m, "CB": cb, "dsub": dsub,
               "bound_ms": bound_ms(nbytes, nops)[0],
               "fill_ms": event_ms(fill.zero_, reps=20, queued=True),
               "source_ms": event_ms(call, reps=20, queued=True)}
        del fill
        want = call()
        try:
            for v, lib in libs.items():
                if v == "source":
                    continue
                _build._LIBS["lut_build"] = lib
                got = call()
                if not v.startswith("probe "):     # differs by design
                    row[f"same[{v}]"] = all(torch.equal(a, b)
                                            for a, b in zip(got, want))
                row[f"ms[{v}]"] = event_ms(call, reps=20, queued=True)
        finally:
            _build._LIBS["lut_build"] = libs["source"]
        row["source_ms_again"] = event_ms(call, reps=20, queued=True)
        out[label] = row
        del want
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
