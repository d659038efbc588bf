#!/usr/bin/env python3
r"""Compare the machine code (SASS) of the CUDA kernels in
``src/repro_torch/kernels/csrc`` against another copy of those sources.

    mkdir -p build/old_csrc
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old_csrc
    python tools/torch_sass_compare.py build/old_csrc/src/repro_torch/kernels/csrc \\
        --may-differ 'pq_scan_topk_kernel<\d+, \w+, 2, \d+>'

Builds each ``<name>.cu`` of both directories with the repo's ``nvcc``
flags into ``build/sass_compare/``, disassembles both with ``cuobjdump
-sass`` and holds every kernel instance of the other copy to the
instance of the same name in this tree, instruction for instruction.
Names are compared with their anonymous-namespace tag dropped (it
differs from build to build) and ``bool`` and ``int`` template arguments
alike, so a ``bool`` parameter that became an ``int`` with the same
values still matches.  ``--may-differ REGEX`` names instances that are
expected to differ or to be gone (a kernel the change redesigns), by a
regular expression on the readable name ``kernel<args>`` (e.g.
``pq_scan_topk_kernel<1, u8, 2, 1>``: KPL, code type, table kind,
vec16).  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), no GPU.
Prints one line per source and one JSON line; exits 1 if an instance of
the other copy that ``--may-differ`` does not name is missing here or
its code differs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build(nvcc: str, flags, src: Path, out: Path) -> None:
    r = subprocess.run([nvcc, *flags, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")


def sass(cuobjdump: str, lib: Path, names: dict) -> dict:
    """{kernel name (normalised): [instructions]} of a shared library;
    ``names`` gains {normalised: readable name}."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            names[normalise(m.group(1))] = readable(m.group(1))
            cur = funcs.setdefault(normalise(m.group(1)), [])
            continue
        if cur is not None and re.search(r"/\*[0-9a-f]{4}\*/", line):
            cur.append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line)
                       .split(";")[0].strip())
    return funcs


def normalise(name: str) -> str:
    """A mangled kernel name without its anonymous-namespace tag, with
    ``bool`` and ``int`` template arguments written alike."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN_ANON_",
                  name)
    return re.sub(r"L[bi](\d+)E", r"L?\1E", name)


def readable(name: str) -> str:
    """``kernel<args>`` for a mangled kernel template instance (integer
    arguments as numbers, u8 / i32 for the code types), else the name."""
    k = re.match(r"_ZN_ANON_\d+(\w+?)I((?:L[a-z?]+-?\d+E|[a-z])+)E",
                 normalise(name))
    if not k:
        return name
    args = [a or {"h": "u8", "i": "i32"}.get(t, t) for a, t in
            re.findall(r"L[a-z?]+(-?\d+)E|([a-z])", k.group(2))]
    return f"{k.group(1)}<{', '.join(args)}>"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="a directory holding another copy of "
                                  "the csrc sources")
    ap.add_argument("--may-differ", action="append", default=[],
                    metavar="REGEX",
                    help="instances (readable names) allowed to differ or "
                         "be missing")
    args = ap.parse_args()
    from repro_torch.kernels import _build
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out_dir = _build.BUILD_DIR.parent / "sass_compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    other = Path(args.other)
    report, bad, names = {}, 0, {}

    def allowed(k):
        return any(re.fullmatch(p, names[k]) for p in args.may_differ)
    for name in _build.SOURCES:
        build(nvcc, flags, other / f"{name}.cu", out_dir / f"other_{name}.so")
        build(nvcc, flags, _build.CSRC / f"{name}.cu",
              out_dir / f"this_{name}.so")
        theirs = sass(cuobjdump, out_dir / f"other_{name}.so", names)
        ours = sass(cuobjdump, out_dir / f"this_{name}.so", names)
        same = [k for k, v in theirs.items() if ours.get(k) == v]
        changed = [k for k in theirs if ours.get(k) != theirs[k]]
        differ = [names[k] for k in changed if k in ours and not allowed(k)]
        missing = [names[k] for k in changed
                   if k not in ours and not allowed(k)]
        expected = [names[k] for k in changed if allowed(k)]
        bad += len(differ) + len(missing)
        report[name] = {"identical": len(same), "differ": differ,
                        "missing": missing, "allowed_to_differ": expected,
                        "new": [names[k] for k in ours if k not in theirs]}
        print(f"{name}: {len(same)} of {len(theirs)} instances identical, "
              f"{len(differ)} differ, {len(missing)} missing, "
              f"{len(expected)} allowed to differ (--may-differ); "
              f"{len(report[name]['new'])} new here", flush=True)
    print(json.dumps({"sass_compare": report, "ok": bad == 0}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
