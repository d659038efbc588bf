"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries
land in ``build/repro_torch_kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source builds anew and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
VARIANT_DIR = BUILD_DIR.parent / "kernel_variants"
SOURCES = ("lut_build", "pq_scan", "pq_scan_topk", "ts_topk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# C entry points: name -> (argtypes, restype)
SIGNATURES = {
    "lut_build": {
        "lut_build_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "lut_build_u8": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "lut_build_bf16": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "lut_build_smem_bytes": ([_I, _I, _I], _S),
        "lut_build_error_string": ([_I], ctypes.c_char_p),
    },
    "pq_scan": {
        "pq_scan_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                        _I),
        "pq_scan_u8": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P], _I),
        "pq_scan_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                         _I),
        "pq_scan_smem_bytes": ([_I, _I, _I], _S),
        "pq_scan_error_string": ([_I], ctypes.c_char_p),
    },
    "pq_scan_topk": {
        "pq_scan_topk_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _P], _I),
        "pq_scan_topk_u8": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _P], _I),
        "pq_scan_topk_bf16": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _P], _I),
        "pq_scan_topk_bf16_wide": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _P], _I),
        "pq_scan_topk_smem_bytes": ([_I, _I, _I, _I, _I], _S),
        "pq_scan_topk_threads": ([_I], _I),
        "pq_scan_topk_error_string": ([_I], ctypes.c_char_p),
    },
    "ts_topk": {
        "ts_topk_scratch_bytes": ([_I, _I, _I], _S),
        "ts_topk_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                        _I),
        "ts_topk_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_log: Dict[str, str] = {}     # source name -> nvcc's output (-Xptxas -v)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/csrc at first use and need "
                       "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the missing libraries, one ``nvcc`` per source, all started
    together.  Returns the wall seconds spent (0.0 when all were built)."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _load(name: str, path: Path, require_all: bool = True) -> ctypes.CDLL:
    """The library at ``path`` with ``SIGNATURES[name]`` set; a function
    it lacks raises, or with ``require_all`` off is left out (an older
    source's build)."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        if not require_all and not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = _load(name, target(name))
        return lib


def with_constants(source: str, spec: str) -> str:
    """``source`` with ``constexpr int NAME = VALUE;`` for each NAME=VALUE
    of the comma-separated ``spec``, in place of that constant's first
    definition; raises ValueError if a NAME has none."""
    for item in spec.split(","):
        name, value = (x.strip() for x in item.split("="))
        pat = re.compile(rf"constexpr int {re.escape(name)} = [^;]+;")
        if not pat.search(source):
            raise ValueError(f"no 'constexpr int {name} = ...;' in the "
                             f"source")
        source = pat.sub(f"constexpr int {name} = {value};", source, count=1)
    return source


def build_variant(name: str, source: str, label: Optional[str] = None,
                  headers: Optional[Dict[str, str]] = None,
                  require_all: bool = True) -> ctypes.CDLL:
    """``source``, a replacement for ``csrc/<name>.cu`` with the same C
    interface, built beside copies of the shared headers into
    ``build/kernel_variants/`` and loaded with ``SIGNATURES[name]``
    (``require_all`` off: functions it lacks are left out, see
    :func:`_load`).  ``headers`` ({file name: text}) replaces those
    headers' copies.  nvcc's output goes to ``build_log[label]`` (default
    ``"<name>@<hash>"``)."""
    headers = headers or {}
    tag = hashlib.sha256(
        source.encode() + " ".join(NVCC_FLAGS).encode()
        + "".join(f"{h}\0{t}" for h, t in sorted(headers.items())).encode()
    ).hexdigest()[:12]
    where = VARIANT_DIR / f"{name}-{tag}"
    lib = where / f"{name}.so"
    if not lib.exists():
        where.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, where / h.name)
        for h, text in headers.items():
            (where / h).write_text(text)
        (where / f"{name}.cu").write_text(source)
        out = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
                              str(where / f"{name}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        build_log[label or f"{name}@{tag}"] = out.stdout
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant "
                               f"{where} (exit {out.returncode}):\n"
                               f"{out.stdout}")
    return _load(name, lib, require_all)
