"""Public wrappers around the LC, DC and fused DC+TS kernels.

On a CUDA tensor each wrapper launches its hand-written kernel (built
from ``csrc/`` at first use) or raises; on a CPU tensor it runs the
kernel's plain PyTorch version from :mod:`repro_torch.core.adc`.  There
is no fallback from the kernel to the plain version.

``launches`` counts kernel launches per wrapper (plain runs do not
count), so a run can show which kernels its path went through.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from repro_torch.core.adc import (QuantizedLUT, check_strategy,
                                  adc_distances, adc_distances_quantized,
                                  build_lut_batch, quantize_lut)
from repro_torch.core.pq import PQCodebook
from repro_torch.core.topk import topk_smallest
from repro_torch.kernels import _build
from repro_torch.util import next_pow2

launches = {"lut_build": 0, "lut_build_q": 0, "pq_scan_dc": 0,
            "pq_scan_dc_q": 0, "pq_scan_topk": 0, "pq_scan_topk_q": 0}

# Dynamic shared memory one block may use on an H100 (227 KB).
_SMEM_LIMIT = 232448
# Largest k_pad the fused DC+TS kernels take (kMaxKPad in
# csrc/pq_scan_topk.cu); the wrapper holds both routes to it.
MAX_K_PAD = 256


# the service's replica workers launch from several threads at once
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def _launched(name: str) -> None:
    with _LAUNCHES_LOCK:
        launches[name] += 1


def _check(t: torch.Tensor, what: str, dtypes, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _route(device: torch.device) -> bool:
    """True: launch the kernel.  False: plain version (CPU tensors)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {device}")


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``; the C launchers run on the
    caller's current CUDA device, which the wrappers set to ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def _ok(lib, err: int, fn: str, prefix: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def _smem(fn: str, need: int) -> None:
    if need > _SMEM_LIMIT:
        raise ValueError(f"{fn}: one block needs {need} bytes of shared "
                         f"memory, more than the {_SMEM_LIMIT} a block may "
                         f"use")


def _lut_inputs(residuals, codebooks, sqnorms):
    dev = residuals.device
    _check(residuals, "residuals", (torch.float32,), 2, dev)
    _check(codebooks, "codebooks", (torch.float32,), 3, dev)
    _check(sqnorms, "sqnorms", (torch.float32,), 2, dev)
    t = residuals.shape[0]
    m, cbn, dsub = codebooks.shape
    if residuals.shape[1] != m * dsub or sqnorms.shape != (m, cbn):
        raise ValueError(f"residuals {tuple(residuals.shape)}, codebooks "
                         f"{tuple(codebooks.shape)}, sqnorms "
                         f"{tuple(sqnorms.shape)} do not agree")
    return dev, t, m, cbn, dsub


def lut_build(residuals: torch.Tensor, codebooks: torch.Tensor,
              sqnorms: torch.Tensor) -> torch.Tensor:
    """LC: (T, D) residuals, codebooks (M, CB, dsub), sqnorms (M, CB), all
    f32 -> (T, M, CB) f32 LUTs."""
    dev, t, m, cbn, dsub = _lut_inputs(residuals, codebooks, sqnorms)
    if not _route(dev):
        return build_lut_batch(PQCodebook(codebooks, sqnorms), residuals)
    lib = _build.library("lut_build")
    _smem("lut_build", lib.lut_build_smem_bytes(0, cbn, dsub))
    out = torch.empty((t, m, cbn), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lut_build_f32(residuals.data_ptr(), codebooks.data_ptr(),
                                sqnorms.data_ptr(), out.data_ptr(), t, m, cbn,
                                dsub, _stream(dev))
    _ok(lib, err, "lut_build", "lut_build")
    _launched("lut_build")
    return out


def lut_build_q(residuals: torch.Tensor, codebooks: torch.Tensor,
                sqnorms: torch.Tensor) -> QuantizedLUT:
    """LC with the fused quantize epilogue: (T, D) residuals ->
    QuantizedLUT of (T, M, CB) u8 + (T, M) scale/bias.  On the card the
    f32 table never leaves the kernel."""
    dev, t, m, cbn, dsub = _lut_inputs(residuals, codebooks, sqnorms)
    if not _route(dev):
        return quantize_lut(build_lut_batch(PQCodebook(codebooks, sqnorms),
                                            residuals))
    lib = _build.library("lut_build")
    _smem("lut_build_q", lib.lut_build_smem_bytes(1, cbn, dsub))
    lut_q = torch.empty((t, m, cbn), dtype=torch.uint8, device=dev)
    scale = torch.empty((t, m), dtype=torch.float32, device=dev)
    bias = torch.empty((t, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lut_build_u8(residuals.data_ptr(), codebooks.data_ptr(),
                               sqnorms.data_ptr(), lut_q.data_ptr(),
                               scale.data_ptr(), bias.data_ptr(), t, m, cbn,
                               dsub, _stream(dev))
    _ok(lib, err, "lut_build_q", "lut_build")
    _launched("lut_build_q")
    return QuantizedLUT(lut_q, scale, bias)


def _scan_inputs(lut, codes, sizes, slots=None):
    """Check a scan's table, codes, sizes and slots; returns (quantized,
    table, device, T, P, C, M, CB): T tasks (tables), P code slots (T
    without ``slots``)."""
    quantized = isinstance(lut, QuantizedLUT)
    table = lut.lut_q if quantized else lut
    dev = table.device
    _check(table, "lut", (torch.uint8,) if quantized else (torch.float32,),
           3, dev)
    _check(codes, "codes", (torch.uint8, torch.int32), 3, dev)
    p, c, m = codes.shape
    t = p
    if slots is not None:
        _check(slots, "slots", (torch.int32,), 1, dev)
        t = slots.shape[0]
    cbn = table.shape[2]
    if table.shape[:2] != (t, m):
        raise ValueError(f"lut {tuple(table.shape)} does not match {t} "
                         f"tasks of codes {tuple(codes.shape)}")
    if quantized:
        for name, x in (("scale", lut.scale), ("bias", lut.bias)):
            _check(x, name, (torch.float32,), 2, dev)
            if x.shape != (t, m):
                raise ValueError(f"{name} {tuple(x.shape)} != {(t, m)}")
    if sizes is not None:
        _check(sizes, "sizes", (torch.int32,), 1, dev)
        if sizes.shape[0] != p:
            raise ValueError(f"sizes {tuple(sizes.shape)} != ({p},)")
    return quantized, table, dev, t, p, c, m, cbn


def pq_scan_dc(lut: Union[torch.Tensor, QuantizedLUT], codes: torch.Tensor,
               sizes: Optional[torch.Tensor] = None, *,
               strategy: str = "gather") -> torch.Tensor:
    """DC: (T, M, CB) table x (T, C, M) codes -> (T, C) f32; rows
    ``>= sizes[t]`` are +inf (``sizes`` None: all rows valid).

    ``lut`` is the f32 table or a :class:`QuantizedLUT` (uint8 path).
    Codes are uint8 or int32.  ``strategy`` names a TPU dataflow and does
    not change the result."""
    check_strategy(strategy)
    quantized, table, dev, t, _, c, m, cbn = _scan_inputs(lut, codes,
                                                          sizes)
    if not _route(dev):
        if quantized:
            return adc_distances_quantized(lut, codes, sizes, strategy)
        return adc_distances(lut, codes, sizes, strategy)
    lib = _build.library("pq_scan")
    _smem("pq_scan_dc", lib.pq_scan_smem_bytes(int(quantized), m, cbn))
    out = torch.empty((t, c), dtype=torch.float32, device=dev)
    sizes_ptr = None if sizes is None else sizes.data_ptr()
    code_bytes = codes.element_size()
    with torch.cuda.device(dev):
        if quantized:
            err = lib.pq_scan_u8(table.data_ptr(), lut.scale.data_ptr(),
                                 lut.bias.data_ptr(), codes.data_ptr(),
                                 sizes_ptr, out.data_ptr(), t, c, m, cbn,
                                 code_bytes, _stream(dev))
        else:
            err = lib.pq_scan_f32(table.data_ptr(), codes.data_ptr(),
                                  sizes_ptr, out.data_ptr(), t, c, m, cbn,
                                  code_bytes, _stream(dev))
    name = "pq_scan_dc_q" if quantized else "pq_scan_dc"
    _ok(lib, err, name, "pq_scan")
    _launched(name)
    return out


def gather_slots(codes: torch.Tensor, ids: torch.Tensor,
                 sizes: torch.Tensor, slots: torch.Tensor):
    """The dense inputs of a slot-form fused call: task t's codes, ids and
    size are those of slot ``slots[t]`` of the (P, ...) tensors, and a
    slot outside [0, P) (-1: no task) has size 0, as on the card.  A
    copy; the kernels read the slots in place."""
    s = slots.long()
    valid = (s >= 0) & (s < codes.shape[0])
    si = torch.where(valid, s, 0)
    return (codes.index_select(0, si), ids.index_select(0, si),
            sizes.index_select(0, si).masked_fill(~valid, 0))


def pq_scan_topk_plain(lut: Union[torch.Tensor, QuantizedLUT],
                       codes: torch.Tensor, ids: torch.Tensor,
                       sizes: torch.Tensor, k_pad: int, *,
                       slots: Optional[torch.Tensor] = None):
    """The fused kernels' plain version: DC (``adc_distances`` or
    ``adc_distances_quantized``), masked ids, then ``topk_smallest``.
    Returns (T, k_pad) ascending distances and ids, (+inf, -1) past the
    valid rows, C < k_pad included.  ``slots``: as :func:`pq_scan_topk`,
    through :func:`gather_slots`."""
    if slots is not None:
        codes, ids, sizes = gather_slots(codes, ids, sizes, slots)
    if isinstance(lut, QuantizedLUT):
        d = adc_distances_quantized(lut, codes, sizes)
    else:
        d = adc_distances(lut, codes, sizes)
    valid = (torch.arange(d.shape[1], device=d.device)[None, :]
             < sizes[:, None])
    ids = ids.masked_fill(~valid, -1)
    short = k_pad - d.shape[1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    return topk_smallest(d, ids, k_pad)


def pq_scan_topk(lut: Union[torch.Tensor, QuantizedLUT], codes: torch.Tensor,
                 ids: torch.Tensor, sizes: torch.Tensor, k: int, *,
                 strategy: str = "gather",
                 slots: Optional[torch.Tensor] = None):
    """Fused DC+TS: (T, M, CB) table x (T, C, M) codes -> the k smallest
    distances per task, ascending, and their ids: ((T, k) f32, (T, k)
    i32).  Rows ``>= sizes[t]`` never compete; slots past the valid rows
    are (+inf, -1).

    ``slots`` ((T,) int32): codes (P, C, M), ids (P, C) and sizes (P,)
    are P code slots, and task t reads slot ``slots[t]`` in place (-1, or
    any slot outside [0, P): no task, size 0).  Without it, P = T and task t
    reads slot t.  The result is that of the dense call on
    :func:`gather_slots`' copy.

    As the reference's wrapper: ``k_pad = next_pow2(max(k, 8))`` winners
    are selected and the outputs are sliced to ``k``; ``k_pad`` may not
    exceed :data:`MAX_K_PAD`.  ``lut`` is the f32 table or a
    :class:`QuantizedLUT`; codes uint8 or int32; ids and sizes int32.
    On the card ties are broken by row, so the output is deterministic."""
    check_strategy(strategy)
    quantized, table, dev, t, p, c, m, cbn = _scan_inputs(lut, codes, sizes,
                                                          slots)
    if sizes is None:
        raise ValueError("pq_scan_topk needs sizes")
    _check(ids, "ids", (torch.int32,), 2, dev)
    if ids.shape != (p, c):
        raise ValueError(f"ids {tuple(ids.shape)} != {(p, c)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    k_pad = next_pow2(max(k, 8))
    if k_pad > MAX_K_PAD:
        raise ValueError(f"pq_scan_topk: k={k} needs k_pad={k_pad}, above "
                         f"the kernels' {MAX_K_PAD}")
    if not _route(dev):
        bd, bi = pq_scan_topk_plain(lut, codes, ids, sizes, k_pad,
                                    slots=slots)
        return bd[:, :k], bi[:, :k]
    lib = _build.library("pq_scan_topk")
    _smem("pq_scan_topk",
          lib.pq_scan_topk_smem_bytes(int(quantized), m, cbn, k_pad))
    out_d = torch.empty((t, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((t, k_pad), dtype=torch.int32, device=dev)
    code_bytes = codes.element_size()
    slots_ptr = None if slots is None else slots.data_ptr()
    with torch.cuda.device(dev):
        if quantized:
            err = lib.pq_scan_topk_u8(
                table.data_ptr(), lut.scale.data_ptr(), lut.bias.data_ptr(),
                codes.data_ptr(), ids.data_ptr(), sizes.data_ptr(), slots_ptr,
                out_d.data_ptr(), out_i.data_ptr(), t, p, c, m, cbn,
                code_bytes, k_pad, _stream(dev))
        else:
            err = lib.pq_scan_topk_f32(
                table.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                sizes.data_ptr(), slots_ptr, out_d.data_ptr(),
                out_i.data_ptr(), t, p, c, m, cbn, code_bytes, k_pad,
                _stream(dev))
    name = "pq_scan_topk_q" if quantized else "pq_scan_topk"
    _ok(lib, err, name, "pq_scan_topk")
    _launched(name)
    return out_d[:, :k], out_i[:, :k]
