"""Public wrappers around the LC, DC, fused DC+TS and TS kernels.

A table is f32 (T, M, CB), bf16 (T, M, CB) or a :class:`QuantizedLUT`
(uint8 with per-subspace scale and bias); each kind has its own kernel
instance and launch counter.  On a CUDA tensor each wrapper launches its
hand-written kernel (built from ``csrc/`` at first use) or raises; on a
CPU tensor it runs the kernel's plain PyTorch version from
:mod:`repro_torch.core.adc`.  There is no fallback from the kernel to
the plain version.

``launches`` counts kernel launches per wrapper (plain runs do not
count), so a run can show which kernels its path went through; it is one
of :mod:`repro_torch.obs`'s counters.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import obs
from repro_torch.core.adc import (QuantizedLUT, check_strategy,
                                  adc_distances, adc_distances_quantized,
                                  build_lut_batch, quantize_lut)
from repro_torch.core.pq import PQCodebook
from repro_torch.core.topk import topk_smallest
from repro_torch.kernels import _build
from repro_torch.util import next_pow2

launches = obs.Counters("lut_build", "lut_build_q", "lut_build_bf16",
                        "pq_scan_dc", "pq_scan_dc_q", "pq_scan_dc_bf16",
                        "pq_scan_topk", "pq_scan_topk_q", "pq_scan_topk_bf16",
                        "ts_topk")
reset_launches = launches.reset
_launched = launches.add

# The C entry points' table kinds (csrc/pq_row.cuh) and each kind's
# launch-counter suffix.
_KIND = {"f32": 0, "u8": 1, "bf16": 2}
KIND_SUFFIX = {"f32": "", "u8": "_q", "bf16": "_bf16"}

# Dynamic shared memory one block may use on an H100 (227 KB).
_SMEM_LIMIT = 232448
# Largest k_pad the fused DC+TS kernels and TS by slot take; must equal
# kMaxKPad in csrc/warp_topk.cuh.  The wrapper holds both routes to it.
MAX_K_PAD = 256
# Largest C (rows a slot) the fused kernel's 32-bit selection keys take on
# a bf16 table: the row is the key's low 16 bits, 0xffff its "no row"
# (kMaxRowsKey32 in csrc/warp_topk.cuh).  More rows take 64-bit keys.
BF16_KEY32_MAX_C = 0xffff


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


def _lut_table(residuals, codebooks, sqnorms, kind: str) -> torch.Tensor:
    """LC into a (T, M, CB) f32 or bf16 table (``kind``)."""
    dev, t, m, cbn, dsub = _lut_inputs(residuals, codebooks, sqnorms)
    if not _route(dev):
        lut = build_lut_batch(PQCodebook(codebooks, sqnorms), residuals)
        return lut if kind == "f32" else lut.to(torch.bfloat16)
    name = "lut_build" + KIND_SUFFIX[kind]
    lib = _build.library("lut_build")
    _smem(name, lib.lut_build_smem_bytes(_KIND[kind], cbn, dsub))
    out = torch.empty((t, m, cbn), device=dev, dtype=(
        torch.float32 if kind == "f32" else torch.bfloat16))
    fn = lib.lut_build_f32 if kind == "f32" else lib.lut_build_bf16
    with torch.cuda.device(dev):
        err = fn(residuals.data_ptr(), codebooks.data_ptr(),
                 sqnorms.data_ptr(), out.data_ptr(), t, m, cbn, dsub,
                 _stream(dev))
    _ok(lib, err, name, "lut_build")
    _launched(name)
    return out


def lut_build(residuals: torch.Tensor, codebooks: torch.Tensor,
              sqnorms: torch.Tensor) -> torch.Tensor:
    """LC: (T, D) residuals, codebooks (M, CB, dsub), sqnorms (M, CB), all
    f32 -> (T, M, CB) f32 LUTs."""
    return _lut_table(residuals, codebooks, sqnorms, "f32")


def lut_build_bf16(residuals: torch.Tensor, codebooks: torch.Tensor,
                   sqnorms: torch.Tensor) -> torch.Tensor:
    """LC into a bf16 table: the inputs of :func:`lut_build` -> (T, M, CB)
    bf16, each entry :func:`lut_build`'s f32 one rounded to nearest even
    (the reference's ``lut.astype(bfloat16)``).  On the card the f32 table
    never leaves the kernel."""
    return _lut_table(residuals, codebooks, sqnorms, "bf16")


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


def table_kind(lut) -> str:
    """A scan's table kind: "f32", "bf16", or "u8" for a
    :class:`QuantizedLUT`."""
    if isinstance(lut, QuantizedLUT):
        return "u8"
    return "bf16" if lut.dtype == torch.bfloat16 else "f32"


def _scan_inputs(lut, codes, sizes, slots=None):
    """Check a scan's table, codes, sizes and slots; returns (kind, table,
    device, T, P, C, M, CB): the table's kind (:func:`table_kind`), T
    tasks (tables), P code slots (T without ``slots``)."""
    kind = table_kind(lut)
    quantized = kind == "u8"
    table = lut.lut_q if quantized else lut
    dev = table.device
    _check(table, "lut", (torch.uint8,) if quantized else
           (torch.float32, torch.bfloat16), 3, dev)
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
    return kind, table, dev, t, p, c, m, cbn


def pq_scan_dc(lut: Union[torch.Tensor, QuantizedLUT], codes: torch.Tensor,
               sizes: Optional[torch.Tensor] = None, *,
               strategy: str = "gather",
               slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DC: (T, M, CB) table x (T, C, M) codes -> (T, C) f32; rows
    ``>= sizes[t]`` are +inf (``sizes`` None: all rows valid).

    ``slots`` ((T,) int32): codes (P, C, M) and sizes (P,), which are then
    required, are P code slots, and task t reads slot ``slots[t]`` in place
    (any slot outside [0, P): size 0, all +inf).  The result is that of the
    dense call on :func:`gather_slots`' copy, which the plain version
    scans.

    ``lut`` is the f32 table, a bf16 table (each row's f32 sum rounded
    once to bf16, :func:`~repro_torch.core.adc.scan_codes`) or a
    :class:`QuantizedLUT` (uint8 path).  Codes are uint8 or int32.
    ``strategy`` names a TPU dataflow and does not change the result."""
    check_strategy(strategy)
    kind, table, dev, t, p, c, m, cbn = _scan_inputs(lut, codes, sizes,
                                                     slots)
    if slots is not None and sizes is None:
        raise ValueError("pq_scan_dc: slots need sizes")
    if not _route(dev):
        if slots is not None:
            codes, _, sizes = gather_slots(codes, None, sizes, slots)
        if kind == "u8":
            return adc_distances_quantized(lut, codes, sizes, strategy)
        return adc_distances(lut, codes, sizes, strategy)
    name = "pq_scan_dc" + KIND_SUFFIX[kind]
    lib = _build.library("pq_scan")
    _smem(name, lib.pq_scan_smem_bytes(_KIND[kind], m, cbn))
    out = torch.empty((t, c), dtype=torch.float32, device=dev)
    sizes_ptr = None if sizes is None else sizes.data_ptr()
    slots_ptr = None if slots is None else slots.data_ptr()
    code_bytes = codes.element_size()
    with torch.cuda.device(dev):
        if kind == "u8":
            err = lib.pq_scan_u8(table.data_ptr(), lut.scale.data_ptr(),
                                 lut.bias.data_ptr(), codes.data_ptr(),
                                 sizes_ptr, slots_ptr, out.data_ptr(), t, p,
                                 c, m, cbn, code_bytes, _stream(dev))
        else:
            fn = lib.pq_scan_f32 if kind == "f32" else lib.pq_scan_bf16
            err = fn(table.data_ptr(), codes.data_ptr(), sizes_ptr,
                     slots_ptr, out.data_ptr(), t, p, c, m, cbn, code_bytes,
                     _stream(dev))
    _ok(lib, err, name, "pq_scan")
    _launched(name)
    return out


def gather_slots(codes: torch.Tensor, ids: Optional[torch.Tensor],
                 sizes: torch.Tensor, slots: torch.Tensor):
    """The dense inputs of a slot-form call: task t's codes, ids and size
    are those of slot ``slots[t]`` of the (P, ...) tensors, and a slot
    outside [0, P) (-1: no task) has size 0, as on the card.  A copy (ids
    None: none is made of them); the kernels read the slots in place."""
    s = slots.long()
    valid = (s >= 0) & (s < codes.shape[0])
    si = torch.where(valid, s, 0)
    return (codes.index_select(0, si),
            None if ids is None else ids.index_select(0, si),
            sizes.index_select(0, si).masked_fill(~valid, 0))


def pq_scan_topk_plain(lut: Union[torch.Tensor, QuantizedLUT],
                       codes: torch.Tensor, ids: torch.Tensor,
                       sizes: torch.Tensor, k_pad: int, *,
                       slots: Optional[torch.Tensor] = None):
    """The fused kernels' plain version: DC (``adc_distances``, f32 or
    bf16 table, or ``adc_distances_quantized``), masked ids, then
    ``topk_smallest``.
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


def _topk_entry(kind: str, c: int):
    """(C entry point, selection-key bits) of the fused kernel instance
    for a table kind and C rows a slot: 32-bit keys on a bf16 table of at
    most ``BF16_KEY32_MAX_C`` rows, else 64-bit keys."""
    if kind == "bf16" and c <= BF16_KEY32_MAX_C:
        return "pq_scan_topk_bf16", 32
    return {"f32": "pq_scan_topk_f32", "u8": "pq_scan_topk_u8",
            "bf16": "pq_scan_topk_bf16_wide"}[kind], 64


def pq_scan_topk_instance(lut: Union[torch.Tensor, QuantizedLUT],
                          codes: torch.Tensor) -> dict:
    """The fused kernel instance :func:`pq_scan_topk` launches on this
    table and codes: its C entry point, selection-key bits and block
    threads (the library is built if needed)."""
    kind = table_kind(lut)
    entry, bits = _topk_entry(kind, codes.shape[1])
    threads = _build.library("pq_scan_topk").pq_scan_topk_threads(
        _KIND[kind])
    return {"entry": entry, "key_bits": bits, "threads": threads}


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
    exceed :data:`MAX_K_PAD`.  ``lut`` is the f32 table, a bf16 table or
    a :class:`QuantizedLUT`; codes uint8 or int32; ids and sizes int32.
    On the card ties are broken by row, so the output is deterministic;
    the kernel instance is :func:`pq_scan_topk_instance`'s, chosen by the
    table kind and C (both instances are hand-written kernels)."""
    check_strategy(strategy)
    kind, table, dev, t, p, c, m, cbn = _scan_inputs(lut, codes, sizes,
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
    name = "pq_scan_topk" + KIND_SUFFIX[kind]
    entry, bits = _topk_entry(kind, c)
    lib = _build.library("pq_scan_topk")
    _smem(name, lib.pq_scan_topk_smem_bytes(_KIND[kind], m, cbn, k_pad,
                                            bits))
    out_d = torch.empty((t, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((t, k_pad), dtype=torch.int32, device=dev)
    code_bytes = codes.element_size()
    slots_ptr = None if slots is None else slots.data_ptr()
    with torch.cuda.device(dev):
        if kind == "u8":
            err = lib.pq_scan_topk_u8(
                table.data_ptr(), lut.scale.data_ptr(), lut.bias.data_ptr(),
                codes.data_ptr(), ids.data_ptr(), sizes.data_ptr(), slots_ptr,
                out_d.data_ptr(), out_i.data_ptr(), t, p, c, m, cbn,
                code_bytes, k_pad, _stream(dev))
        else:
            err = getattr(lib, entry)(
                table.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                sizes.data_ptr(), slots_ptr, out_d.data_ptr(),
                out_i.data_ptr(), t, p, c, m, cbn, code_bytes, k_pad,
                _stream(dev))
    _ok(lib, err, name, "pq_scan_topk")
    _launched(name)
    return out_d[:, :k], out_i[:, :k]


def ts_topk_plain(dists: torch.Tensor, slots: torch.Tensor,
                  ids: torch.Tensor, qc: int, k: int):
    """TS by slot's plain version: ``torch.topk`` over each query's (P *
    C) distances, then each winner's id by (slot of its probe, row); a
    winner in a slot outside [0, nslots) gets id -1.  ``dists`` as DC by
    slot writes it: +inf at every row past its task's size."""
    c = dists.shape[1]
    d, pos = torch.topk(dists.reshape(qc, -1), k, dim=-1, largest=False,
                        sorted=True)
    probes = slots.long().reshape(qc, -1).gather(1, pos // c)
    valid = (probes >= 0) & (probes < ids.shape[0])
    # position -> (probe, row) -> the id stored at that padded row
    row = torch.where(valid, probes, 0) * c + pos % c
    return d, torch.take(ids, row).masked_fill_(~valid, -1)


def ts_topk(dists: torch.Tensor, slots: torch.Tensor, sizes: torch.Tensor,
            ids: torch.Tensor, qc: int, k: int):
    """TS by slot: each query's k smallest distances over its probes' real
    rows, ascending, and their ids: ((qc, k) f32, (qc, k) i32).

    ``dists`` (qc * P, C) f32 is DC by slot's output (task t: query t //
    P, probe t % P), ``slots`` (qc * P,) int32 the flat probes, ``sizes``
    (nslots,) and ``ids`` (nslots, C) int32 the padded clusters'.  Task
    t's real rows are r < ``sizes[slots[t]]`` (a slot outside [0,
    nslots): none); past a query's real rows the output is (+inf, -1).
    On the card the kernel reads only the real rows, and ties go to the
    lower position ``probe * C + row``; the plain version
    (:func:`ts_topk_plain`) reads every row, so ``dists`` must be +inf
    past each task's size, as DC writes it.  1 <= k <= :data:`MAX_K_PAD`
    and k <= P * C."""
    dev = dists.device
    _check(dists, "dists", (torch.float32,), 2, dev)
    _check(slots, "slots", (torch.int32,), 1, dev)
    _check(sizes, "sizes", (torch.int32,), 1, dev)
    _check(ids, "ids", (torch.int32,), 2, dev)
    t, c = dists.shape
    nslots = sizes.shape[0]
    if qc < 1 or t % qc or slots.shape[0] != t:
        raise ValueError(f"dists {tuple(dists.shape)} and slots "
                         f"{tuple(slots.shape)} are not {qc} queries' "
                         f"tasks")
    p = t // qc
    if ids.shape != (nslots, c):
        raise ValueError(f"ids {tuple(ids.shape)} != {(nslots, c)}")
    k_max = min(MAX_K_PAD, p * c)
    if not 1 <= k <= k_max:
        raise ValueError(f"ts_topk: k={k} not in [1, {k_max}]")
    if p * c >= 2 ** 31 - 1:
        raise ValueError(f"ts_topk: P * C = {p * c} positions, above the "
                         f"kernel's 32-bit keys")
    if not _route(dev):
        return ts_topk_plain(dists, slots, ids, qc, k)
    lib = _build.library("ts_topk")
    scratch = torch.empty(lib.ts_topk_scratch_bytes(qc, p, k) // 8,
                          dtype=torch.int64, device=dev)
    out_d = torch.empty((qc, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qc, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ts_topk_f32(dists.data_ptr(), slots.data_ptr(),
                              sizes.data_ptr(), ids.data_ptr(),
                              scratch.data_ptr(), out_d.data_ptr(),
                              out_i.data_ptr(), qc, p, c, nslots, k,
                              _stream(dev))
    _ok(lib, err, "ts_topk", "ts_topk")
    _launched("ts_topk")
    return out_d, out_i
