"""Kernels C, D and C-bf16 (``csrc/pq_scan.cu``) on the card at the edges
of their block layout: a persistent grid whose blocks walk the tasks,
stage a task's table only if it has a valid row, score rows [0, size)
and write +inf past them.

Each case runs the slot form and the dense form on ``gather_slots``'
copy, with uint8 and int32 codes, on an f32, a uint8 and a bf16 table:
the two forms equal bit for bit, close to the plain version, +inf at
exactly the rows at or past each task's size, one launch a call.  The
cases: sizes 0, 1, 1023, 1024, 1025, 2048 and C; C = 6,200 with the
benchmark cells' log-normal sizes; more tasks than the grid has blocks,
fewer, and one; slots outside [0, P); M = 8 and M = 32 (the generic row
loop); rows that start off a 16-byte boundary (odd C).

Every test here needs an NVIDIA GPU and skips without one:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_dc_layout.py
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.adc import adc_distances, adc_distances_quantized
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-3        # f32 sums in another order
BF16_RTOL = 2.0 ** -8          # a bf16 value against the plain one
EDGE_SIZES = (0, 1, 1023, 1024, 1025, 2048)

# case -> (tasks T, slots P, rows a slot C, M, CB, sizes)
CASES = {
    "size_edges": (40, 14, 2100, 16, 256, "edges"),
    "cell_lognormal": (3000, 600, 6200, 16, 256, "lognormal"),
    "tasks_above_grid": (40000, 300, 301, 16, 256, "uniform"),
    "tasks_below_grid": (100, 50, 1501, 16, 256, "uniform"),
    "one_task": (1, 3, 1029, 16, 256, "uniform"),
    "m8": (500, 64, 777, 8, 256, "uniform"),
    "m32": (300, 40, 1030, 32, 64, "uniform"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def cell_sizes(p: int, g: torch.Generator) -> torch.Tensor:
    """(p,) int32 sizes drawn from the benchmark cells' cluster sizes
    (``annbench/draws/ivfpq.py``: 1e8 rows over 65,536 clusters, a
    log-normal of spread 0.337), the largest (6,192) among them."""
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from annbench.draws.ivfpq import size_multiset
    every = size_multiset(10 ** 8, 65536, 0.337)
    pick = torch.randperm(len(every) - 1, generator=g)[:p - 1]
    return torch.cat([every[pick], every[-1:]]).int()


def layout_inputs(case: str, code_dtype: torch.dtype, kind: str,
                  device, seed: int = 0):
    """(lut, codes, sizes, slots) of one case: ``codes`` (P, C, M) and
    ``sizes`` (P,) are P code slots, ``lut`` T tasks' tables of ``kind``
    ("f32", "u8", "bf16") from A, B or A-bf16, ``slots`` (T,) int32 with
    -1, P and P + 1000 among them where T > 3."""
    t, p, c, m, cb, how = CASES[case]
    g = torch.Generator().manual_seed(seed)
    if how == "edges":
        sizes = torch.tensor([*EDGE_SIZES, c] * 2, dtype=torch.int32)
    elif how == "lognormal":
        sizes = cell_sizes(p, g)
    else:
        sizes = torch.randint(0, c + 1, (p,), generator=g, dtype=torch.int32)
    codes = torch.randint(0, cb, (p, c, m), generator=g,
                          dtype=torch.int32).to(code_dtype)
    slots = torch.randint(0, p, (t,), generator=g, dtype=torch.int32)
    if how == "edges":
        slots[:p] = torch.arange(p)                # every size, in order
    if t > 3:
        slots[-3:] = torch.tensor([-1, p, p + 1000])
    dsub = 4
    res = torch.randn(t, m * dsub, generator=g) * 8
    books = torch.randn(m, cb, dsub, generator=g) * 6
    res, books = res.to(device), books.to(device)
    build = {"f32": ops.lut_build, "u8": ops.lut_build_q,
             "bf16": ops.lut_build_bf16}[kind]
    lut = build(res, books, (books * books).sum(-1))
    return lut, codes.to(device), sizes.to(device), slots.to(device)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("kind", ["f32", "u8", "bf16"])
def test_dc_layout_by_slot_equals_dense_and_plain(cuda, case, code_dtype,
                                                  kind):
    lut, codes, sizes, slots = layout_inputs(case, code_dtype, kind, cuda)
    name = "pq_scan_dc" + ops.KIND_SUFFIX[kind]
    ops.reset_launches()
    got = ops.pq_scan_dc(lut, codes, sizes, slots=slots)
    gcodes, _, gsizes = ops.gather_slots(codes, None, sizes, slots)
    dense = ops.pq_scan_dc(lut, gcodes, gsizes)
    torch.cuda.synchronize()
    assert ops.launches[name] == 2
    assert torch.equal(got, dense)
    rows = torch.arange(codes.shape[1], device=cuda)
    assert torch.equal(torch.isinf(got), rows[None, :] >= gsizes[:, None])
    plain = (adc_distances_quantized if kind == "u8" else adc_distances)(
        lut, gcodes, gsizes)
    fin = torch.isfinite(plain)
    assert torch.equal(fin, torch.isfinite(got))
    rtol, atol = (BF16_RTOL, 0.0) if kind == "bf16" else (RTOL, ATOL)
    torch.testing.assert_close(got[fin], plain[fin], rtol=rtol, atol=atol)
    if kind == "bf16":
        assert torch.equal(got.to(torch.bfloat16).float(), got)
