"""Port parity for the LC, DC and fused DC+TS kernels' contracts.

On the CPU the port's wrappers run the kernels' plain versions; they are
held to the reference's Pallas kernels (interpret mode) at the
reference's kernel tolerance, rtol 1e-4 / atol 1e-3 (f32 sums in another
order).  The kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adc import quantize_lut as ref_quantize
from repro.kernels import ops as jops

from repro_torch.core.adc import QuantizedLUT, dequantize_lut, quantize_lut
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3


def _mk(seed, t, m, cb, c, dsub, code_dtype=np.int32):
    rng = np.random.default_rng(seed)
    res = rng.normal(size=(t, m * dsub)).astype(np.float32)
    books = rng.normal(size=(m, cb, dsub)).astype(np.float32)
    sqn = (books * books).sum(-1)
    codes = rng.integers(0, cb, size=(t, c, m)).astype(code_dtype)
    sizes = rng.integers(1, c + 1, size=(t,)).astype(np.int32)
    return res, books, sqn, codes, sizes


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


LUT_SHAPES = [(7, 8, 64, 4), (32, 16, 256, 8), (130, 8, 256, 16),
              (9, 32, 32, 2)]          # subset of tests/test_kernels.py


@pytest.mark.parametrize("t,m,cb,dsub", LUT_SHAPES)
def test_lut_build_matches_reference(t, m, cb, dsub):
    res, books, sqn, *_ = _mk(0, t, m, cb, 4, dsub)
    want = np.asarray(jops.lut_build(jnp.asarray(res), jnp.asarray(books),
                                     jnp.asarray(sqn)))
    got = ops.lut_build(*_t(res, books, sqn))
    assert got.shape == (t, m, cb) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = ref.lut_build_ref(*_t(res.reshape(t, m, dsub), books, sqn))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("t,m,cb,dsub", LUT_SHAPES)
def test_quantize_lut_bit_equal_on_same_table(t, m, cb, dsub):
    """On the same f32 table the port's quantization is the reference's,
    bit for bit (true divisions, round half to even)."""
    res, books, sqn, *_ = _mk(1, t, m, cb, 4, dsub)
    table = np.asarray(jops.lut_build(jnp.asarray(res), jnp.asarray(books),
                                      jnp.asarray(sqn)))
    want = ref_quantize(jnp.asarray(table))
    got = quantize_lut(torch.from_numpy(table.copy()))
    np.testing.assert_array_equal(got.lut_q.numpy(), np.asarray(want.lut_q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))


def test_quantize_degenerate_subspace_roundtrips_exactly():
    flat = torch.full((1, 4, 16), 3.25)
    q = quantize_lut(flat)
    assert (q.lut_q == 0).all() and (q.scale == 1).all()
    np.testing.assert_array_equal(dequantize_lut(q).numpy(), flat.numpy())


@pytest.mark.parametrize("t,m,cb,dsub", [(30, 16, 256, 8), (7, 8, 64, 4)])
def test_lut_build_q_matches_reference_kernel(t, m, cb, dsub):
    """The reference's own contract for the fused epilogue: |diff| <= 1
    count, boundary flips only."""
    res, books, sqn, *_ = _mk(2, t, m, cb, 4, dsub)
    want = jops.lut_build_q(jnp.asarray(res), jnp.asarray(books),
                            jnp.asarray(sqn))
    got = ops.lut_build_q(*_t(res, books, sqn))
    diff = got.lut_q.numpy().astype(np.int32) - np.asarray(want.lut_q,
                                                           np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 1e-3
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(want.bias),
                               rtol=RTOL, atol=ATOL)


SCAN_SHAPES = [(3, 8, 64, 300), (8, 16, 256, 512), (5, 8, 256, 1000),
               (2, 32, 32, 64)]        # subset of tests/test_kernels.py


@pytest.mark.parametrize("t,m,cb,c", SCAN_SHAPES)
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
def test_pq_scan_dc_matches_reference(t, m, cb, c, code_dtype):
    res, books, sqn, codes, sizes = _mk(3, t, m, cb, c, 4, code_dtype)
    lut = np.asarray(jops.lut_build(jnp.asarray(res), jnp.asarray(books),
                                    jnp.asarray(sqn)))
    want = np.asarray(jops.pq_scan_dc(jnp.asarray(lut), jnp.asarray(codes),
                                      jnp.asarray(sizes), strategy="gather"))
    tl, tc, ts = _t(lut, codes, sizes)
    got = ops.pq_scan_dc(tl, tc, ts).numpy()
    valid = np.arange(c)[None] < sizes[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)
    assert np.isinf(got[~valid]).all() and np.isinf(want[~valid]).all()
    # no sizes: every row valid, both strategies name one function
    for strategy in ("gather", "onehot"):
        full = ops.pq_scan_dc(tl, tc, None, strategy=strategy).numpy()
        np.testing.assert_allclose(
            full, ref.pq_scan_dc_ref(tl, tc).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,m,cb,c", SCAN_SHAPES[:3])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
def test_pq_scan_dc_q_matches_reference(t, m, cb, c, code_dtype):
    """uint8 DC on the same quantized tables: allclose, masked rows +inf."""
    res, books, sqn, codes, sizes = _mk(4, t, m, cb, c, 4, code_dtype)
    sizes[0] = 0
    q = jops.lut_build_q(jnp.asarray(res), jnp.asarray(books),
                         jnp.asarray(sqn))
    want = np.asarray(jops.pq_scan_dc(q, jnp.asarray(codes),
                                      jnp.asarray(sizes), strategy="gather"))
    qt = QuantizedLUT(*_t(q.lut_q, q.scale, q.bias))
    tc, ts = _t(codes, sizes)
    got = ops.pq_scan_dc(qt, tc, ts).numpy()
    valid = np.arange(c)[None] < sizes[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)
    assert np.isinf(got[~valid]).all() and np.isinf(got[0]).all()


TOPK_SHAPES = SCAN_SHAPES + [(4, 8, 64, 5)]      # C < k_pad: short tasks


def _topk_inputs(seed, t, m, cb, c, code_dtype):
    res, books, sqn, codes, sizes = _mk(seed, t, m, cb, c, 4, code_dtype)
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(0, 1 << 20, size=(t, c)).astype(np.int32)
    sizes[0] = 0                                  # a zero-valid task
    return res, books, sqn, codes, ids, sizes


def _assert_topk_matches(gd, gi, wd, wi):
    """Distances allclose with equal +inf masks; ids equal as per-task
    sets, and -1 exactly where the distance is +inf."""
    inf = np.isinf(wd)
    np.testing.assert_array_equal(np.isinf(gd), inf)
    np.testing.assert_allclose(gd[~inf], wd[~inf], rtol=RTOL, atol=ATOL)
    assert (gi[inf] == -1).all() and (gi[~inf] >= 0).all()
    for t in range(gi.shape[0]):
        assert set(gi[t].tolist()) == set(wi[t].tolist())


@pytest.mark.parametrize("t,m,cb,c", TOPK_SHAPES)
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("k", [1, 10])
def test_pq_scan_topk_matches_reference(t, m, cb, c, code_dtype, k):
    """Fused DC+TS (f32 table) against the reference's Pallas kernel in
    interpret mode, zero-valid tasks and C < k_pad included."""
    res, books, sqn, codes, ids, sizes = _topk_inputs(10, t, m, cb, c,
                                                      code_dtype)
    lut = np.asarray(jops.lut_build(jnp.asarray(res), jnp.asarray(books),
                                    jnp.asarray(sqn)))
    wd, wi = jops.pq_scan_topk(jnp.asarray(lut), jnp.asarray(codes),
                               jnp.asarray(ids), jnp.asarray(sizes), k,
                               strategy="gather")
    gd, gi = ops.pq_scan_topk(*_t(lut, codes, ids, sizes), k)
    assert gd.shape == (t, k) and gi.dtype == torch.int32
    _assert_topk_matches(gd.numpy(), gi.numpy(), np.asarray(wd),
                         np.asarray(wi))
    if c >= 16:                                   # the oracle needs C >= k_pad
        od, oi = ref.pq_scan_topk_ref(*_t(lut, codes, ids, sizes), 16)
        _assert_topk_matches(gd.numpy(), gi.numpy(), od[:, :k].numpy(),
                             oi[:, :k].numpy())


@pytest.mark.parametrize("t,m,cb,c", TOPK_SHAPES[:3])
@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
def test_pq_scan_topk_q_matches_reference(t, m, cb, c, code_dtype):
    """Fused DC+TS on the same quantized tables (uint8 path)."""
    res, books, sqn, codes, ids, sizes = _topk_inputs(11, t, m, cb, c,
                                                      code_dtype)
    q = jops.lut_build_q(jnp.asarray(res), jnp.asarray(books),
                         jnp.asarray(sqn))
    wd, wi = jops.pq_scan_topk(q, jnp.asarray(codes), jnp.asarray(ids),
                               jnp.asarray(sizes), 10, strategy="gather")
    qt = QuantizedLUT(*_t(q.lut_q, q.scale, q.bias))
    gd, gi = ops.pq_scan_topk(qt, *_t(codes, ids, sizes), 10)
    _assert_topk_matches(gd.numpy(), gi.numpy(), np.asarray(wd),
                         np.asarray(wi))


def test_pq_scan_topk_rejects_bad_inputs():
    res, books, sqn, codes, ids, sizes = _topk_inputs(12, 4, 4, 16, 32,
                                                      np.uint8)
    lut = ops.lut_build(*_t(res, books, sqn))
    c, i, z = _t(codes, ids, sizes)
    assert ops.pq_scan_topk(lut, c, i, z, ops.MAX_K_PAD)[0].shape == (
        4, ops.MAX_K_PAD)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, c, i, z, ops.MAX_K_PAD + 1)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, c, i, z, 0)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, c, i[:, :-1].contiguous(), z, 4)
    with pytest.raises(TypeError):
        ops.pq_scan_topk(lut, c, i.long(), z, 4)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, c, i, None, 4)
    with pytest.raises(ValueError):
        ops.pq_scan_topk(lut, c, i, z, 4, strategy="bogus")


def _slot_inputs(seed, p, t, m, cb, c, code_dtype):
    """P code slots with ragged sizes (one empty), and T tasks whose slots
    repeat and include -1 (no task)."""
    rng = np.random.default_rng(seed)
    res = rng.normal(size=(t, m * 4)).astype(np.float32)
    books = rng.normal(size=(m, cb, 4)).astype(np.float32)
    sqn = (books * books).sum(-1)
    codes = rng.integers(0, cb, size=(p, c, m)).astype(code_dtype)
    ids = rng.integers(0, 1 << 20, size=(p, c)).astype(np.int32)
    sizes = rng.integers(1, c + 1, size=(p,)).astype(np.int32)
    sizes[1] = 0
    slots = rng.integers(0, p, size=(t,)).astype(np.int32)
    slots[0] = -1
    slots[3] = slots[2]
    slots[4] = 1                                   # the empty slot
    slots[5] = p                                   # out of range: no task
    return res, books, sqn, codes, ids, sizes, slots


def _assert_topk_tie_close(gd, gi, wd, wi):
    """Distances allclose with equal +inf masks, -1 ids exactly at +inf,
    and per-task id sets equal up to ties at the k-th place: an id found
    on one side only sits at that side's k-th distance."""
    inf = np.isinf(wd)
    np.testing.assert_array_equal(np.isinf(gd), inf)
    np.testing.assert_allclose(gd[~inf], wd[~inf], rtol=RTOL, atol=ATOL)
    assert (gi[inf] == -1).all() and (gi[~inf] >= 0).all()
    k = gi.shape[1]
    for t in range(gi.shape[0]):
        a, b = set(gi[t].tolist()), set(wi[t].tolist())
        for ids, d, only in ((gi[t], gd[t], a - b), (wi[t], wd[t], b - a)):
            for j in np.nonzero(np.isin(ids, list(only)))[0]:
                assert np.isclose(d[j], d[k - 1], rtol=RTOL, atol=ATOL), t


@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_pq_scan_topk_slots_match_reference(code_dtype, quantized, k):
    """The slot form (task t reads code slot slots[t] in place) against
    the reference's Pallas kernel (interpret mode) on codes[slots], and
    bit for bit against the port's dense call and the blockwise oracle on
    the gathered inputs: -1, out-of-range and repeated slots, ragged and
    empty sizes."""
    from repro_torch.core.sharded_search import _fused_scan_topk
    p, t, m, cb, c = 5, 12, 8, 64, 300
    res, books, sqn, codes, ids, sizes, slots = _slot_inputs(
        20 + k, p, t, m, cb, c, code_dtype)
    valid = (slots >= 0) & (slots < p)
    s = np.where(valid, slots, 0)
    dense = (codes[s], ids[s], np.where(valid, sizes[s], 0).astype(np.int32))
    if quantized:
        jlut = jops.lut_build_q(jnp.asarray(res), jnp.asarray(books),
                                jnp.asarray(sqn))
        table = QuantizedLUT(*_t(jlut.lut_q, jlut.scale, jlut.bias))
    else:
        jlut = jnp.asarray(np.asarray(jops.lut_build(
            jnp.asarray(res), jnp.asarray(books), jnp.asarray(sqn))))
        table = _t(jlut)[0]
    wd, wi = jops.pq_scan_topk(jlut, *map(jnp.asarray, dense), k,
                               strategy="gather")
    ts = torch.from_numpy(slots)
    gd, gi = ops.pq_scan_topk(table, *_t(codes, ids, sizes), k, slots=ts)
    assert gd.shape == (t, k) and gi.dtype == torch.int32
    _assert_topk_tie_close(gd.numpy(), gi.numpy(), np.asarray(wd),
                           np.asarray(wi))
    assert torch.isinf(gd[0]).all() and bool((gi[0] == -1).all())
    assert torch.isinf(gd[4]).all() and bool((gi[4] == -1).all())
    assert torch.isinf(gd[5]).all() and bool((gi[5] == -1).all())
    dd, di = ops.pq_scan_topk(table, *_t(*dense), k)
    assert torch.equal(gd, dd) and torch.equal(gi, di)
    od, oi = _fused_scan_topk(table, *_t(codes, ids, sizes), k, block=37,
                              slots=ts)
    oi = oi.masked_fill(torch.isinf(od), -1)       # as the steps mask it
    _assert_topk_tie_close(od.numpy(), oi.numpy(), dd.numpy(), di.numpy())


def test_pq_scan_topk_slots_reject_bad_inputs():
    res, books, sqn, codes, ids, sizes, slots = _slot_inputs(
        13, 4, 6, 4, 16, 32, np.uint8)
    lut = ops.lut_build(*_t(res, books, sqn))
    c, i, z, sl = _t(codes, ids, sizes, slots)
    assert ops.pq_scan_topk(lut, c, i, z, 3, slots=sl)[0].shape == (6, 3)
    with pytest.raises(TypeError):
        ops.pq_scan_topk(lut, c, i, z, 3, slots=sl.long())
    with pytest.raises(ValueError):                # one table per task
        ops.pq_scan_topk(lut, c, i, z, 3, slots=sl[:-1].contiguous())
    with pytest.raises(ValueError):                # sizes: one per slot
        ops.pq_scan_topk(lut, c, i, z[:-1].contiguous(), 3, slots=sl)
    with pytest.raises(ValueError):                # ids: (P, C)
        ops.pq_scan_topk(lut, c, i[:-1].contiguous(), z, 3, slots=sl)
    with pytest.raises(ValueError):                # dense form: P == T
        ops.pq_scan_topk(lut, c, i, z, 3)


def _task_table(lut, t):
    """Task t's table alone, as a one-task table of the same kind."""
    if isinstance(lut, QuantizedLUT):
        return QuantizedLUT(lut.lut_q[t:t + 1], lut.scale[t:t + 1],
                            lut.bias[t:t + 1])
    return lut[t:t + 1]


@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("kind", ["f32", "u8", "bf16"])
def test_pq_scan_dc_slots_equal_dense_on_gathered_copy(code_dtype, kind):
    """DC's slot form (task t reads code slot slots[t] in place) equals
    the dense call on ``gather_slots``' copy bit for bit, for f32, u8 and
    bf16 tables: slots that repeat, are -1, fall past P, or hold no rows.
    Each task's row also equals a one-task dense call on its own slot."""
    p, t, m, cb, c = 5, 12, 8, 64, 300
    res, books, sqn, codes, _, sizes, slots = _slot_inputs(
        40, p, t, m, cb, c, code_dtype)
    slots[7] = -3
    build = {"f32": ops.lut_build, "u8": ops.lut_build_q,
             "bf16": ops.lut_build_bf16}[kind]
    lut = build(*_t(res, books, sqn))
    tc, tz, ts = _t(codes, sizes, slots)
    got = ops.pq_scan_dc(lut, tc, tz, slots=ts)
    assert got.shape == (t, c) and got.dtype == torch.float32
    dc, none, dz = ops.gather_slots(tc, None, tz, ts)
    assert none is None
    assert torch.equal(got, ops.pq_scan_dc(lut, dc, dz))
    for task, slot in enumerate(slots.tolist()):
        if 0 <= slot < p:
            want = ops.pq_scan_dc(_task_table(lut, task), tc[slot:slot + 1],
                                  tz[slot:slot + 1])[0]
            assert torch.equal(got[task], want), task
        else:
            assert bool(torch.isinf(got[task]).all()), task
    assert bool(torch.isinf(got[4]).all())        # the empty slot


def test_pq_scan_dc_slots_reject_bad_inputs():
    res, books, sqn, codes, _, sizes, slots = _slot_inputs(
        41, 4, 6, 4, 16, 32, np.uint8)
    lut = ops.lut_build(*_t(res, books, sqn))
    c, z, sl = _t(codes, sizes, slots)
    assert ops.pq_scan_dc(lut, c, z, slots=sl).shape == (6, 32)
    with pytest.raises(TypeError):                 # slots: int32
        ops.pq_scan_dc(lut, c, z, slots=sl.long())
    with pytest.raises(ValueError):                # slots: (T,)
        ops.pq_scan_dc(lut, c, z, slots=sl.view(2, 3))
    with pytest.raises(ValueError):                # one table per task
        ops.pq_scan_dc(lut, c, z, slots=sl[:-1].contiguous())
    with pytest.raises(ValueError):                # sizes: one per slot
        ops.pq_scan_dc(lut, c, z[:-1].contiguous(), slots=sl)
    with pytest.raises(ValueError):                # slots need sizes
        ops.pq_scan_dc(lut, c, None, slots=sl)


def test_wrappers_reject_bad_inputs():
    res, books, sqn, codes, sizes = _mk(5, 4, 4, 16, 32, 2)
    r, b, s, c, z = _t(res, books, sqn, codes, sizes)
    with pytest.raises(TypeError):
        ops.lut_build(r.double(), b, s)
    with pytest.raises(ValueError):
        ops.lut_build(r[:, :-1], b, s)
    with pytest.raises(ValueError):
        ops.lut_build(r.T.contiguous().T, b, s)            # not contiguous
    lut = ops.lut_build(r, b, s)
    with pytest.raises(TypeError):
        ops.pq_scan_dc(lut, c.long(), z)
    with pytest.raises(TypeError):
        ops.pq_scan_dc(lut, c, z.long())
    with pytest.raises(ValueError):
        ops.pq_scan_dc(lut, c, z[:2])
    with pytest.raises(ValueError):
        ops.pq_scan_dc(lut, c, z, strategy="bogus")


def test_cpu_runs_do_not_count_as_launches():
    ops.reset_launches()
    res, books, sqn, codes, sizes = _mk(6, 4, 4, 16, 32, 2)
    r, b, s, c, z = _t(res, books, sqn, codes, sizes)
    ops.pq_scan_dc(ops.lut_build(r, b, s), c, z)
    ops.pq_scan_dc(ops.lut_build_q(r, b, s), c, z)
    ids = torch.arange(c.shape[0] * c.shape[1], dtype=torch.int32)
    ops.pq_scan_topk(ops.lut_build(r, b, s), c, ids.view(c.shape[:2]), z, 3)
    assert all(v == 0 for v in ops.launches.values())
