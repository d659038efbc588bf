"""Port parity for the multiplier-less path (paper §III-A): the square
table, the quantizers, the integer LUT and the integer scan equal the
reference's bit for bit on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiplierless as jml
from repro.core.adc import build_lut as ref_build_lut
from repro.core.adc import scan_codes as ref_scan_codes
from repro.core.pq import encode_pq as ref_encode, train_pq as ref_train_pq

from repro_torch.convert import quantized_codebook_from_numpy
from repro_torch.core import PQCodebook, build_lut, encode_pq, scan_codes
from repro_torch.core import multiplierless as tml

torch.set_num_threads(1)

SCALES = (0.05, 0.1, 1.0)


@pytest.fixture(scope="module")
def ref_cb_and_residual():
    """tests/test_adc.py's fixture: the reference's PQ over N(0, 5)."""
    rng = np.random.default_rng(0)
    res = jnp.asarray(rng.normal(0, 5, size=(2000, 32)).astype(np.float32))
    cb = ref_train_pq(jax.random.PRNGKey(0), res, m=8, cb=64, iters=6)
    return cb, res


def _port_cb(cb) -> PQCodebook:
    return PQCodebook(torch.from_numpy(np.array(cb.codebooks)),
                      torch.from_numpy(np.array(cb.sqnorms)))


def _boundary_values(scale: float, n: int = 64) -> np.ndarray:
    """f32 values x with x / scale (IEEE f32) exactly on k + 0.5, both
    signs, plus their neighbours one ulp away."""
    s = np.float32(scale)
    out = []
    for k in range(-n, n):
        x = np.float32((k + 0.5) * float(s))
        for _ in range(8):               # walk to an exact .5 quotient
            q = np.float32(x / s)
            if q == np.float32(k + 0.5):
                out += [x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))]
                break
            x = np.nextafter(x, np.float32(np.inf if q < k + 0.5
                                           else -np.inf))
    vals = np.array(out, np.float32)
    assert (np.float32(vals[::3]) / s == np.floor(vals[::3] / s) + 0.5).all()
    return vals


@pytest.mark.parametrize("bits", [8, 9])
def test_square_lut_exact(bits):
    vmax = (1 << bits) - 1
    want = np.asarray(jml.make_square_lut(bits))
    got = tml.make_square_lut(bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    v = np.arange(-vmax, vmax + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        tml.square_via_lut(torch.from_numpy(v), got).numpy(),
        np.asarray(jml.square_via_lut(jnp.asarray(v), jnp.asarray(want))))
    np.testing.assert_array_equal(got.numpy()[v + vmax], v.astype(np.int64)
                                  ** 2)


@pytest.mark.parametrize("scale", SCALES)
def test_quantize_codebook_bit_equal(ref_cb_and_residual, scale):
    cb, _ = ref_cb_and_residual
    books = np.array(cb.codebooks)
    # put boundary values into the first rows of the codebook
    edge = _boundary_values(scale)
    flat = books.reshape(-1)
    flat[:len(edge)] = edge[:len(flat)]
    ref_q = jml.quantize_codebook(
        cb._replace(codebooks=jnp.asarray(books)), scale)
    got = tml.quantize_codebook(
        PQCodebook(torch.from_numpy(books), torch.zeros(1)), scale)
    assert got.codebooks_q.dtype == torch.int32
    np.testing.assert_array_equal(got.codebooks_q.numpy(),
                                  np.asarray(ref_q.codebooks_q))
    assert got.scale.dtype == torch.float32 and got.scale.dim() == 0
    assert float(got.scale) == float(ref_q.scale)
    np.testing.assert_array_equal(got.sq.numpy(), np.asarray(ref_q.sq))


@pytest.mark.parametrize("scale", SCALES)
def test_quantize_residual_bit_equal(ref_cb_and_residual, scale):
    """Half-way quotients round to even in both packages; the batched
    (..., D) call equals the reference row by row."""
    _, res = ref_cb_and_residual
    rows = np.array(res[:40])
    edge = _boundary_values(scale)
    rows.reshape(-1)[:len(edge)] = edge[:rows.size]
    got = tml.quantize_residual(torch.from_numpy(rows), scale).numpy()
    assert got.dtype == np.int32
    want = np.stack([np.asarray(jml.quantize_residual(
        jnp.asarray(r), jnp.float32(scale))) for r in rows])
    np.testing.assert_array_equal(got, want)
    # a .5 quotient rounds to the even neighbour
    q = np.float32(edge[0]) / np.float32(scale)
    assert got.reshape(-1)[0] == np.clip(np.round(q), -255, 255)


@pytest.mark.parametrize("scale", SCALES)
def test_multiplierless_lut_bit_equal_and_lossless(ref_cb_and_residual,
                                                   scale):
    cb, res = ref_cb_and_residual
    ref_q = jml.quantize_codebook(cb, scale)
    qcb = tml.quantize_codebook(_port_cb(cb), scale)
    for i in range(8):
        rq_ref = jml.quantize_residual(res[i], ref_q.scale)
        rq = tml.quantize_residual(torch.from_numpy(np.array(res[i])),
                                   qcb.scale)
        np.testing.assert_array_equal(rq.numpy(), np.asarray(rq_ref))
        got = tml.build_lut_multiplierless(qcb, rq)
        assert got.dtype == torch.int32 and got.shape == (8, 64)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jml.build_lut_multiplierless(ref_q,
                                                                 rq_ref)))
        np.testing.assert_array_equal(                   # lossless
            got.numpy(), tml.build_lut_int_reference(qcb, rq).numpy())
        np.testing.assert_array_equal(
            tml.build_lut_int_reference(qcb, rq).numpy(),
            np.asarray(jml.build_lut_int_reference(ref_q, rq_ref)))


@pytest.mark.parametrize("lead", [(12,), (3, 4)])
def test_batched_lut_equals_stacked_calls(ref_cb_and_residual, lead):
    cb, res = ref_cb_and_residual
    qcb = tml.quantize_codebook(_port_cb(cb), 0.1)
    n = int(np.prod(lead))
    rq = tml.quantize_residual(torch.from_numpy(np.array(res[:n])),
                               qcb.scale)
    for fn in (tml.build_lut_multiplierless, tml.build_lut_int_reference):
        got = fn(qcb, rq.reshape(*lead, -1))
        assert got.shape == (*lead, 8, 64)
        want = torch.stack([fn(qcb, r) for r in rq])
        assert torch.equal(got.reshape(n, 8, 64), want)


@pytest.mark.parametrize("cbn", [64, 512])
def test_scan_codes_int_bit_equal(cbn):
    """uint8 codes (a uint8 index would be a boolean mask, not a gather)
    and CB = 512, where the reference's codes are uint16 and the port's
    int32; the batched (T, C, M) scan equals the per-task calls."""
    rng = np.random.default_rng(cbn)
    m, c, t = 8, 300, 5
    luts = rng.integers(0, 2_000_000, size=(t, m, cbn)).astype(np.int32)
    codes = rng.integers(0, cbn, size=(t, c, m))
    ref_dtype, port_dtype = ((np.uint8, torch.uint8) if cbn <= 256
                             else (np.uint16, torch.int32))
    got = tml.scan_codes_int(torch.from_numpy(luts),
                             torch.from_numpy(codes).to(port_dtype))
    assert got.dtype == torch.int32 and got.shape == (t, c)
    for i in range(t):
        want = np.asarray(jml.scan_codes_int(
            jnp.asarray(luts[i]), jnp.asarray(codes[i].astype(ref_dtype))))
        one = tml.scan_codes_int(torch.from_numpy(luts[i]),
                                 torch.from_numpy(codes[i]).to(port_dtype))
        np.testing.assert_array_equal(one.numpy(), want)
        np.testing.assert_array_equal(got[i].numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(
            luts[:, None, :, :], codes[..., None], -1)[..., 0].sum(-1))


def test_scan_codes_int_on_encoded_codes(ref_cb_and_residual):
    """On the reference's own uint8 codes, with its integer table."""
    cb, res = ref_cb_and_residual
    codes = np.array(ref_encode(cb, res[:512]))
    assert codes.dtype == np.uint8
    ref_q = jml.quantize_codebook(cb, 0.05)
    lut_ref = jml.build_lut_multiplierless(
        ref_q, jml.quantize_residual(res[1000], ref_q.scale))
    got = tml.scan_codes_int(torch.from_numpy(np.array(lut_ref)),
                             torch.from_numpy(codes))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jml.scan_codes_int(lut_ref, codes)))


def test_multiplierless_ranking_matches_float(ref_cb_and_residual):
    """tests/test_adc.py's floor on the port: at scale 0.05 the integer
    scan's nearest code equals the float scan's on >= 13 of 16 rows, and
    on the same rows as the reference's."""
    cb, res = ref_cb_and_residual
    pcb = _port_cb(cb)
    res_t = torch.from_numpy(np.array(res))
    codes = encode_pq(pcb, res_t[:512])
    qcb = tml.quantize_codebook(pcb, 0.05)
    ref_q = jml.quantize_codebook(cb, 0.05)
    ref_codes = ref_encode(cb, res[:512])
    agree, agree_ref = [], []
    for i in range(16):
        r = res_t[1000 + i]
        nn_f = int(torch.argmin(scan_codes(build_lut(pcb, r)[None],
                                           codes[None])[0]))
        lut_i = tml.build_lut_multiplierless(qcb,
                                             tml.quantize_residual(r,
                                                                   qcb.scale))
        nn_i = int(torch.argmin(tml.scan_codes_int(lut_i, codes)))
        agree.append(nn_f == nn_i)
        rr = res[1000 + i]
        nf = int(jnp.argmin(ref_scan_codes(ref_build_lut(cb, rr),
                                           ref_codes)))
        ni = int(jnp.argmin(jml.scan_codes_int(
            jml.build_lut_multiplierless(
                ref_q, jml.quantize_residual(rr, ref_q.scale)), ref_codes)))
        agree_ref.append(nf == ni)
    assert sum(agree) >= 13
    assert np.array_equal(codes.numpy(), np.asarray(ref_codes))
    assert agree == agree_ref


@pytest.mark.parametrize("scale", SCALES)
def test_converted_quantized_codebook_gives_reference_tables(
        ref_cb_and_residual, scale):
    cb, res = ref_cb_and_residual
    ref_q = jml.quantize_codebook(cb, scale)
    qcb = quantized_codebook_from_numpy(np.asarray(ref_q.codebooks_q),
                                        np.asarray(ref_q.scale),
                                        np.asarray(ref_q.sq), device="cpu")
    assert qcb.scale.dim() == 0 and qcb.codebooks_q.dtype == torch.int32
    rows = torch.from_numpy(np.array(res[:16]))
    luts = tml.build_lut_multiplierless(
        qcb, tml.quantize_residual(rows, qcb.scale))
    for i in range(16):
        want = jml.build_lut_multiplierless(
            ref_q, jml.quantize_residual(res[i], ref_q.scale))
        np.testing.assert_array_equal(luts[i].numpy(), np.asarray(want))


def test_int_pad_is_above_every_distance():
    """The docstring's bound: D=128, M=16, dsub 8, 8-bit operands."""
    worst = 8 * 510 ** 2
    assert worst == 2_080_800 and 16 * worst < tml.INT_PAD
    qcb = tml.QuantizedCodebook(torch.full((16, 2, 8), -255, dtype=torch.int32),
                                torch.tensor(1.0), tml.make_square_lut(9))
    lut = tml.build_lut_multiplierless(qcb, torch.full((128,), 255,
                                                       dtype=torch.int32))
    assert int(lut.max()) == worst
    dist = tml.scan_codes_int(lut, torch.zeros((1, 16), dtype=torch.uint8))
    assert int(dist[0]) == 16 * worst
