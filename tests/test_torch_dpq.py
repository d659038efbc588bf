"""Port parity for DPQ (differentiable PQ): the soft assignment, the
straight-through reconstruction, the loss's gradient and the Adam steps
equal the reference's on the same inputs; the reference's training
contracts are held on the port's own ``train_dpq`` (the cold start's on
the reference's own draw, see its test); a reference DPQ codebook in a
reference-built index searches as the reference does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchParams as RefParams
from repro.core import dpq as jdpq
from repro.core import pad_clusters as ref_pad
from repro.core import search_ivfpq as ref_search
from repro.core.kmeans import l2_sq as ref_l2
from repro.core.pq import (encode_pq as ref_encode,
                           split_subvectors as ref_split,
                           train_pq as ref_train_pq)

from repro_torch.convert import clusters_from_numpy, index_from_numpy
from repro_torch.core import (SearchParams, decode_pq, encode_pq,
                              recall_at_k, search_ivfpq, train_dpq, train_pq)
from repro_torch.core import dpq as tdpq

torch.set_num_threads(1)
K = 10


@pytest.fixture(scope="module")
def ref_problem():
    """The reference's sub, warm-start books0 and temperature (N(0, 5)
    residuals, N=1000, D=32, M=8, CB=32)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(0, 5, size=(1000, 32)).astype(np.float32))
    sub = ref_split(x, 8)
    books0 = ref_train_pq(jax.random.PRNGKey(3), x, m=8, cb=32,
                          iters=4).codebooks
    d0 = jax.vmap(ref_l2, in_axes=(1, 0), out_axes=1)(sub[:512], books0)
    temp = jnp.mean(d0)
    return sub, books0, temp


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ref_loss(sub, temp):
    def loss(books):
        recon = jdpq._st_reconstruct(sub, books, temp)
        return jnp.mean(jnp.sum((sub - recon) ** 2, axis=(1, 2)))
    return loss


def test_forward_matches_reference(ref_problem):
    sub, books0, temp = ref_problem
    soft = tdpq._soft_assign(_t(sub), _t(books0), _t(temp))
    np.testing.assert_allclose(soft.numpy(),
                               np.asarray(jdpq._soft_assign(sub, books0,
                                                            temp)),
                               rtol=1e-5, atol=1e-6)
    recon = tdpq._st_reconstruct(_t(sub), _t(books0), _t(temp))
    np.testing.assert_allclose(recon.numpy(),
                               np.asarray(jdpq._st_reconstruct(sub, books0,
                                                               temp)),
                               rtol=1e-5, atol=1e-6)
    # the same temperature from the port's own l2 expansion
    t_port = tdpq._sub_dists(_t(sub[:512]), _t(books0)).mean()
    np.testing.assert_allclose(float(t_port), float(temp), rtol=1e-5)


def test_gradient_matches_jax_grad(ref_problem):
    sub, books0, temp = ref_problem
    loss_ref, g_ref = jax.value_and_grad(_ref_loss(sub, temp))(books0)
    books = _t(books0).requires_grad_(True)
    loss = tdpq._loss(books, _t(sub), _t(temp))
    (g,) = torch.autograd.grad(loss, books)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-6)


def test_gradient_matches_jax_where_codewords_equal_rows():
    """The cold start draws codewords from the data, so some distances
    are exactly 0 at the clamp (integer data: the expansion is exact).
    ``jnp.maximum`` splits a tie's gradient in half and ``clamp_min``
    does not, but such a row reconstructs itself, so no gradient flows
    through it in either package; the rest matches."""
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, size=(64, 8)).astype(np.float32)
    sub = x.reshape(64, 2, 4)
    books0 = np.ascontiguousarray(sub[:8].transpose(1, 0, 2))
    temp = np.float32(2.0)
    _, g_ref = jax.value_and_grad(_ref_loss(jnp.asarray(sub),
                                            jnp.float32(temp)))(
        jnp.asarray(books0))
    books = torch.from_numpy(books0.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(tdpq._loss(books, torch.from_numpy(sub),
                                          torch.tensor(temp)), books)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-6)


def test_twenty_adam_steps_match_reference(ref_problem):
    """20 steps from the reference's books0 and temp.  Hard assignments
    of the final books are compared too: a flip on a near-tie would
    move the loss; none occurs on these inputs (0 flips), so the losses
    and books hold at rtol 1e-4."""
    sub, books0, temp = ref_problem
    steps, lr = 20, 0.5
    books_ref, losses_ref = jdpq._train(books0, sub, temp, jnp.float32(lr),
                                        steps)
    books, losses = tdpq._train(_t(books0), _t(sub), _t(temp),
                                torch.tensor(lr), steps)
    assert losses.shape == (steps,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_ref),
                               rtol=1e-4)
    np.testing.assert_allclose(books.numpy(), np.asarray(books_ref),
                               rtol=1e-4, atol=1e-4)
    hard_ref = np.asarray(jnp.argmax(jdpq._soft_assign(sub, books_ref, temp),
                                     -1))
    hard = tdpq._soft_assign(_t(sub), books, _t(temp)).argmax(-1).numpy()
    flips = int((hard != hard_ref).sum())
    assert flips == 0, f"{flips} hard assignments flipped"


def test_adam_is_the_references_not_torch_optim():
    """One step by hand: beta1 0.9, beta2 0.99, bias correction at t=1,
    so the first update is lr * sign(g) (up to the 1e-8)."""
    rng = np.random.default_rng(7)
    sub = torch.from_numpy(rng.normal(0, 2, size=(200, 4, 2)).astype(
        np.float32))
    books0 = sub[:16].transpose(0, 1).contiguous()
    temp = torch.tensor(3.0)
    books, _ = tdpq._train(books0, sub, temp, torch.tensor(0.5), 1)
    b = books0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tdpq._loss(b, sub, temp), b)
    moved = g.abs() > 1e-4             # where the 1e-8 is negligible
    torch.testing.assert_close((books0 - books)[moved],
                               0.5 * torch.sign(g)[moved], rtol=1e-5,
                               atol=1e-5)


def _recon_err(cb, res):
    recon = decode_pq(cb, encode_pq(cb, res))
    return float(((res - recon) ** 2).sum(-1).mean())


def test_dpq_improves_over_warmstart():
    """tests/test_dpq.py's contract on the port's own training."""
    rng = np.random.default_rng(0)
    res = torch.from_numpy(rng.normal(0, 5, size=(2000, 32)).astype(
        np.float32))
    warm = train_pq(res, m=8, cb=32, iters=4,
                    generator=torch.Generator().manual_seed(0))
    dpq, losses = train_dpq(torch.Generator().manual_seed(0), res, m=8,
                            cb=32, steps=200)
    assert losses.shape == (200,)
    assert float(losses[-1]) < float(losses[0])
    assert _recon_err(dpq, res) < _recon_err(warm, res) * 1.02


def test_dpq_cold_start_trains():
    """tests/test_dpq.py's cold-start contract, loss[-1] < 0.7 loss[0],
    is a property of the draw: training from any draw ends near the same
    loss (46.7-47.1 here in both packages), while the first loss is the
    draw's.  The reference meets it with key 2 (0.686) but not with keys
    0, 1, 3 or 4 (0.710-0.745); the port's own draw with seed 2 gives
    0.737.  So the contract is held on the reference's own draw, carried
    across, and the port's own cold start ends within 1% of the
    reference's final loss on the same data."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, size=(1500, 16)).astype(np.float32)
    _, ref_losses = jdpq.train_dpq(jax.random.PRNGKey(2), jnp.asarray(x),
                                   m=4, cb=16, steps=250,
                                   kmeans_warmstart=False)
    # the reference's draw and temperature (train_dpq's cold branch)
    sub = ref_split(jnp.asarray(x), 4)
    idx = jax.random.choice(jax.random.PRNGKey(2), 1500, shape=(16,),
                            replace=False)
    books0 = sub[idx].transpose(1, 0, 2)
    temp = jnp.mean(jax.vmap(ref_l2, in_axes=(1, 0), out_axes=1)(
        sub[:512], books0))
    _, losses = tdpq._train(_t(books0), _t(sub), _t(temp),
                            torch.tensor(0.5), 250)
    np.testing.assert_allclose(float(losses[0]), float(ref_losses[0]),
                               rtol=1e-5)
    assert float(losses[-1]) < 0.7 * float(losses[0])
    dpq, own = train_dpq(torch.Generator().manual_seed(2), torch.from_numpy(x),
                         m=4, cb=16, steps=250, kmeans_warmstart=False)
    assert float(own[-1]) < float(own[0])
    assert abs(float(own[-1]) - float(ref_losses[-1])) <= 0.01 * float(
        ref_losses[-1])
    assert dpq.codebooks.shape == (4, 16, 4)
    torch.testing.assert_close(dpq.sqnorms, (dpq.codebooks ** 2).sum(-1))


@pytest.fixture(scope="module")
def ref_dpq_index(small_corpus, small_index):
    """The conftest's reference index with a reference-trained DPQ
    codebook (30 steps on 2,000 of its residuals) and its codes
    re-encoded: ``IVFPQIndex._replace``, then ``pad_clusters``."""
    idx = small_index
    offsets = np.asarray(idx.offsets)
    rows = np.arange(offsets[-1])
    cluster_of = np.searchsorted(offsets, rows, side="right") - 1
    pts = np.asarray(small_corpus.points, np.float32)[np.asarray(idx.ids)]
    res = jnp.asarray(pts - np.asarray(idx.centroids)[cluster_of])
    sel = np.random.default_rng(11).choice(len(rows), 2000, replace=False)
    dpq, losses = jdpq.train_dpq(jax.random.PRNGKey(11), res[sel], m=16,
                                 cb=256, steps=30)
    assert float(losses[-1]) < float(losses[0])
    new = idx._replace(codebook=dpq, codes=ref_encode(dpq, res))
    return new, ref_pad(new)


@pytest.mark.parametrize("nprobe", [4, 16])
def test_dpq_index_search_matches_reference(ref_dpq_index, small_corpus,
                                            nprobe):
    from test_torch_search import assert_same_neighbours
    ridx, rcl = ref_dpq_index
    idx = index_from_numpy(ridx.centroids, ridx.codebook.codebooks,
                           ridx.codebook.sqnorms, ridx.codes, ridx.ids,
                           ridx.offsets, device="cpu")
    cl = clusters_from_numpy(rcl.codes, rcl.ids, rcl.sizes, device="cpu")
    q = np.array(small_corpus.queries)
    rd, ri = ref_search(ridx, rcl, small_corpus.queries,
                        RefParams(nprobe=nprobe, k=K + 1, query_chunk=32))
    rd, ri = np.asarray(rd), np.asarray(ri)
    for use_kernels in (False, True):
        pd, pi = search_ivfpq(idx, cl, torch.from_numpy(q),
                              SearchParams(nprobe=nprobe, k=K,
                                           query_chunk=24,
                                           use_kernels=use_kernels))
        np.testing.assert_allclose(pd.numpy(), rd[:, :K], rtol=1e-4,
                                   atol=1e-3)
        assert_same_neighbours(pd.numpy(), pi.numpy(), rd, ri)
    # uint8 LUTs: recall within 0.01 of the reference's
    gt = torch.from_numpy(np.array(small_corpus.groundtruth))
    _, ri8 = ref_search(ridx, rcl, small_corpus.queries,
                        RefParams(nprobe=nprobe, k=K, query_chunk=32,
                                  lut_dtype="uint8"))
    _, pi8 = search_ivfpq(idx, cl, torch.from_numpy(q),
                          SearchParams(nprobe=nprobe, k=K, query_chunk=24,
                                       use_kernels=True, lut_dtype="uint8"))
    r_ref = recall_at_k(torch.from_numpy(np.array(ri8)), gt)
    assert abs(recall_at_k(pi8, gt) - r_ref) <= 0.01
