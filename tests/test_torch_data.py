"""Port parity: the numpy-seeded corpus and arrival-trace generators give
the reference's bits."""

import numpy as np
import pytest
import torch

from repro.data import make_clustered_corpus as ref_corpus
from repro.data import make_query_stream as ref_stream
from repro.core import recall_at_k as ref_recall
import jax.numpy as jnp

from repro_torch.data import make_clustered_corpus, make_query_stream
from repro_torch.data import vectors as port_vectors

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,ref_dtype", [(torch.uint8, jnp.uint8),
                                             (torch.float32, jnp.float32)])
@pytest.mark.parametrize("row_chunk", [None, 999])
def test_corpus_bit_equal(monkeypatch, dtype, ref_dtype, row_chunk):
    """Same seed -> the same points and queries, bit for bit, also when
    the points are drawn in row chunks that do not divide N."""
    if row_chunk is not None:
        monkeypatch.setattr(port_vectors, "_ROW_CHUNK", row_chunk)
    kw = dict(n_queries=40, n_components=16, size_skew=1.5)
    ref = ref_corpus(3, 5000, 24, dtype=ref_dtype, **kw)
    got = make_clustered_corpus(3, 5000, 24, dtype=dtype, device="cpu", **kw)
    assert got.points.dtype == dtype
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(got.queries.numpy(),
                                  np.asarray(ref.queries))


def test_corpus_groundtruth_matches_reference():
    """k_gt uses the port's own exact_search; integer data can tie, so
    the neighbour sets are held to recall, not order."""
    ref = ref_corpus(0, 4000, 16, n_queries=32, n_components=8, k_gt=10)
    got = make_clustered_corpus(0, 4000, 16, n_queries=32, n_components=8,
                                k_gt=10, device="cpu")
    assert got.groundtruth.shape == (32, 10)
    r = float(ref_recall(jnp.asarray(got.groundtruth.numpy()),
                         ref.groundtruth))
    assert r >= 0.99, r


@pytest.mark.parametrize("poisson", [True, False])
@pytest.mark.parametrize("skew", [None, 1.1])
def test_query_stream_bit_equal(poisson, skew):
    pool = np.random.default_rng(1).normal(size=(50, 8)).astype(np.float32)
    ref = ref_stream(pool, 200, 500.0, skew=skew, seed=7, poisson=poisson)
    got = make_query_stream(pool, 200, 500.0, skew=skew, seed=7,
                            poisson=poisson)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_query_stream_rejects_bad_rate():
    with pytest.raises(ValueError):
        make_query_stream(np.zeros((2, 2)), 3, 0.0)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_clustered_corpus(0, 100, 8)
