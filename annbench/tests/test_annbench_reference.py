"""The reference against the program on a tiny drawn index, the control
(the reference one precision down in the program's place) failing the
check, and runs with the timed path broken underneath coming out not
correct."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from annbench import calibrate, harness  # noqa: E402
from annbench.reference import Reference  # noqa: E402
from annbench.reference import tf32 as reference_tf32  # noqa: E402
from annbench.tests import tiny  # noqa: E402
from repro_torch.core.ivf import IVFPQIndex, pad_clusters  # noqa: E402
from repro_torch.core.pq import PQCodebook  # noqa: E402
from repro_torch.core.search import SearchParams, search_ivfpq  # noqa: E402
from repro_torch.runtime.serving import LocalEngine  # noqa: E402

data = harness.plugin("draws", "ivfpq")
judge = harness.plugin("checks", "exact_ivfpq")
NO_MIX = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def cfg(root):
    return harness.load_cell("tiny.tbatch", root).config


def _port(index, q, cfg):
    books = index.codebooks
    ivf = IVFPQIndex(index.centroids, PQCodebook(books, (books * books)
                                                 .sum(-1)),
                     index.codes, index.ids, index.offsets)
    svc = cfg["service"]
    d, i = search_ivfpq(ivf, pad_clusters(ivf), q,
                        SearchParams(nprobe=svc["nprobe"], k=svc["k"],
                                     use_kernels=True))
    return d.numpy(), i.numpy()


def _nk(cfg):
    return cfg["service"]["nprobe"], cfg["service"]["k"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 2 ** 40 + 11])
def test_port_agrees_with_the_reference(cfg, seed):
    index, g = data.draw_index(cfg, seed, "cpu")
    q = data.draw_queries(cfg, NO_MIX, index, g, 200)
    d, i = _port(index, q, cfg)
    ref = Reference(index, *_nk(cfg))
    gaps = judge.gaps(ref, q, d, i)
    assert gaps["dist_gap"] < 1e-6 and gaps["id_gap"] < 1e-6
    r = ref.search(q)
    # the answers are the reference's, ids included, where it is exact
    ex = r.exact.numpy()
    assert np.allclose(np.sort(d, 1)[ex], r.low.numpy()[ex], rtol=1e-5)


def test_same_seed_same_inputs(cfg):
    a, ga = data.draw_index(cfg, 77, "cpu")
    b, gb = data.draw_index(cfg, 77, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(data.draw_queries(cfg, NO_MIX, a, ga, 10),
                       data.draw_queries(cfg, NO_MIX, b, gb, 10))
    assert sorted(a.sizes.tolist()) == sorted(
        data.draw_index(cfg, 78, "cpu")[0].sizes.tolist())
    assert int(a.sizes.sum()) == cfg["n_points"]
    assert sorted(a.ids.tolist()) == list(range(cfg["n_points"]))


def test_cluster_zipf_skews_the_queries(cfg):
    flat = dict(cfg, assumed=dict(cfg["assumed"], query_noise_std=0.0))
    index, g = data.draw_index(flat, 5, "cpu")
    counts = {}
    for mix in (NO_MIX, {"cluster_zipf": 2.0}):
        q = data.draw_queries(flat, mix, index, g, 2000)
        counts[len(mix)] = torch.unique(q, dim=0, return_counts=True)[1]
    # rank 1 of Zipf(2) over 64 clusters draws ~0.61 of the queries
    assert int(counts[1].max()) > 0.5 * 2000
    assert int(counts[0].max()) < 0.1 * 2000


def test_size_multiset_spread():
    s = data.size_multiset(100_000_000, 65_536, 0.337)
    assert int(s.sum()) == 100_000_000
    assert float(s.max()) / float(s.float().mean()) == pytest.approx(4.06,
                                                                     abs=0.01)


def test_probe_band_takes_either_of_a_tie(cfg):
    """Two equal centroids at the nprobe-th place: both are admissible,
    and an answer over either is judged correct."""
    index, g = data.draw_index(cfg, 5, "cpu")
    q = data.draw_queries(cfg, NO_MIX, index, g, 1)
    ref = Reference(index, *_nk(cfg))
    nprobe = cfg["service"]["nprobe"]
    order = torch.argsort(((index.centroids - q) ** 2).sum(1))
    cen = index.centroids.clone()
    cen[order[nprobe]] = cen[order[nprobe - 1]]
    index = index._replace(centroids=cen)
    ref = Reference(index, *_nk(cfg))
    certain, band = ref.probes(q.double())[0]
    assert len(certain) == nprobe - 1 and len(band) == 2
    d, i = _port(index, q, cfg)
    assert judge.gaps(ref, q, d, i)["dist_gap"] < 1e-6


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_control_fails_the_check(root, cfg, precision):
    cell = harness.load_cell("tiny.tbatch", root)
    got = calibrate.control_readings(cell, 9, [precision], "cpu",
                                     seconds=0.5)
    assert got[0]["dist_gap"] > 10 * cfg["check"]["dist_gap"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3])
    got = reference_tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                -1.0]
    assert abs(got[5] - x[5]) <= x[5] * 2 ** -11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_controls_fail_the_check_on_the_card(root, cfg, cuda):
    cell = harness.load_cell("tiny.tbatch", root)
    big = dict(cell.config, n_points=400_000, dim=96,
               service=dict(cell.config["service"], nprobe=32,
                            index={"nlist": 1024, "m": 16, "cb": 256}))
    cell = harness.Cell(cell.name, big, cell.traffic, 1, [], [], cell.draw,
                        cell.kind, cell.check)
    for got in calibrate.control_readings(cell, 9, ["tf32", "bf16"], cuda,
                                          seconds=0.5):
        assert got["dist_gap"] > 10 * cfg["check"]["dist_gap"]


def _broken(monkeypatch, how):
    real = LocalEngine.search_batch

    def search_batch(self, queries, *a, **kw):
        d, i = real(self, queries, *a, **kw)
        d, i = d.copy(), i.copy()
        if how == "half":            # half the batch left out
            h = (len(d) + 1) // 2
            d[h:], i[h:] = d[:len(d) - h], i[:len(d) - h]
        else:                        # one answer altered where produced
            i[:, -1] = (i[:, -1] + 1) % int(i.max() + 1)
        return d, i
    monkeypatch.setattr(LocalEngine, "search_batch", search_batch)


@pytest.mark.parametrize("how", ["half", "altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, how):
    assert tiny.run(root, "tiny.tbatch", seconds=0.3)["correct"] is True
    _broken(monkeypatch, how)
    out = tiny.run(root, "tiny.tbatch", seconds=0.3)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())
