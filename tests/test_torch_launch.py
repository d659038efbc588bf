"""The port's ANN entry points against the reference's: ``python -m
repro_torch.launch.serve --ann`` on both clocks, from a deploy file the
reference saved, and under the auto-tuner, gives the reference's exit
code and the same ``[ann]`` lines (latencies aside; on the virtual clock
the router's picks and the tuner's shortlist and winner exactly), and
what it serves equals a direct search; ``main`` exits 0, runs the LM
modes (``--arch``, and ``--ann --arch`` over a context-reading arch) and
exits as the reference does on the rest; the two examples run on the
CPU."""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.service import IndexSpec as RefIndexSpec
from repro.service import ServiceSpec as RefServiceSpec

from repro_torch.data import make_clustered_corpus
from repro_torch.launch import serve

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _shape(out: str) -> list:
    """The ``[ann]`` lines with every number replaced by ``#``."""
    return [re.sub(r"\d+(\.\d+)?", "#", line)
            for line in out.splitlines() if line.startswith("[ann]")]


def _run_ref(argv, capsys, monkeypatch) -> tuple:
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    try:
        ref_serve.main()
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _run_port(argv, capsys) -> tuple:
    """``serve_ann`` on the CPU, then served == a direct ``svc.search``
    of the same queries, bit for bit.  Returns (exit code, stdout, the
    number of requests served, the service's recall@10 against the
    oracle under ``--autotune``, else None)."""
    try:
        svc, reqs, _ = serve.serve_ann(serve.build_parser().parse_args(
            [*argv, "--device", "cpu"]))
    except SystemExit as e:
        return e.code, capsys.readouterr().out, 0, None
    try:
        qs = np.stack([r.query for r in reqs]).astype(np.float32)
        d, i = svc.search(qs)
        assert np.array_equal(np.stack([r.ids for r in reqs]), i)
        assert np.array_equal(np.stack([r.dists for r in reqs]), d)
        recall = (_oracle_recall(svc.search) if "--autotune" in argv
                  else None)
        return 0, capsys.readouterr().out, len(reqs), recall
    finally:
        svc.shutdown()


def _lines(out: str, word: str) -> list:
    return [ln for ln in out.splitlines()
            if ln.startswith("[ann]") and word in ln]


def _oracle_recall(search) -> float:
    """recall@10 of ``search`` over the entry point's query pool against
    a numpy brute force over its corpus (the calibration set
    ``--autotune`` measures on)."""
    ds = make_clustered_corpus(seed=0, n=10_000, d=32, n_queries=32,
                               n_components=16, device="cpu")
    x = ds.points.numpy().astype(np.float64)
    q = ds.queries.float().numpy().astype(np.float64)
    d2 = (q * q).sum(1)[:, None] - 2 * q @ x.T + (x * x).sum(1)[None, :]
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    _, ids = search(q.astype(np.float32))
    return float(np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(ids[:, :10].tolist(),
                                          gt.tolist())]))


@pytest.mark.parametrize("argv", [
    ["--ann"],
    ["--ann", "--clock", "wall"],
    ["--ann", "--engine", "sharded", "--router", "least_queue"],
    ["--ann", "--autotune", "--slo-recall", "0.3", "--slo-p99-ms", "1000"],
], ids=["virtual", "wall", "sharded", "autotune"])
def test_serve_ann_matches_reference(argv, capsys, monkeypatch):
    code, out, served, recall = _run_port(argv, capsys)
    ref_code, ref_out = _run_ref(argv, capsys, monkeypatch)
    assert code == ref_code == 0
    assert served == 64
    assert _shape(out) == _shape(ref_out) and len(_shape(out)) >= 2
    if "wall" in argv:
        return          # wall-clock picks follow the host's timing
    # same corpus, same stream, simulated time: the router splits alike
    assert _lines(out, "picks=") == _lines(ref_out, "picks=")
    if "--autotune" not in argv:
        return
    # the tuner's pricing, shortlist and pick are the reference's exactly
    for word in ("autotune:", "slo:", "winner:"):
        assert _lines(out, word) == _lines(ref_out, word) != []
    # its measured recall is the port's own index's, against an oracle
    # outside the port; each package trains its own k-means and PQ from
    # seed 0 (torch's and jax's generators), so beside the reference's
    # it agrees within 0.05 (0.613 against 0.578 on the CPU)
    measured = [float(re.search(r"recall@10=([\d.]+)", ln).group(1))
                for ln in (_lines(out, "measured:")[0],
                           _lines(ref_out, "measured:")[0])]
    assert abs(measured[0] - recall) <= 5e-4
    assert abs(measured[0] - measured[1]) <= 0.05


def test_serve_ann_from_a_reference_spec_file(tmp_path, capsys,
                                              monkeypatch):
    path = RefServiceSpec(engine="local", replicas=2, router="least_queue",
                          nprobe=8, k=10, index=RefIndexSpec(
                              nlist=32, m=8, cb=64),
                          buckets=(1, 2, 4), max_wait_s=1e-3,
                          cache_capacity=512).save(tmp_path / "deploy.json")
    argv = ["--ann", "--spec", str(path), "--clock", "wall"]
    code, out, served, _ = _run_port(argv, capsys)
    ref_code, ref_out = _run_ref(argv, capsys, monkeypatch)
    assert code == ref_code == 0 and served == 64
    assert _shape(out) == _shape(ref_out)
    assert "router=least_queue" in out


def test_main_serves_and_exits_0(capsys):
    assert serve.main(["--ann", "--requests", "8", "--device", "cpu"]) == 0
    assert _lines(capsys.readouterr().out, "8 requests over 2 replica(s)")


@pytest.mark.parametrize("argv,code,printed", [
    (["--arch", "qwen3_14b", "--smoke", "--device", "cpu"], 0,
     "[serve] generated (4, 32)"),
    (["--ann", "--arch", "whisper_base", "--smoke", "--device", "cpu"], 0,
     "[ann] RAG decode over retrieved context: generated (4, 32) tokens"),
    ([], 2, "--arch is required unless --ann is given"),
], ids=["arch", "ann+arch", "neither"])
def test_lm_modes_exit_2_naming_item_13(argv, code, printed, capsys):
    """The LM modes run on the CPU and exit 0; a command line with
    neither mode exits 2, as the reference's ``ap.error``.  (The name is
    kept from when both LM modes exited 2 naming ROADMAP item 13.)"""
    assert serve.main(argv) == code
    out = capsys.readouterr()
    assert printed in (out.err if code else out.out)


def test_ann_arch_without_context_exits_as_reference(capsys, monkeypatch):
    """``--ann --arch`` over an arch with no cross-attention or encoder
    exits 1 with the reference's message (the reference's SystemExit
    carries it)."""
    argv = ["--ann", "--arch", "qwen3_14b", "--smoke"]
    assert serve.main([*argv, "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip()
    ref_code, _ = _run_ref(argv, capsys, monkeypatch)
    assert err == ref_code
    assert "no cross-attention/encoder path" in err


def test_ann_arch_reads_the_served_corpus_built_once(capsys, monkeypatch):
    """``--ann --arch`` builds the corpus once: ``rag_decode`` reads its
    context rows from the points ``serve_ann`` served."""
    import repro_torch.data as data
    calls, seen = [], {}

    def counted(**kw):
        calls.append(kw)
        return make_clustered_corpus(**kw)

    def spy(args, reqs, points):
        seen["points"] = points
        return rag_decode(args, reqs, points)

    rag_decode = serve.rag_decode
    monkeypatch.setattr(data, "make_clustered_corpus", counted)
    monkeypatch.setattr(serve, "rag_decode", spy)
    assert serve.main(["--ann", "--arch", "whisper_base", "--smoke",
                       "--requests", "8", "--device", "cpu"]) == 0
    assert len(calls) == 1
    np.testing.assert_array_equal(
        seen["points"], make_clustered_corpus(**calls[0]).points.numpy())


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["recall"] >= 0.8
    assert min(out["recall_kernels"].values()) >= 0.8
    # on the CPU the kernels' plain versions: the same f32 result
    assert out["recall_kernels"]["f32"] == out["recall"]
    assert "recall@10 =" in capsys.readouterr().out


def test_distributed_example(capsys):
    out = _example("torch_distributed_anns").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert list(out) == ["naive (ID-order, no balance)",
                         "DRIM-ANN (split+dup+alloc+sched)"]
    for name, row in out.items():
        assert f"{name}:" in printed
        assert row["recall"] >= 0.8
    naive, drim = out.values()
    # the layout balances the shards; results do not depend on it
    assert drim["imbalance"] < naive["imbalance"]
    assert drim["recall"] == naive["recall"]
