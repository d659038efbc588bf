"""The port's LM serving loop and RAG path against the reference's, on
the CPU: greedy ``generate`` gives the reference's tokens for every arch
(reference weights carried across, prompts from a numpy seed); the RAG
step turns the same retrieved ids into the same context and the same
tokens; ``python -m repro_torch.launch.serve --arch`` runs every smoke
arch; ``examples/torch_rag_serving.py`` serves == direct and decodes."""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import registry as ref_registry
from repro.data import make_clustered_corpus as ref_corpus
from repro.launch import serve as ref_serve

from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import make_clustered_corpus
from repro_torch.launch import serve

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _weights(arch):
    rcfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, lm_params_from_numpy(cfg, rparams,
                                                    device="cpu")


def _ctx(cfg, batch, seed=4):
    n = serve.context_len(cfg)
    if n is None:
        return None
    return np.random.default_rng(seed).normal(
        size=(batch, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_greedy_generate_equals_reference(arch):
    rcfg, cfg, rparams, params = _weights(arch)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ctx = _ctx(cfg, 2)
    want = ref_serve.generate(rcfg, rparams, jnp.asarray(prompts), 6,
                              ctx=None if ctx is None else jnp.asarray(ctx))
    got = serve.generate(cfg, params, torch.from_numpy(prompts).long(), 6,
                         ctx=None if ctx is None else torch.from_numpy(ctx))
    assert got.shape == (2, 12)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_seeded():
    _, cfg, _, params = _weights("qwen3_14b")
    prompts = torch.zeros((3, 4), dtype=torch.long)
    a = serve.generate(cfg, params, prompts, 8, temperature=1.0, seed=3)
    b = serve.generate(cfg, params, prompts, 8, temperature=1.0, seed=3)
    assert torch.equal(a, b) and torch.equal(a[:, :4], prompts)
    assert int(a.max()) < cfg.vocab_size    # padded rows are never drawn


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "whisper_base"])
def test_rag_context_and_tokens_equal_reference(arch):
    """The reference's RAG step (``launch/serve.py:171-184``, inline
    there) against ``rag_context`` + ``generate`` on the same retrieved
    ids, padded id -1 included."""
    rcfg, cfg, rparams, params = _weights(arch)
    ds = ref_corpus(seed=0, n=10_000, d=32, n_queries=32, n_components=16)
    points = make_clustered_corpus(seed=0, n=10_000, d=32, n_queries=32,
                                   n_components=16, device="cpu").points
    assert np.array_equal(points.numpy(), np.asarray(ds.points))
    doc_ids = np.random.default_rng(2).integers(0, 10_000, (4, 4))
    doc_ids[3, 3] = -1
    # the reference's inline step
    retrieved = np.asarray(ds.points)[np.maximum(doc_ids, 0)]
    proj = np.random.default_rng(0).normal(0, 0.02, size=(32, rcfg.d_model))
    want_ctx = jnp.asarray(retrieved.astype(np.float32) @ proj)
    ctx_len = rcfg.vision_ctx if "cross_attn" in rcfg.layer_types \
        else rcfg.encoder_ctx
    want_ctx = jnp.pad(want_ctx, ((0, 0), (0, ctx_len - 4), (0, 0)))
    ctx = serve.rag_context(points.numpy(), doc_ids, cfg)
    assert ctx.dtype == np.float32
    assert np.array_equal(ctx, np.asarray(want_ctx))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    want = ref_serve.generate(rcfg, rparams, jnp.asarray(prompts), 8,
                              ctx=want_ctx)
    got = serve.generate(cfg, params, torch.from_numpy(prompts).long(), 8,
                         ctx=torch.from_numpy(ctx))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_serve_arch_smoke_exits_0(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] generated \(4, 32\) in [\d.]+s "
                     r"\([\d.]+ tok/s\)", out), out


def test_serve_arch_line_as_reference(capsys, monkeypatch):
    argv = ["--arch", "llama32_vision_11b", "--smoke", "--gen", "4"]
    assert serve.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    ref_serve.main()
    ref_out = capsys.readouterr().out

    def shape(s):
        return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in s.splitlines()]
    assert shape(out) == shape(ref_out) == [
        "[serve] generated (#, #) in #s (# tok/s)"]
    assert "(4, 20)" in out and "(4, 20)" in ref_out


def test_rag_serving_example(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_rag_serving", ROOT / "examples" / "torch_rag_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["served_ok"] and out["stats"]["requests"] == 16
    assert out["doc_ids"].shape == (8, 4) and (out["doc_ids"] >= 0).all()
    assert out["tokens"].shape == (8, 20)
    assert "RAG pipeline OK" in printed.splitlines()[-1]
