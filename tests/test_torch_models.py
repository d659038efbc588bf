"""The port's LM stack against the reference's, on the CPU: the registry
and all ten architectures' configs field for field, the analytic
parameter counts of the full configs (built on the meta device), and, on
each smoke config with the reference's weights carried across
(``convert.lm_params_from_numpy``) and inputs from a numpy seed,
``forward``, eight ``decode_step``s, ``encode`` and decode == forward;
then the attention, MoE, SSD, RG-LRU and layer contracts one by one.

The reference's outputs are computed once per arch (jitted) in a
module-scoped cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import registry as ref_registry
from repro.launch.specs import count_params_analytic as ref_count
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import rglru as RRG

from repro_torch import models as P
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.specs import (cache_specs, count_params_analytic,
                                      param_specs)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models.common import tree_leaves

torch.set_num_threads(2)
ARCHS = registry.ARCH_IDS
# f32 sums in another order, and XLA's and torch's cos / sin (RoPE) a few
# ulp apart: about 1e-5 of the logits' scale on every arch.  The three
# archs with a tied embedding (drawn at scale 1) read logits up to ~32
# against ~1.4 elsewhere, so they get 1e-3 (measured max |err| on these
# inputs: command-r 3.2e-4 at logits up to 32, recurrentgemma 1.05e-4 at
# 28, mamba2 1.8e-5 at 32); 1e-4 elsewhere (measured at most 3e-5)
TOL = {a: (1e-3 if registry.get_config(a, smoke=True).tie_embeddings
           else 1e-4) for a in ARCHS}
SEQ, BATCH = 16, 2


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(cfg, seq=SEQ):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    ctx = None
    if cfg.is_encdec:
        ctx = rng.normal(size=(BATCH, cfg.encoder_ctx, cfg.d_model))
    elif "cross_attn" in cfg.layer_types:
        ctx = rng.normal(size=(BATCH, cfg.vision_ctx, cfg.d_model))
    return toks, None if ctx is None else ctx.astype(np.float32)


class _Ref:
    """One arch's reference weights and outputs, computed on first use."""

    def __init__(self, arch):
        self.rcfg = ref_registry.get_config(arch, smoke=True)
        self.cfg = registry.get_config(arch, smoke=True)
        self.rparams, _ = R.init_params(jax.random.PRNGKey(0), self.rcfg)
        self.params = lm_params_from_numpy(self.cfg, self.rparams,
                                           device="cpu")
        self.toks, self.ctx = _inputs(self.cfg)
        rctx = None if self.ctx is None else jnp.asarray(self.ctx)
        fwd = jax.jit(lambda p, t, c: R.forward(p, self.rcfg, t, ctx=c))
        logits, aux = fwd(self.rparams, jnp.asarray(self.toks), rctx)
        self.logits, self.aux = _np(logits), float(aux)
        self.enc_out = (R.encode(self.rparams, self.rcfg, rctx)
                        if self.rcfg.is_encdec else None)
        step = jax.jit(lambda p, t, pos, c: R.decode_step(
            p, self.rcfg, t, pos, c,
            ctx=None if self.rcfg.is_encdec else rctx,
            enc_out=self.enc_out))
        caches = R.init_caches(self.rcfg, BATCH, 8)
        outs = []
        for t in range(8):
            lg, caches = step(self.rparams, jnp.asarray(self.toks[:, t:t + 1]),
                              jnp.full((BATCH,), t, jnp.int32), caches)
            outs.append(_np(lg[:, 0]))
        self.decode = np.stack(outs, 1)


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Ref(arch)
        return cache[arch]
    return get


def _port_decode(cfg, params, toks, ctx, steps=8):
    ctx_t = None if ctx is None else _t(ctx)
    enc_out = P.encode(params, cfg, ctx_t) if cfg.is_encdec else None
    caches = P.init_caches(cfg, BATCH, steps, device="cpu")
    outs = []
    for t in range(steps):
        lg, caches = P.decode_step(
            params, cfg, _t(toks[:, t:t + 1]).long(),
            torch.full((BATCH,), t), caches,
            ctx=None if cfg.is_encdec else ctx_t, enc_out=enc_out)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, 1)


# -- the registry -------------------------------------------------------------

def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).split(".")[-1].replace("'>", "").replace(
                "<class 'jax.numpy.", "")
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_configs_equal_field_for_field(arch):
    for smoke in (False, True):
        got = _fields(registry.get_config(arch, smoke=smoke))
        want = _fields(ref_registry.get_config(arch, smoke=smoke))
        assert got == want
        assert got["dtype"] in ("bfloat16", "float32")
        cfg = registry.get_config(arch, smoke=smoke)
        rcfg = ref_registry.get_config(arch, smoke=smoke)
        assert (cfg.is_encdec, cfg.vocab_padded, cfg.q_per_kv) == \
            (rcfg.is_encdec, rcfg.vocab_padded, rcfg.q_per_kv)
        assert P.group_structure(cfg) == R.group_structure(rcfg)


def test_registry_tables_equal():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert registry.SUBQUADRATIC == ref_registry.SUBQUADRATIC
    assert [dataclasses.astuple(s) for s in registry.SHAPES] == \
        [dataclasses.astuple(s) for s in ref_registry.SHAPES]
    assert set(registry.SHAPES_BY_NAME) == set(ref_registry.SHAPES_BY_NAME)
    got = [(a, dataclasses.astuple(s), skip)
           for a, s, skip in registry.all_cells()]
    want = [(a, dataclasses.astuple(s), skip)
            for a, s, skip in ref_registry.all_cells()]
    assert got == want and len(got) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_analytic_equals_reference(arch):
    cfg = registry.get_config(arch)
    n = count_params_analytic(cfg)
    assert n == ref_count(ref_registry.get_config(arch))
    # built on the meta device: nothing allocated
    assert all(x.is_meta for x in tree_leaves(param_specs(cfg)[0]))
    if arch == "llama32_vision_11b":
        assert n == 9_777_254_400
    if arch == "deepseek_v2_236b":
        assert n == 244_188_441_600


def test_cache_specs_are_meta_and_shaped():
    cfg = registry.get_config("llama32_vision_11b")
    caches = cache_specs(cfg, 4, 32)
    leaves = tree_leaves(caches)
    assert all(x.is_meta for x in leaves)
    kv = caches["groups"][0]["l0"]
    assert tuple(kv.k.shape) == (4, 32, 8, 128) and kv.k.dtype == \
        torch.bfloat16
    assert len(caches["groups"]) == 8


# -- each arch against the reference ------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, ref):
    r = ref(arch)
    assert P.count_params(r.params) == R.count_params(r.rparams)
    logits, aux = P.forward(r.params, r.cfg, _t(r.toks).long(),
                            ctx=None if r.ctx is None else _t(r.ctx))
    assert logits.dtype == torch.float32
    assert logits.shape == (BATCH, SEQ, r.cfg.vocab_padded)
    tol = TOL[arch]
    np.testing.assert_allclose(logits.numpy(), r.logits, rtol=tol, atol=tol)
    assert float(aux) == pytest.approx(r.aux, rel=1e-5, abs=1e-6)
    # padded vocab rows carry the reference's mask value, not -inf
    if r.cfg.vocab_padded != r.cfg.vocab_size:
        assert (logits[..., r.cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_reference(arch, ref):
    r = ref(arch)
    dec = _port_decode(r.cfg, r.params, r.toks, r.ctx)
    tol = TOL[arch]
    np.testing.assert_allclose(dec, r.decode, rtol=tol, atol=tol)


def test_encode_equals_reference(ref):
    r = ref("whisper_base")
    enc = P.encode(r.params, r.cfg, _t(r.ctx))
    assert enc.shape == (BATCH, r.cfg.encoder_ctx, r.cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), _np(r.enc_out), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b",
                                  "mamba2_2p7b", "deepseek_v2_236b",
                                  "whisper_base", "llama32_vision_11b",
                                  "qwen2_moe_a2p7b"])
def test_decode_equals_forward(arch):
    """Causal consistency in the port alone, at the reference's 5e-3
    (tests/test_archs_smoke.py; MoE at capacity_factor 8, so no token
    drops in the forward)."""
    cfg = registry.get_config(arch, smoke=True)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    params = P.init_params(cfg, 0, device="cpu")
    toks, ctx = _inputs(cfg, seq=8)
    logits, _ = P.forward(params, cfg, _t(toks).long(),
                          ctx=None if ctx is None else _t(ctx))
    dec = _port_decode(cfg, params, toks, ctx)
    assert np.abs(dec - logits.numpy()).max() < 5e-3


def test_chunked_dispatch_equals_reference():
    """A forward whose score matrix passes 1024 x 1024 takes the chunked
    path in both packages (S = 1,100: three 512-blocks, the last padded)."""
    rcfg = ref_registry.get_config("qwen3_14b", smoke=True)
    cfg = registry.get_config("qwen3_14b", smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(cfg, rparams, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 1100)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: R.forward(p, rcfg, t))(
        rparams, jnp.asarray(toks))
    got, _ = P.forward(params, cfg, _t(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


# -- attention ------------------------------------------------------------------

def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("s,h,kv,hd,bq", [(2048, 4, 2, 16, 256),
                                          (4096, 2, 1, 8, 128)],
                         ids=["8-qblocks", "32-qblocks"])
def test_causal_skip_matches_masked(s, h, kv, hd, bq):
    """tests/test_perf_paths.py's two causal-skip contracts (the
    reference's unrolled and while-loop paths: 8 and 32 q blocks): the
    diagonal trip count equals visiting every block masked; and both
    equal the reference's chunked attention."""
    q, k, v = _qkv(0 if s == 2048 else 1, 1, s, h, kv, hd)
    skip = A.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                               causal_skip=True, bq=bq, bkv=bq)
    base = A.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                               causal_skip=False, bq=bq, bkv=bq)
    np.testing.assert_allclose(skip.numpy(), base.numpy(), rtol=1e-4,
                               atol=1e-4)
    want = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                causal_skip=True, bq=bq, bkv=bq)
    np.testing.assert_allclose(skip.numpy(), _np(want), rtol=1e-4,
                               atol=1e-4)


def test_causal_skip_differentiable():
    q, k, v = (_t(x) for x in _qkv(2, 1, 1024, 2, 2, 8))
    q1 = q.clone().requires_grad_()
    A.chunked_attention(q1, k, v, causal=True, causal_skip=True, bq=256,
                        bkv=256).sum().backward()
    q2 = q.clone().requires_grad_()
    A._sdpa(q2, k, v, A.causal_mask(1024)).sum().backward()
    assert torch.isfinite(q1.grad).all()
    np.testing.assert_allclose(q1.grad.numpy(), q2.grad.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_chunked_local_window_long():
    """Window attention visits only the window's blocks: equal to the
    dense local mask and to the reference's chunked path."""
    q, k, v = _qkv(3, 1, 512, 2, 1, 8)
    dense = A._sdpa(_t(q), _t(k), _t(v), A.local_mask(512, 64))
    chunk = A.chunked_attention(_t(q), _t(k), _t(v), causal=True, window=64,
                                bq=128, bkv=64)
    np.testing.assert_allclose(dense.numpy(), chunk.numpy(), rtol=1e-4,
                               atol=1e-4)
    want = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=64,
                                bq=128, bkv=64)
    np.testing.assert_allclose(chunk.numpy(), _np(want), rtol=1e-4,
                               atol=1e-4)


def test_chunked_clamped_blocks_equal_reference():
    """bq > bkv with a window: some visited KV blocks start past the end,
    which ``lax.dynamic_slice`` clamps; the port clamps alike."""
    q, k, v = _qkv(4, 1, 300, 2, 1, 8)
    kw = dict(causal=True, window=40, bq=128, bkv=32)
    got = A.chunked_attention(_t(q), _t(k), _t(v), **kw)
    want = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_ring_cache_window_decode_equals_reference():
    """A local layer's cache is ``window`` long: after more steps than
    slots the ring wraps, and the valid slots are the window's."""
    cfg = registry.get_config("recurrentgemma_2b", smoke=True)
    rcfg = ref_registry.get_config("recurrentgemma_2b", smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(1), rcfg)
    rp = jax.tree.map(lambda x: x[0], rparams["groups"]["l2"]["attn"])
    pp = {k: _t(np.array(v)) for k, v in rp.items()}
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(BATCH, 20, cfg.d_model)).astype(np.float32)
    cache = A.init_kv_cache(cfg, BATCH, cfg.window, torch.float32)
    rcache = RA.init_kv_cache(rcfg, BATCH, rcfg.window, jnp.float32)
    for t in range(20):
        pos = np.full((BATCH,), t, np.int32)
        pos[1] = max(t - 3, 0)                  # rows at their own positions
        out, cache = A.attention_decode(pp, _t(xs[:, t:t + 1]), cfg, cache,
                                        _t(pos).long(), window=cfg.window)
        want, rcache = RA.attention_decode(rp, jnp.asarray(xs[:, t:t + 1]),
                                           rcfg, rcache, jnp.asarray(pos),
                                           window=rcfg.window)
        np.testing.assert_allclose(out.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)
    assert cache.k.shape[1] == cfg.window == 8


# -- MoE, RG-LRU, layers ----------------------------------------------------------

@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_moe_drop_order_equals_reference(cf):
    """Capacity dispatch with tokens dropped (capacity factor 0.25: most
    (token, choice) pairs overflow) keeps and drops the same pairs in
    the same order.  Random f32 router logits have no top-k ties."""
    rcfg = ref_registry.get_config("qwen2_moe_a2p7b", smoke=True)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=cf))
    cfg = registry.get_config("qwen2_moe_a2p7b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    rparams, _ = R.init_params(jax.random.PRNGKey(2), rcfg)
    rp = jax.tree.map(lambda x: x[0], rparams["groups"]["l0"]["moe"])
    pp = {k: _t(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(6).normal(
        size=(4, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = RM.moe_apply(rp, jnp.asarray(x), rcfg)
    got, aux = MOE.moe_apply(pp, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    assert MOE._capacity(96, cfg.moe) == RM._capacity(96, rcfg.moe)


def test_linear_scan_equals_associative_scan():
    rng = np.random.default_rng(8)
    la = -rng.uniform(0, 2, size=(2, 37, 5)).astype(np.float32)
    x = rng.normal(size=(2, 37, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] + c2[0], c2[1] + jnp.exp(c2[0]) * c1[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(la),
                                                 jnp.asarray(x)), axis=1)
    got = RG.linear_scan(_t(la), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    rcfg = ref_registry.get_config("recurrentgemma_2b", smoke=True)
    assert RG._C == RRG._C and rcfg.rglru.conv_width == 4


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = L.gelu(_t(x)).numpy()
    np.testing.assert_allclose(got, _np(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4


def test_rope_norms_unembed_equal_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(_t(x), _t(pos).long(), 500_000.0).numpy(),
        _np(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(_t(w), _t(x)).numpy(),
        _np(RL.rmsnorm(jnp.asarray(w), jnp.asarray(x))), rtol=1e-5,
        atol=1e-5)
    ln = {"scale": w, "bias": rng.normal(size=(16,)).astype(np.float32)}
    np.testing.assert_allclose(
        L.layernorm({k: _t(v) for k, v in ln.items()}, _t(x)).numpy(),
        _np(RL.layernorm({k: jnp.asarray(v) for k, v in ln.items()},
                         jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # unembed: bf16 weights and activations, f32 logits accumulated in f32
    rcfg = dataclasses.replace(ref_registry.get_config("qwen3_14b", True),
                               dtype=jnp.bfloat16, vocab_size=500)
    cfg = dataclasses.replace(registry.get_config("qwen3_14b", True),
                              dtype=torch.bfloat16, vocab_size=500)
    head = rng.normal(size=(512, 64)).astype(np.float32)
    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    want = RL.unembed({"lm_head": jnp.asarray(head, jnp.bfloat16)},
                      jnp.asarray(h, jnp.bfloat16), rcfg)
    got = L.unembed({"lm_head": _t(head).bfloat16()}, _t(h).bfloat16(), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)
    assert (got[..., 500:] == -1e30).all()


def test_init_distribution_and_carried_layout():
    """The port's own init: trunc-normal(-2, 2) x 1/sqrt(fan_in) (the
    reference's distribution), norms at 1; and a carried-across tree has
    the port's init's structure and shapes."""
    cfg = registry.get_config("llama32_vision_11b", smoke=True)
    params = P.init_params(cfg, 0, device="cpu")
    w = params["groups"][0]["l0"]["ffn"]["w_up"]          # fan_in 64
    assert w.abs().max() <= 2.0 / 8.0 + 1e-6
    assert float(w.std()) == pytest.approx(0.8796 / 8.0, rel=0.05)
    emb = params["embedding"]                              # scale 1
    assert emb.abs().max() <= 2.0 and float(emb.std()) > 0.8
    assert (params["final_norm"] == 1).all()
    again = P.init_params(cfg, 0, device="cpu")
    assert torch.equal(again["lm_head"], params["lm_head"])
    rparams, _ = R.init_params(jax.random.PRNGKey(0),
                               ref_registry.get_config(
                                   "llama32_vision_11b", smoke=True))
    carried = lm_params_from_numpy(cfg, rparams, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), carried)
    assert shapes == jax.tree.map(lambda x: tuple(x.shape), params)
    np.testing.assert_array_equal(
        carried["tail0"]["attn"]["wq"].numpy(),
        np.asarray(rparams["tail0"]["attn"]["wq"]))
