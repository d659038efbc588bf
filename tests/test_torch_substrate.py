"""The port's training substrate on the CPU: the sixteen contracts of
``tests/test_substrate.py`` on the port (optimizer, gradient compression,
pipeline, checkpoints, fault-tolerance control plane, the train loop with
restart), then each piece against the reference on the same inputs:
AdamW's update on a carried smoke tree (decay on the stacked group
norms included), the schedule, int8 compression and error feedback, the
pipeline's batches, checkpoints restored across the two packages, and
the supervisor's call sequence."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import registry as ref_registry
from repro.data.pipeline import make_token_pipeline as ref_pipeline
from repro.optim import adamw as ref_adamw
from repro.optim import grad_compress as ref_gc
from repro.runtime import fault_tolerance as ref_ft

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.convert import (adamw_state_from_numpy, adamw_state_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data.pipeline import make_token_pipeline
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.grad_compress import (compress_int8, decompress_int8,
                                             ef_init, ef_step)
from repro_torch.runtime import (HeartbeatRegistry, RunSupervisor,
                                 StragglerPolicy, plan_elastic_mesh)

torch.set_num_threads(2)


# -- optimizer ---------------------------------------------------------------

def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[1] == pytest.approx(0.5, abs=1e-6)     # mid-warmup
    assert lrs[2] == pytest.approx(1.0, abs=1e-6)     # peak
    assert lrs[4] == pytest.approx(0.1, abs=1e-2)     # floor


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=1e-9, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    _, _, m = adamw.update(cfg, {"w": torch.full((4,), 100.0)}, state,
                           params)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


# -- gradient compression ------------------------------------------------------

def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))}
    q, s = compress_int8(g)
    assert q["a"].dtype == torch.int8
    deq = decompress_int8(q, s)
    err = float((deq["a"] - g["a"]).abs().max())
    assert err <= float(s["a"]) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_steps():
    """EF residual keeps the *cumulative* applied gradient close to the
    cumulative true gradient (property of EF-SGD)."""
    rng = np.random.default_rng(1)
    state = ef_init({"w": torch.zeros(64)})
    total_true = np.zeros(64)
    total_applied = np.zeros(64)
    for i in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        applied, state = ef_step(g, state)
        total_true += g["w"].numpy()
        total_applied += applied["w"].numpy()
    resid = np.abs(total_true - total_applied).max()
    # leftover residual is bounded by one step's quantization error
    assert resid < 0.2


# -- pipeline ------------------------------------------------------------------

def test_pipeline_deterministic_and_seekable():
    p1 = make_token_pipeline(1000, 32, 8, seed=7)
    p2 = make_token_pipeline(1000, 32, 8, seed=7)
    b5a = p1.batch_at(5)
    b5b = p2.batch_at(5)
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    # labels are tokens shifted by one
    np.testing.assert_array_equal(b5a["tokens"][:, 1:], b5a["labels"][:, :-1])


def test_pipeline_sharding_partitions_batch():
    full = make_token_pipeline(1000, 16, 8, seed=3)
    shards = [make_token_pipeline(1000, 16, 8, seed=3, shard_index=i,
                                  shard_count=4) for i in range(4)]
    got = np.concatenate([s.batch_at(0)["tokens"] for s in shards])
    assert got.shape == full.batch_at(0)["tokens"].shape
    # shards are disjoint parts of the same global batch (same seed/step)
    assert len(np.unique(got.sum(1))) >= 2


# -- checkpoint ----------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    ck.save(10, tree, extra={"step": 10})
    restored, extra = ck.restore(None, tree)
    assert extra["step"] == 10
    assert torch.equal(restored["a"], tree["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_checkpoint_keeps_last_k_and_commit_marker(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    t = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, t, extra={"step": s})
    assert ck.all_steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(tmp_path)
    t = {"w": torch.arange(4.0)}
    ck.save(1, t, extra={"step": 1}, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_async_snapshot_taken_before_save_returns(tmp_path):
    """An in-place update right after an async ``save`` returns does not
    reach the checkpoint (torch tensors are mutable)."""
    ck = Checkpointer(tmp_path)
    w = torch.arange(1 << 16, dtype=torch.float32)
    before = w.clone()
    ck.save(1, {"w": w}, extra={"step": 1}, blocking=False)
    w.add_(1.0)
    ck.wait()
    restored, _ = ck.restore(1, {"w": w})
    assert torch.equal(restored["w"], before)


# -- fault tolerance -------------------------------------------------------------

def test_heartbeat_detects_dead_host():
    clock = [0.0]
    reg = HeartbeatRegistry(4, timeout_s=10, clock=lambda: clock[0])
    clock[0] = 5.0
    for h in (0, 1, 3):
        reg.beat(h)
    clock[0] = 12.0
    assert reg.dead() == [2]
    assert sorted(reg.alive()) == [0, 1, 3]


def test_elastic_plan_shrinks_data_axis():
    plan = plan_elastic_mesh(n_alive=13, data_axis=16, model_axis=16)
    assert plan.data_axis == 8 and plan.model_axis == 16


def test_straggler_policy_flags_slow_host():
    clock = [0.0]
    reg = HeartbeatRegistry(4, clock=lambda: clock[0])
    for i in range(10):
        for h in range(4):
            reg.beat(h, step_time_s=1.0 if h != 2 else 3.0)
    assert StragglerPolicy(ratio=1.5).flag(reg) == [2]


def test_supervisor_restart_loop():
    reg = HeartbeatRegistry(16, timeout_s=1e9)
    calls = []

    def run_fn(mesh_shape, start_step):
        calls.append((mesh_shape, start_step))
        if len(calls) == 1:
            return "failed", 40       # crash at step 40 on the full mesh
        return "done", 100

    sup = RunSupervisor(data_axis=16, model_axis=16)
    last = sup.supervise(run_fn, reg)
    assert last == 100
    assert calls[0] == ((16, 16), 0)
    assert calls[1][1] == 40          # resumed from failure step


# -- end-to-end train loop with restart ------------------------------------------

def test_train_restart_resumes_from_checkpoint(tmp_path):
    from repro_torch.launch.train import train_loop
    cfg = registry.get_config("qwen3_14b", smoke=True)
    # run 1: crash at step 6 (ckpt every 3)
    with pytest.raises(RuntimeError):
        train_loop(cfg, steps=10, global_batch=4, seq_len=16,
                   ckpt_dir=tmp_path, ckpt_every=3, fail_at_step=6,
                   log_every=100, device="cpu")
    # run 2: restores from step 6 and finishes
    params, hist = train_loop(cfg, steps=10, global_batch=4, seq_len=16,
                              ckpt_dir=tmp_path, ckpt_every=3,
                              log_every=100, device="cpu")
    assert len(hist) == 4            # steps 6..9 only (resumed, not replayed)
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(l) for l in losses)


def test_train_loss_decreases():
    from repro_torch.launch.train import train_loop
    cfg = registry.get_config("minitron_4b", smoke=True)
    _, hist = train_loop(cfg, steps=30, global_batch=8, seq_len=32,
                         log_every=100, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


# -- against the reference ---------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _get(tree, path):
    for k in path:
        tree = (getattr(tree, k.name) if hasattr(k, "name")
                else tree[getattr(k, "key", getattr(k, "idx", k))])
    return tree


def _assert_tree_close(got_np, want, rtol, atol, what):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(
            np.asarray(_get(got_np, path), np.float32),
            np.asarray(leaf, np.float32), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ["qwen3_14b", "llama32_vision_11b",
                                  "whisper_base"])
def test_adamw_update_equals_reference(arch):
    """Three updates of a carried smoke tree with identical gradients
    (clipped: their norm is far above 1): params, mu, nu, grad_norm and
    lr equal the reference's.  The trees hold group norms (decayed: the
    reference stores them stacked, 2-D), ``final_norm`` (not decayed),
    qk norms (qwen3), a ``tail0`` (llama-vision) and an encoder
    (whisper)."""
    rcfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(cfg, rparams, device="cpu")
    rstate, state = ref_adamw.init(rparams), adamw.init(params)
    rcfg_o, cfg_o = ref_adamw.AdamWConfig(**OPT), AdamWConfig(**OPT)
    rng = np.random.default_rng(5)
    rupdate = jax.jit(lambda g, s, p: ref_adamw.update(rcfg_o, g, s, p))
    for _ in range(3):
        gnp = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), rparams)
        rparams, rstate, rm = rupdate(gnp, rstate, rparams)
        grads = lm_params_from_numpy(cfg, gnp, device="cpu")
        params, state, m = adamw.update(cfg_o, grads, state, params)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == float(rm["lr"])
        _assert_tree_close(lm_params_to_numpy(cfg, params), rparams,
                           1e-6, 1e-7, "params")
        step, mu, nu = adamw_state_to_numpy(cfg, state)
        assert int(step) == int(rstate.step)
        _assert_tree_close(mu, rstate.mu, 1e-6, 1e-7, "mu")
        _assert_tree_close(nu, rstate.nu, 1e-6, 1e-7, "nu")


def test_adamw_decays_by_reference_rank():
    """With zero gradients an update is pure decay: every leaf the
    reference stores with rank >= 2 shrinks by lr * wd, the group norms
    included (1-D here, stacked to 2-D there); ``final_norm`` and the
    ``tail0`` norms (1-D there too) stay."""
    cfg = registry.get_config("llama32_vision_11b", smoke=True)
    rcfg = ref_registry.get_config("llama32_vision_11b", smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(cfg, rparams, device="cpu")
    before = lm_params_from_numpy(cfg, rparams, device="cpu")
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), rparams)
    c = AdamWConfig(lr=0.5, weight_decay=0.1, warmup_steps=0)
    params, _, _ = adamw.update(c, lm_params_from_numpy(cfg, zeros,
                                                        device="cpu"),
                                adamw.init(params), params)
    shrink = 1 - float(adamw.schedule(c, 1)) * 0.1
    g0 = params["groups"][0]
    assert torch.allclose(g0["l0"]["norm_mix"],
                          before["groups"][0]["l0"]["norm_mix"] * shrink)
    assert torch.equal(params["final_norm"], before["final_norm"])
    assert torch.equal(params["tail0"]["norm_mix"],
                       before["tail0"]["norm_mix"])
    assert torch.allclose(params["tail0"]["attn"]["wq"],
                          before["tail0"]["attn"]["wq"] * shrink)


def test_schedule_equals_reference():
    for kw in (dict(lr=1e-3, warmup_steps=20, total_steps=200),
               dict(lr=3e-4, warmup_steps=1, total_steps=8),
               dict(lr=1.0, warmup_steps=0, total_steps=150,
                    min_lr_frac=0.05)):
        rc, pc = ref_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
        want = np.array([float(ref_adamw.schedule(rc, jnp.asarray(s)))
                         for s in range(201)], np.float32)
        got = np.array([float(adamw.schedule(pc, s)) for s in range(201)],
                       np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_compress_int8_equals_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(257,)).astype(np.float32) * 3,
            "b": {"c": rng.normal(size=(16, 9)).astype(np.float32)},
            "half": (np.arange(-254, 255, dtype=np.float32) / 2),
            "zero": np.zeros(5, np.float32)}
    rq, rs = ref_gc.compress_int8(jax.tree.map(jnp.asarray, tree))
    q, s = compress_int8(jax.tree.map(torch.from_numpy, tree))
    for path, leaf in jax.tree_util.tree_flatten_with_path(rq)[0]:
        assert np.array_equal(_get(q, path).numpy(), np.asarray(leaf)), \
            jax.tree_util.keystr(path)
        assert _get(s, path).item() == float(_get(rs, path))
    rdeq = ref_gc.decompress_int8(rq, rs)
    deq = decompress_int8(q, s)
    for path, leaf in jax.tree_util.tree_flatten_with_path(rdeq)[0]:
        assert np.array_equal(_get(deq, path).numpy(), np.asarray(leaf))


def test_ef_step_equals_reference():
    rng = np.random.default_rng(3)
    shapes = {"w": (64,), "m": (8, 12)}
    rstate = ref_gc.ef_init({k: jnp.zeros(v) for k, v in shapes.items()})
    state = ef_init({k: torch.zeros(v) for k, v in shapes.items()})
    for _ in range(20):
        g = {k: rng.normal(size=v).astype(np.float32)
             for k, v in shapes.items()}
        rapplied, rstate = ref_gc.ef_step(jax.tree.map(jnp.asarray, g),
                                          rstate)
        applied, state = ef_step(jax.tree.map(torch.from_numpy, g), state)
        for k in shapes:
            np.testing.assert_allclose(applied[k].numpy(),
                                       np.asarray(rapplied[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(state.residual[k].numpy(),
                                       np.asarray(rstate.residual[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed,shards", [(0, 1), (7, 1), (3, 4)])
def test_pipeline_batches_equal_reference(seed, shards):
    for shard in range(shards):
        kw = dict(seed=seed, shard_index=shard, shard_count=shards)
        want, got = ref_pipeline(1000, 24, 8, **kw), \
            make_token_pipeline(1000, 24, 8, **kw)
        for step in (0, 1, 5, 123):
            a, b = want.batch_at(step), got.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
        # the iterator and its state dict too
        got.load_state_dict({"step": 3})
        want.load_state_dict({"step": 3})
        assert np.array_equal(next(got)["tokens"], next(want)["tokens"])
        assert got.state_dict() == want.state_dict() == {"step": 4}


def test_pipeline_token_file_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 5000, 10_000).astype(
        np.uint32).tofile(path)
    for shard in range(2):
        kw = dict(seed=1, shard_index=shard, shard_count=2,
                  token_file=str(path))
        a = ref_pipeline(5000, 32, 4, **kw).batch_at(9)
        b = make_token_pipeline(5000, 32, 4, **kw).batch_at(9)
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])


def _trees(dtype):
    """The same (params, AdamW state) in both packages: llama-vision smoke
    (groups, tail0) after one update, cast to ``dtype``."""
    arch = "llama32_vision_11b"
    rcfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    rparams, _ = R.init_params(jax.random.PRNGKey(0), rcfg)
    rstate = ref_adamw.init(rparams)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01), rparams)
    rparams, rstate, _ = ref_adamw.update(ref_adamw.AdamWConfig(**OPT), g,
                                          rstate, rparams)
    rparams = jax.tree.map(lambda x: x.astype(dtype), rparams)
    params = lm_params_from_numpy(cfg, rparams, device="cpu")
    state = adamw_state_from_numpy(cfg, rstate, device="cpu")
    return (rparams, rstate), (params, state)


def _manifest(d: pathlib.Path, step: int) -> dict:
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_restore(tmp_path, dtype):
    """A reference checkpoint restores into the port and a port checkpoint
    into the reference, value for value (bf16 stored widened to f32 by
    both), with the same manifest leaves: keys, shapes (groups stacked)
    and dtypes."""
    (rtree, ptree) = _trees(getattr(jnp, dtype))
    RefCheckpointer(tmp_path / "ref").save(1, rtree, extra={"step": 1})
    Checkpointer(tmp_path / "port").save(1, ptree, extra={"step": 1})
    assert _manifest(tmp_path / "ref", 1)["leaves"] == \
        _manifest(tmp_path / "port", 1)["leaves"]

    got, extra = Checkpointer(tmp_path / "ref").restore(None, ptree)
    assert extra == {"step": 1}
    params, state = got
    assert params["embedding"].dtype == getattr(torch, dtype)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert int(state.step) == 1
    cfg = registry.get_config("llama32_vision_11b", smoke=True)
    _assert_tree_close(lm_params_to_numpy(cfg, params), rtree[0], 0, 0,
                       "params")
    _, mu, nu = adamw_state_to_numpy(cfg, state)
    _assert_tree_close(mu, rtree[1].mu, 0, 0, "mu")
    _assert_tree_close(nu, rtree[1].nu, 0, 0, "nu")

    (rparams, rstate), extra = RefCheckpointer(tmp_path / "port").restore(
        None, rtree)
    assert extra == {"step": 1}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rtree)[0]:
        back = _get((rparams, rstate), path)
        assert back.dtype == leaf.dtype
        assert np.array_equal(np.asarray(back, np.float32),
                              np.asarray(leaf, np.float32))


def test_supervisor_call_sequence_equals_reference():
    """One failure script through both supervisors: hosts die between
    attempts (the mesh shrinks), failures land before, on and after the
    declared checkpoints; the run_fn calls and the history are equal."""
    def script(pkg):
        clock = [0.0]
        reg = pkg.HeartbeatRegistry(16, timeout_s=10,
                                    clock=lambda: clock[0])
        outcomes = [("failed", 45), ("failed", 12), ("failed", 7),
                    ("failed", 130), ("done", 200)]
        dead = [3, 9, 0, 0, 0]
        calls = []

        def run_fn(mesh_shape, start_step):
            i = len(calls)
            calls.append((mesh_shape, start_step))
            clock[0] += 20.0
            for h in range(16 - sum(dead[:i + 1])):
                reg.beat(h)
            return outcomes[i]

        sup = pkg.RunSupervisor(16, 4, checkpoint_steps=(50, 10, 100))
        last = sup.supervise(run_fn, reg)
        return last, calls, sup.history, sup.data_axis

    import repro_torch.runtime.fault_tolerance as port_ft
    assert script(port_ft) == script(ref_ft)
