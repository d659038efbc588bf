"""Training driver: data pipeline -> train_step -> checkpoint/restart.

The reference's driver (``src/repro/launch/train.py``) on the port: the
deterministic token pipeline, the train step (autograd + in-place AdamW),
periodic async checkpoints in the reference's format, restore on start.
Runs on ``--device`` (default the card; without CUDA that raises;
``--device cpu`` is opt-in):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
        --smoke --steps 20 --batch 8 --seq 64

Weights are the port's own draw (``init_params(cfg, seed)``: torch's
generator, not ``jax.random``), and so is the stub context of the vlm and
enc-dec archs, drawn from a generator seeded by the step.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.data.pipeline import make_token_pipeline
from repro_torch.launch import steps as steplib
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.util import resolve_device


def ctx_for(cfg, step: int, batch: int, device) -> torch.Tensor | None:
    """The modality stub of the vlm / enc-dec archs at ``step``: standard
    normal context rows from a generator seeded by the step; None for an
    arch that reads no context."""
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_ctx, cfg.d_model)
    elif "cross_attn" in cfg.layer_types:
        shape = (batch, cfg.vision_ctx, cfg.d_model)
    else:
        return None
    gen = torch.Generator(device=device).manual_seed(step)
    return torch.randn(shape, generator=gen, device=device)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir=None, ckpt_every: int = 50,
               start_step: int | None = None, seed: int = 0,
               log_every: int = 5, fail_at_step: int | None = None,
               device="cuda"):
    """Returns (final params, metrics history).  ``fail_at_step`` injects a
    crash for restart tests."""
    dev = resolve_device(device)
    pipe = make_token_pipeline(cfg.vocab_size, seq_len, global_batch,
                               seed=seed)
    params = init_params(cfg, seed, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    opt_state = adamw.init(params)
    step_fn = steplib.make_train_step(cfg, opt_cfg)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    step0 = 0
    if ckpt and ckpt.latest_step() is not None and start_step is None:
        (params, opt_state), extra = ckpt.restore(None, (params, opt_state))
        step0 = int(extra["step"])
        pipe.load_state_dict({"step": step0})
        print(f"[train] restored step {step0}")

    history = []
    t0 = time.time()
    try:
        for step in range(step0, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(step).items()}
            ctx = ctx_for(cfg, step, global_batch, dev)
            if ctx is not None:
                batch["ctx"] = ctx
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            history.append({k: float(v) for k, v in metrics.items()})
            if step % log_every == 0:
                print(f"[train] step {step} loss {history[-1]['loss']:.4f} "
                      f"({time.time() - t0:.1f}s)")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state),
                          extra={"step": step + 1}, blocking=False)
    finally:
        # an in-flight async save must land even when the loop dies --
        # the writer thread would otherwise race a restart
        if ckpt:
            ckpt.wait()
    if ckpt:
        ckpt.save(steps, (params, opt_state), extra={"step": steps},
                  blocking=True)
    return params, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> list:
    """Parse ``argv`` and train; returns the metrics history (the steps
    this run took: a restored run resumes, it does not replay)."""
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    _, hist = train_loop(cfg, steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                         device=args.device)
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}")
    else:
        print(f"[train] nothing to do: the checkpoint is at step "
              f"{args.steps}")
    return hist


if __name__ == "__main__":
    main()
