"""Train a reduced-config LM (any of the 10 architectures) for a few
hundred steps with checkpointing, on the PyTorch port: the end-to-end
training driver (token pipeline -> train step with in-place AdamW ->
async checkpoints; a rerun resumes from the latest one).

    PYTHONPATH=src python examples/torch_train_lm.py [--arch qwen3_14b]
                                                     [--steps 200]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""

import argparse
from pathlib import Path

from repro_torch.configs import registry
from repro_torch.launch.train import train_loop

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_train_lm"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron_4b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch, smoke=True)
    print(f"training {cfg.name} for {args.steps} steps on {args.device} "
          f"(ckpt -> {args.ckpt_dir})")
    _, hist = train_loop(cfg, steps=args.steps, global_batch=8, seq_len=64,
                         ckpt_dir=args.ckpt_dir, ckpt_every=50,
                         log_every=20, device=args.device)
    losses = [h["loss"] for h in hist]
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'check config'})")
    else:
        print(f"nothing to train: {args.ckpt_dir} is at step {args.steps}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
