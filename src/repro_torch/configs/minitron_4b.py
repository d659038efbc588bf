"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000; pruned nemotron [arXiv:2407.14679; hf]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        vocab_size=256_000, d_model=3072, n_layers=32,
        n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216,
        ffn="swiglu", rope_theta=10_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        vocab_size=512, d_model=48, n_layers=4,
        n_heads=3, n_kv_heads=1, head_dim=16, d_ff=144,
        ffn="swiglu", dtype=torch.float32, remat="none")
