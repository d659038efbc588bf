"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352; RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        vocab_size=100_352, d_model=5120, n_layers=40,
        n_heads=40, n_kv_heads=10, head_dim=128, d_ff=17_920,
        ffn="swiglu", rope_theta=10_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke",
        vocab_size=512, d_model=80, n_layers=4,
        n_heads=4, n_kv_heads=2, head_dim=20, d_ff=224,
        ffn="swiglu", dtype=torch.float32, remat="none")
