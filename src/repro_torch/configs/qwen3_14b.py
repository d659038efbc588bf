"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA, SwiGLU, RoPE [hf:Qwen/Qwen3-8B; hf]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        vocab_size=151_936, d_model=5120, n_layers=40,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17_408,
        qk_norm=True, ffn="swiglu", rope_theta=1_000_000.0,
        dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        vocab_size=512, d_model=64, n_layers=4,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192,
        qk_norm=True, ffn="swiglu", dtype=torch.float32, remat="none")
