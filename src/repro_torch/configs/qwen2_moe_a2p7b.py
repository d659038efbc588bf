"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""

import torch

from repro_torch.models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        vocab_size=151_936, d_model=2048, n_layers=24,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408,
        moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
        moe_layer_types=("moe",) * 24,
        ffn="swiglu", rope_theta=1_000_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        vocab_size=512, d_model=64, n_layers=4,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_expert=32),
        moe_layer_types=("moe",) * 4,
        ffn="swiglu", dtype=torch.float32, remat="none")
