"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000; GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        vocab_size=256_000, d_model=12_288, n_layers=64,
        n_heads=96, n_kv_heads=8, head_dim=128, d_ff=33_792,
        ffn="swiglu", rope_theta=75_000_000.0, tie_embeddings=True,
        dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke",
        vocab_size=512, d_model=96, n_layers=4,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=256,
        ffn="swiglu", tie_embeddings=True, dtype=torch.float32, remat="none")
