"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

The vision tower is a stub: the caller provides the patch embeddings
(B, 1601, 4096); in the RAG path, retrieved vectors projected to d_model.  Every 5th decoder layer is a cross-attention
layer over those patches (8 of the 40 layers), matching the published
interleave.
"""

import torch

from repro_torch.models.common import ModelConfig

_PATTERN = ("attn", "attn", "attn", "attn", "cross_attn")


def config() -> ModelConfig:
    n_layers = 40
    return ModelConfig(
        name="llama-3.2-vision-11b",
        vocab_size=128_256, d_model=4096, n_layers=n_layers,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14_336,
        layer_types=tuple(_PATTERN[i % 5] for i in range(n_layers)),
        vision_ctx=1601,
        ffn="swiglu", rope_theta=500_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    n_layers = 5
    return ModelConfig(
        name="llama-vision-smoke",
        vocab_size=512, d_model=64, n_layers=n_layers,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192,
        layer_types=tuple(_PATTERN[i % 5] for i in range(n_layers)),
        vision_ctx=12,
        ffn="swiglu", dtype=torch.float32, remat="none")
