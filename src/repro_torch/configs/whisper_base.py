"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865;
enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

The modality frontend is a stub: the caller provides precomputed frame
embeddings (B, 1500, 512) standing in for the
2x-conv-downsampled log-mel features; the 6-layer encoder and the 6-layer
decoder (self + cross attention, GELU FFN) are real.
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        vocab_size=51_865, d_model=512, n_layers=6,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
        encoder_layers=6, encoder_ctx=1500,
        ffn="gelu", rope_theta=10_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        encoder_layers=2, encoder_ctx=12,
        ffn="gelu", dtype=torch.float32, remat="none")
