"""mamba2-2.7b [ssm] — 64L d_model=2560, attn-free, d_ff=0, vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

Pure mixer stack (no FFN — d_ff=0): each layer is an SSD block with
expand=2 (d_inner=5120), head_dim 64 -> 80 heads, groups=1.
"""

import torch

from repro_torch.models.common import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        vocab_size=50_280, d_model=2560, n_layers=64,
        n_heads=80, n_kv_heads=80, head_dim=64, d_ff=0,
        layer_types=("ssd",) * 64,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        vocab_size=512, d_model=64, n_layers=4,
        n_heads=8, n_kv_heads=8, head_dim=16, d_ff=0,
        layer_types=("ssd",) * 4,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=8),
        tie_embeddings=True, dtype=torch.float32, remat="none")
