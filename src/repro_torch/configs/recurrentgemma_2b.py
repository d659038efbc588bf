"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (GQA kv=1 -> MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf].  Pattern (rec, rec, local-attn) repeating; 26 = 3x8
+ 2 trailing recurrent layers.  Local window 2048; GeGLU FFN; head_dim 256.
"""

import torch

from repro_torch.models.common import ModelConfig, RGLRUConfig

_PATTERN = ("rglru", "rglru", "attn_local")


def config() -> ModelConfig:
    n_layers = 26
    return ModelConfig(
        name="recurrentgemma-2b",
        vocab_size=256_000, d_model=2560, n_layers=n_layers,
        n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680,
        layer_types=tuple(_PATTERN[i % 3] for i in range(n_layers)),
        ffn="geglu", window=2048,
        rglru=RGLRUConfig(d_rnn=2560, conv_width=4),
        rope_theta=10_000.0, tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    n_layers = 5   # 3 + 2 tail: exercises the non-divisible grouping
    return ModelConfig(
        name="recurrentgemma-smoke",
        vocab_size=512, d_model=64, n_layers=n_layers,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=192,
        layer_types=tuple(_PATTERN[i % 3] for i in range(n_layers)),
        ffn="geglu", window=8,
        rglru=RGLRUConfig(d_rnn=64, conv_width=4),
        tie_embeddings=True, dtype=torch.float32, remat="none")
