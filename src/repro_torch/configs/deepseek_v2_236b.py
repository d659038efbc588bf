"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512,
d_ff=1536 (expert dim), MoE 160 experts top-6 + 2 shared
[arXiv:2405.04434; hf].

MLA per the paper: qk_nope 128 + qk_rope 64 per head, v_head 128,
kv_lora_rank 512 (only the 512+64 latent is cached at decode).
Simplifications (as in the JAX package): q-LoRA omitted (dense W_q); the paper's
first dense layer is made MoE like the rest (keeps the layer scan uniform).
"""

import torch

from repro_torch.models.common import ModelConfig, MoEConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        vocab_size=102_400, d_model=5120, n_layers=60,
        n_heads=128, n_kv_heads=128, head_dim=128, d_ff=1536,
        layer_types=("mla",) * 60,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_expert=1536),
        moe_layer_types=("moe",) * 60,
        ffn="swiglu", rope_theta=10_000.0, dtype=torch.bfloat16)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        vocab_size=512, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=48,
        layer_types=("mla",) * 3,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=48),
        moe_layer_types=("moe",) * 3,
        ffn="swiglu", dtype=torch.float32, remat="none")
