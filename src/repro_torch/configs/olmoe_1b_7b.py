"""olmoe-1b-7b  [moe]  [arXiv:2409.02060; hf]

16L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1024 vocab=50304, MoE 64
experts top-8 (d_ff per expert = 1024, no shared/dense residual).
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    layer_pattern=(GLOBAL,),
    act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
        remat="none", compute_dtype="float32",
    )
