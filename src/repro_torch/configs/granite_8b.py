"""granite-8b  [dense]  [arXiv:2405.04324; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 — llama-architecture
code model (RoPE + SwiGLU + RMSNorm).
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    layer_pattern=(GLOBAL,),
    act="swiglu",
    rope_theta=10_000.0,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, remat="none", compute_dtype="float32",
    )
