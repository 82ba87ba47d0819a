"""phi3-medium-14b  [dense]  [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 — RoPE SwiGLU GQA.
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    layer_pattern=(GLOBAL,),
    act="swiglu",
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=80, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=256, remat="none", compute_dtype="float32",
    )
