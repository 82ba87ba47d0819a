"""qwen2.5-14b  [dense]  [hf:Qwen/Qwen2.5-0.5B; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA with QKV bias.
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152_064,
    layer_pattern=(GLOBAL,),
    qkv_bias=True,
    act="swiglu",
    rope_theta=1_000_000.0,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, remat="none", compute_dtype="float32",
    )
