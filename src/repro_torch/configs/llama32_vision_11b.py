"""llama-3.2-vision-11b  [vlm]  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 — cross-attn image
layers. Pattern: 4 self-attention layers then 1 gated cross-attention layer
(the HF checkpoint inserts 8 cross-attn layers across the 40-layer stack).
The vision frontend is a STUB per the brief: `input_specs()` supplies
precomputed patch embeddings (projected to d_model) as `cross_embeds`.
"""
import dataclasses

from repro_torch.configs.base import CROSS, GLOBAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=(GLOBAL, GLOBAL, GLOBAL, GLOBAL, CROSS),
    rope_theta=500_000.0,
    act="swiglu",
    n_cross_tokens=1601,   # 1 tile x (40x40 patches + cls), projected
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_cross_tokens=9,
        remat="none",
        compute_dtype="float32",
    )
