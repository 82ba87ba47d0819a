"""recurrentgemma-9b  [hybrid]  [arXiv:2402.19427; unverified]

38L d_model=4096 16H (GQA kv=1 => MQA) d_ff=12288 vocab=256000 — Griffin
pattern: (RG-LRU, RG-LRU, local attention) repeating; lru_width = d_model
(expand=1), local window 2048, GeGLU MLP. 38 = 12x3 + 2 remainder recurrents.
Sub-quadratic => runs the long_500k shape.
"""
import dataclasses

from repro_torch.configs.base import LOCAL, RGLRU, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),
    sliding_window=2048,
    act="geglu",
    ssm=SSMConfig(d_conv=4, expand=1),
    tie_embeddings=True,
    long_context_ok=True,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        sliding_window=8,
        remat="none",
        compute_dtype="float32",
    )
