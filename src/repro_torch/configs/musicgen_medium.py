"""musicgen-medium  [audio]  [arXiv:2306.05284; hf]

48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens. The EnCodec frontend is a STUB per the brief: inputs arrive
as precomputed frame embeddings (`embeds_input=True`), labels are codebook
token ids over the 2048-entry vocab. LayerNorm + GELU per the audiocraft
implementation; positions via RoPE (sinusoidal in the original — recorded as
an adaptation in DESIGN.md).
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=(GLOBAL,),
    norm="layernorm",
    act="gelu",
    embeds_input=True,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, remat="none", compute_dtype="float32",
    )
