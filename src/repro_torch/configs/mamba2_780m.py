"""mamba2-780m  [ssm]  [arXiv:2405.21060; unverified]

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality) blocks: expand=2 (d_inner 3072), head_dim 64
(48 SSD heads), conv4. No MLP (the Mamba block is the whole layer).
Attention-free => runs long_500k (O(1)/token decode state).
"""
import dataclasses

from repro_torch.configs.base import SSD, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,          # unused by SSD; kept for schema completeness
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(SSD,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    long_context_ok=True,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        remat="none", compute_dtype="float32",
    )
