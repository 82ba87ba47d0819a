"""arctic-480b  [moe]  [hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
PLUS a dense residual MLP in parallel (Arctic's dense-MoE hybrid). Adam
moments in bf16 so the FSDP-sharded optimizer state fits v5e HBM (see
DESIGN.md §6).
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    layer_pattern=(GLOBAL,),
    act="swiglu",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
    adam_dtype="bfloat16",
    train_microbatches=1,
    remat="full",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      dense_residual=True),
        adam_dtype="float32", remat="none", compute_dtype="float32",
    )
