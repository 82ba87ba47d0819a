"""gemma3-1b  [dense]  [hf:google/gemma-3-1b-pt; unverified]

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global
layer pattern, sliding window 512, head_dim 256 (decoupled from d_model),
tied embeddings. Local-attention dominant => runs long_500k (global layers
at decode are O(1) per token against the cache; see DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import GLOBAL, LOCAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
    sliding_window=512,
    act="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_ok=True,
    remat="dots",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab_size=512, sliding_window=8, remat="none",
        compute_dtype="float32",
    )
