"""Deterministic synthetic token pipeline for LM training/serving (a copy
of the reference's numpy-only module: the same batch for every (seed,
step)).

A Zipf-ish unigram stream with short-range repetition structure so losses
drop measurably within a few hundred steps (pure-uniform tokens give a flat
loss at ln(V)). Seeded and stateless per step index — resuming from a
checkpoint replays the exact same batch sequence (fault-tolerance tests rely
on this).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _batch(cfg: ModelConfig, shape: ShapeConfig, step: int, seed: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B, S = shape.global_batch, shape.seq_len
    V = max(cfg.vocab_size, 2)
    # Zipf unigram over a clipped vocab + copy structure (periodic repeats).
    base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
    toks = np.clip(base, 1, V - 1)
    period = max(4, S // 8)
    idx = np.arange(S)
    copy_mask = (idx % period) >= (period // 2)
    src = np.maximum(idx - period // 2, 0)
    toks[:, copy_mask] = toks[:, src[copy_mask]]
    out: dict = {}
    if cfg.embeds_input:
        emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        out["embeds"] = 0.02 * emb
        out["labels"] = toks.astype(np.int32)
    else:
        out["tokens"] = toks.astype(np.int32)
    if cfg.family == "vlm":
        ce = rng.standard_normal(
            (B, cfg.n_cross_tokens, cfg.d_model)).astype(np.float32)
        out["cross_embeds"] = 0.02 * ce
    return out


def token_batches(cfg: ModelConfig, shape: ShapeConfig,
                  seed: int = 0, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield _batch(cfg, shape, step, seed)
        step += 1
