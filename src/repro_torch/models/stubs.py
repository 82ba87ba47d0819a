"""Input specs per (arch x shape) and concrete random inputs of the same
structure, the twins of the reference's ``models/stubs.py``.

[audio] archs take precomputed frame embeddings (``embeds_input``) in place
of a frontend; [vlm] archs take the vision frontend's patch embeddings,
projected to d_model, as ``cross_embeds`` (train and prefill batches).
:func:`synthetic_batch` draws from a numpy generator in the order the
reference's ``jax.tree.map`` visits the leaves (sorted keys:
``cross_embeds`` before ``tokens``), so the same seed gives the same
values in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tm import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.params import ShapeDtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs (ShapeDtype leaves) for one cell."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cd = layers.compute_dtype(cfg)

    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.embeds_input:
            batch["embeds"] = ShapeDtype((B, S, cfg.d_model), cd)
            if shape.kind == "train":
                batch["labels"] = ShapeDtype((B, S), i32)
        else:
            batch["tokens"] = ShapeDtype((B, S), i32)
        if cfg.family == "vlm":
            batch["cross_embeds"] = ShapeDtype(
                (B, cfg.n_cross_tokens, cfg.d_model), cd)
        return batch

    if shape.kind == "decode":
        batch = {"pos": ShapeDtype((), i32)}
        if cfg.embeds_input:
            batch["embeds"] = ShapeDtype((B, 1, cfg.d_model), cd)
        else:
            batch["token"] = ShapeDtype((B, 1), i32)
        batch["cache"] = transformer.cache_struct(cfg, B, S)
        return batch

    raise ValueError(shape.kind)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                    device=None) -> dict:
    """Concrete random inputs matching :func:`input_specs` on ``device``
    (the card unless told otherwise). Token ids are int64 (torch indexes
    with them); ``pos`` is a Python int."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def fill(s: ShapeDtype):
        if s.dtype == torch.int32:
            if s.shape == ():
                return min(7, shape.seq_len - 1)
            hi = cfg.vocab_size if cfg.vocab_size > 0 else 2
            return torch.from_numpy(rng.integers(0, hi, s.shape)).to(dev)
        x = 0.02 * rng.standard_normal(s.shape)
        return torch.from_numpy(x).to(device=dev, dtype=s.dtype)

    def walk(node):
        if isinstance(node, ShapeDtype):
            return fill(node)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(input_specs(cfg, shape))
