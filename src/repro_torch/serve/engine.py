"""Batched LM serving engine: prefill + decode with a persistent KV cache.

The twin of the reference's ``serve/engine.py``: fixed batch slots, prompt
prefill, greedy/temperature decode steps, the per-row EOS trim. It serves a
:class:`~repro_torch.models.transformer.Transformer` built from the
parameter tree it is given, on the card unless told otherwise, and runs
under ``torch.inference_mode``. The sampled tokens stay on the device until
the end of ``generate``, so the host does not wait for the card each step.

Temperature sampling keeps the reference's key discipline: the engine's
key is split once a step and the second half draws
``categorical_logits(k, logits / T)``.

A vlm (a stack with CROSS layers) needs ``cross_embeds`` at prefill, which
a batch of prompts does not carry: the reference's ``generate`` fails
inside its prefill (``cross_kv`` is None), and this one raises a
``ValueError`` saying how such a model is served (``Transformer.prefill``
with ``cross_embeds``, then ``decode_step``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.base import CROSS, ModelConfig
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class EngineConfig:
    max_seq: int = 512
    batch_slots: int = 4
    temperature: float = 0.0     # 0 => greedy
    eos_id: int = -1             # -1 => never stops early


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict, ec: EngineConfig,
                 seed: int = 0, *, device=None):
        self.cfg, self.ec = cfg, ec
        self.model = Transformer(cfg, params, device=device)
        self._key = random.PRNGKey(seed, device=self.model.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.ec.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        self._key, k = random.split(self._key)
        T = torch.full((), self.ec.temperature, dtype=torch.float32,
                       device=logits.device)
        return random.categorical_logits(k, logits / T)

    @torch.inference_mode()
    def generate(
        self,
        prompts: np.ndarray,   # [B, S0] int (same length)
        max_new: int,
    ) -> np.ndarray:
        """Greedy/temperature generation for a batch of equal-length
        prompts; returns the new tokens [B, max_new] as int32."""
        B, S0 = prompts.shape
        if B != self.ec.batch_slots:
            raise ValueError(f"{B} prompts for {self.ec.batch_slots} slots")
        if S0 + max_new > self.ec.max_seq:
            raise ValueError(f"{S0} + {max_new} tokens exceed max_seq "
                             f"{self.ec.max_seq}")
        if CROSS in self.cfg.layer_pattern:
            raise ValueError(
                f"{self.cfg.arch_id} has CROSS layers, whose prefill needs "
                "cross_embeds, which generate's prompts do not carry: serve "
                "it through Transformer.prefill({'tokens', 'cross_embeds'}, "
                "max_seq), then decode_step")
        toks = torch.from_numpy(np.asarray(prompts, dtype=np.int64))
        logits, cache = self.model.prefill(
            {"tokens": toks.to(self.model.device)}, self.ec.max_seq)
        tok = self._sample(logits)
        out = [tok]
        for i in range(1, max_new):
            step = {"token": tok[:, None], "pos": S0 + i - 1}
            logits, cache = self.model.decode_step(step, cache)
            tok = self._sample(logits)
            out.append(tok)
        seq = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        if self.ec.eos_id >= 0:
            # trim after first EOS per row (host-side post-processing)
            for b in range(B):
                hits = np.where(seq[b] == self.ec.eos_id)[0]
                if len(hits):
                    seq[b, hits[0] + 1:] = self.ec.eos_id
        return seq
