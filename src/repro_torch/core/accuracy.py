"""Accuracy-analysis block and history RAM (paper §3.3), on torch.

``analyze`` is the error-counting pass over a set in one batch-first
clause plane (K2); ``History`` is the fixed-capacity record of per-cycle
accuracies that the FPGA keeps in RAM.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import tm as tm_mod
from repro_torch.core.tm import TMConfig, TMRuntime, TMState


def analyze(cfg: TMConfig, state: TMState, rt: TMRuntime, xs: torch.Tensor,
            ys: torch.Tensor, valid: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Accuracy over the valid rows of a set: 0-dim f32 in [0, 1].

    The reference's float32 sums of 0/1 values are exact below 2**24, so
    integer counts give its bits; the unmasked mean follows XLA's
    sum * (1/n) (:func:`~repro_torch.core.tm.mean_of_count`).
    """
    preds = tm_mod.predict_batch(cfg, state, rt, xs)
    ok = preds == ys.to(torch.int32)
    if valid is None:
        return tm_mod.mean_of_count(ok.sum(), ok.numel())
    v = valid.to(torch.bool)
    hits = (ok & v).sum().to(torch.float32)
    return hits / torch.clamp(v.sum().to(torch.float32), min=1.0)


class History(NamedTuple):
    """Fixed-capacity accuracy history (the paper's history RAM)."""

    values: torch.Tensor  # [capacity, n_sets] f32
    idx: int              # next write slot


def make_history(capacity: int, n_sets: int, device=None) -> History:
    dev = tm_mod.resolve_device(device)
    return History(
        values=torch.full((capacity, n_sets), float("nan"),
                          dtype=torch.float32, device=dev),
        idx=0,
    )


def record(hist: History, row: torch.Tensor) -> History:
    """Append one accuracy row (a no-op when full, like a saturating RAM)."""
    if hist.idx >= hist.values.shape[0]:
        return hist
    values = hist.values.clone()
    values[hist.idx] = row.to(torch.float32)
    return History(values=values, idx=hist.idx + 1)
