"""Accuracy-analysis block and history RAM (paper §3.3), on torch.

``analyze`` is the error-counting pass over a set in one batch-first
clause plane (K2, or K5 for packed rows); ``analyze_replicated`` and
``analyze_sets_replicated`` do the same for R machines in one
replica-first plane (K4, or K6 for packed rows); ``analyze_pruned`` and
``analyze_pruned_replicated`` measure the budgeted serve path (K7). Packed sets (the port's
int32 words) route through ``core/tm``'s dtype routing. ``History`` is
the fixed-capacity record of per-cycle accuracies that the FPGA keeps in
RAM.
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
    return _reduce(tm_mod.predict_batch(cfg, state, rt, xs), ys, valid)


def _reduce(preds: torch.Tensor, ys: torch.Tensor,
            valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The accuracy reduction of :func:`analyze`: 0-dim f32."""
    ok = preds == ys.to(torch.int32)
    if valid is None:
        return tm_mod.mean_of_count(ok.sum(), ok.numel())
    v = valid.to(torch.bool)
    hits = (ok & v).sum().to(torch.float32)
    return hits / torch.clamp(v.sum().to(torch.float32), min=1.0)


def analyze_pruned(cfg: TMConfig, state: TMState, rt: TMRuntime,
                   xs: torch.Tensor, ys: torch.Tensor, sel,
                   weights: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accuracy of the budgeted serve path over a set: 0-dim f32, the
    reduction of :func:`analyze` over ``predict_batch_pruned_``'s
    predictions (only the ``sel``-elected clauses contracted, K7). With a
    full-permutation ``sel`` and unit weights it is :func:`analyze`, bit
    for bit."""
    return _reduce(tm_mod.predict_batch_pruned_(cfg, state, rt, xs, sel,
                                                weights), ys, valid)


def analyze_pruned_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                              xs: torch.Tensor, ys: torch.Tensor, sel,
                              weights: Optional[torch.Tensor] = None,
                              valid: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Per-replica budgeted accuracy [R] f32: replica r analyzes set r % D
    of xs [D, m, ...] through its own ranking sel[r]."""
    preds = tm_mod.predict_batch_pruned_replicated_(cfg, state, rt, xs, sel,
                                                    weights)
    return _reduce_replicated(preds, ys, valid)


def analyze_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                       xs: torch.Tensor, ys: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-replica accuracy [R] f32: replica r analyzes set r % D of xs
    [D, m, f], ys [D, m], valid [D, m], bitwise :func:`analyze` on it."""
    preds = tm_mod.predict_batch_replicated_(cfg, state, rt, xs)  # [R, m]
    return _reduce_replicated(preds, ys, valid)


def _reduce_replicated(preds: torch.Tensor, ys: torch.Tensor,
                       valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The accuracy reduction of :func:`analyze_replicated`: preds [R, m],
    ys / valid [D, m] tiled R / D times along the replica axis. [R] f32."""
    H = preds.shape[0] // ys.shape[0]
    ok = preds == ys.to(torch.int32).repeat(H, 1)
    if valid is None:
        return tm_mod.mean_of_count(ok.sum(-1), ok.shape[-1])
    v = valid.to(torch.bool).repeat(H, 1)
    hits = (ok & v).sum(-1).to(torch.float32)
    return hits / torch.clamp(v.sum(-1).to(torch.float32), min=1.0)


def analyze_sets_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                            sets) -> torch.Tensor:
    """Per-replica accuracy over many sets in one K4 launch: [R, n_sets].

    ``sets`` is a list of (xs [D, m_i, f], ys [D, m_i], valid [D, m_i] or
    None), all with the same D. The sets are concatenated along the batch
    axis, so the include banks are read once for all of them; each set's
    reduction is :func:`analyze_replicated`'s over its own columns.
    """
    xs = torch.cat([x for x, _, _ in sets], dim=1)
    preds = tm_mod.predict_batch_replicated_(cfg, state, rt, xs)
    out, off = [], 0
    for x, y, valid in sets:
        m = x.shape[1]
        out.append(_reduce_replicated(preds[:, off:off + m], y, valid))
        off += m
    return torch.stack(out, dim=-1)


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
