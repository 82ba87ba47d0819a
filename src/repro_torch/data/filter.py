"""Class filter IP (paper §3.4.1), on torch.

Removes a chosen class from a data stream under an external enable signal:
the unseen-class-introduction use case (§5.2). Shapes stay fixed: filtering
yields a *validity mask* instead of resizing tensors, so toggling the
enable at runtime changes no shape (the paper's no-re-synthesis property).
The twin of the reference's ``repro.data.filter``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tm


def class_filter_mask(ys, filtered_class, enabled,
                      base_valid: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """Validity mask [n] bool: rows of ``filtered_class`` dropped while
    ``enabled`` (a bool, or a 0-dim bool tensor: the external signal).
    Runs on a tensor ``ys``'s device, else on ``device`` (the card unless
    the caller names another)."""
    if not torch.is_tensor(ys):
        ys = torch.as_tensor(ys, device=tm.resolve_device(device))
    enabled = torch.as_tensor(enabled, dtype=torch.bool, device=ys.device)
    keep = torch.where(enabled, ys != filtered_class, True)
    if base_valid is not None:
        keep = keep & base_valid
    return keep


def limit_mask(n: int, limit, device=None) -> torch.Tensor:
    """Validity mask [n] bool enabling only the first ``limit`` rows (e.g.
    the paper's §5.1 use of 20 of the 30 offline rows). Runs on a tensor
    ``limit``'s device, else on ``device`` (the card unless the caller
    names another)."""
    if torch.is_tensor(limit):
        device = limit.device
    else:
        device = tm.resolve_device(device)
    return torch.arange(n, device=device) < limit
