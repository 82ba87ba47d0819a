"""Fault controller (paper §3.1.2, §5.3), on torch.

Stuck-at faults are injected by forcing TA action outputs through AND/OR
masks: ``action' = (action & and_mask) | or_mask``. Fault-free operation is
and=1 / or=0. The masks live in :class:`~repro_torch.core.tm.TMRuntime`,
are addressable per TA, and can be rewritten at run time, exactly the
paper's microcontroller-programmable fault mappings. The masks are made
with numpy, so both packages make the same masks from the same arguments.

The fault controller is a bitwise circuit, so it commutes with packing:
``packed_masks`` packs the runtime's masks to the literal-word layout and
``apply_packed`` runs the AND/OR on include words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tm import TMConfig, TMRuntime, resolve_device
from repro_torch.kernels import packing


def _shape(cfg: TMConfig) -> tuple[int, int, int]:
    return (cfg.max_classes, cfg.max_clauses, cfg.n_literals)


def fault_free_masks(cfg: TMConfig, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(and_mask all True, or_mask all False), [C, J, L] bool on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return (torch.ones(_shape(cfg), dtype=torch.bool, device=dev),
            torch.zeros(_shape(cfg), dtype=torch.bool, device=dev))


def _masks(cfg: TMConfig, idx: np.ndarray, stuck_value: int):
    total = int(np.prod(_shape(cfg)))
    and_mask = np.ones(total, dtype=bool)
    or_mask = np.zeros(total, dtype=bool)
    if stuck_value == 0:
        and_mask[idx] = False   # ANDed signal 0 => output always 0
    else:
        or_mask[idx] = True     # ORed signal 1 => output always 1
    return and_mask.reshape(_shape(cfg)), or_mask.reshape(_shape(cfg))


def even_spread_stuck_at(cfg: TMConfig, fraction: float, stuck_value: int,
                         *, offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Evenly spread stuck-at faults over the flattened TA bank: every
    k-th TA, k = 1/fraction (§5.3.1). Returns (and_mask, or_mask) as numpy
    bool arrays."""
    total = int(np.prod(_shape(cfg)))
    n_faults = int(round(total * fraction))
    idx = np.zeros(0, dtype=np.int64)
    if n_faults > 0:
        idx = (np.floor(np.arange(n_faults) * (total / n_faults))
               .astype(np.int64) + offset) % total
    return _masks(cfg, idx, stuck_value)


def random_stuck_at(cfg: TMConfig, fraction: float, stuck_value: int,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Uniform-random stuck-at faults without replacement, drawn with
    numpy's ``default_rng(seed)`` as the reference draws them."""
    total = int(np.prod(_shape(cfg)))
    n_faults = int(round(total * fraction))
    idx = np.random.default_rng(seed).choice(total, size=n_faults,
                                             replace=False)
    return _masks(cfg, idx, stuck_value)


def packed_masks(cfg: TMConfig, rt: TMRuntime
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The runtime's fault masks packed to the literal-word layout (int32
    words, :mod:`repro_torch.kernels.packing`). Both have zero tail bits,
    so ``pack((inc & and) | or) == (pack(inc) & pack(and)) | pack(or)``."""
    return (packing.pack_include(rt.ta_and_mask, cfg.n_features),
            packing.pack_include(rt.ta_or_mask, cfg.n_features))


def apply_packed(include_packed: torch.Tensor, and_packed: torch.Tensor,
                 or_packed: torch.Tensor) -> torch.Tensor:
    """The packed-domain fault controller: action' words from action
    words."""
    return (include_packed & and_packed) | or_packed


def stuck_at_runtime(cfg: TMConfig, rt: TMRuntime, fraction: float,
                     stuck_value: int, *, seed: int | None = None,
                     offset: int = 0) -> TMRuntime:
    """One-call §5.3 injection: ``seed=None`` gives the deterministic even
    spread, an integer seed draws :func:`random_stuck_at` faults."""
    if seed is None:
        masks = even_spread_stuck_at(cfg, fraction, stuck_value,
                                     offset=offset)
    else:
        masks = random_stuck_at(cfg, fraction, stuck_value, seed)
    return inject(rt, *masks)


def _bool_on(mask, dev) -> torch.Tensor:
    if not torch.is_tensor(mask):
        mask = torch.from_numpy(np.asarray(mask, dtype=bool))
    return mask.to(dev, torch.bool)


def inject(rt: TMRuntime, and_mask, or_mask) -> TMRuntime:
    """Write new fault mappings (numpy or tensors) into the runtime, on the
    device of its masks (the microcontroller write)."""
    dev = rt.ta_and_mask.device
    return rt._replace(ta_and_mask=_bool_on(and_mask, dev),
                       ta_or_mask=_bool_on(or_mask, dev))


def clear(cfg: TMConfig, rt: TMRuntime) -> TMRuntime:
    """Fault-free masks on the device of the runtime's masks."""
    a, o = fault_free_masks(cfg, device=rt.ta_and_mask.device)
    return rt._replace(ta_and_mask=a, ta_or_mask=o)
