"""Hyperparameter search + cross-validation (paper goal ii, §5), on torch.

Every (ordering x s x T) replica is an independent TM.
:func:`grid_search` is a thin caller of the replica-first engine
(:class:`repro_torch.eval.crossval.CrossValRun`), which runs the whole
sweep over one leading replica axis on one card, or in slabs over a
device mesh (``mesh=``). :func:`_one_cell` is the
per-cell semantics the engine is held to.

The reference also keeps ``grid_search_device``, its pre-engine program
that nests one vmap over orderings in two over the grid, as a benchmark
baseline. The port has no such program: it would be the same per-replica
loop as :func:`_one_cell`, and the engine is its replacement.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core import tm as tm_mod
from repro_torch.core.tm import TMConfig


class GridResult(NamedTuple):
    s_grid: np.ndarray           # [S]
    T_grid: np.ndarray           # [T]
    val_accuracy: torch.Tensor   # [S, T, O] per-ordering validation accuracy
    mean_accuracy: torch.Tensor  # [S, T]


def _one_cell(cfg: TMConfig, s, T, off_x, off_y, val_x, val_y,
              key: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """Train one TM with (s, T) on one ordering's offline set (on the
    device of ``off_x``); return its validation accuracy."""
    dev = off_x.device
    rt = tm_mod.init_runtime(cfg, device=dev)._replace(
        s=torch.as_tensor(s, dtype=torch.float32),
        T=torch.as_tensor(T, dtype=torch.int32))
    state = tm_mod.init_state(cfg, device=dev)
    state = fb_mod.train_epochs(cfg, state, rt, off_x, off_y, key, n_epochs)
    return acc_mod.analyze(cfg, state, rt, val_x, val_y)


def grid_search(cfg: TMConfig, s_values, T_values, off_x, off_y, val_x,
                val_y, *, n_epochs: int = 10, seed: int = 0,
                mesh=None, device=None) -> GridResult:
    """The full (s x T x orderings) sweep on the replica-first engine;
    bitwise looping :func:`_one_cell` over every cell. ``mesh`` shards
    the replica axis (:class:`~repro_torch.eval.crossval.CrossValRun`)."""
    from repro_torch.eval.crossval import CrossValRun

    res = CrossValRun(cfg, device=device, mesh=mesh).sweep(
        off_x, off_y, val_x, val_y, s_values, T_values,
        n_epochs=n_epochs, seed=seed,
    )
    return GridResult(s_grid=res.s_grid, T_grid=res.T_grid,
                      val_accuracy=res.val_accuracy,
                      mean_accuracy=res.mean_accuracy)


def best(result: GridResult) -> tuple[float, int, float]:
    """(s*, T*, mean validation accuracy) of the best grid cell."""
    m = result.mean_accuracy.detach().cpu().numpy()
    i, j = np.unravel_index(np.argmax(m), m.shape)
    return float(result.s_grid[i]), int(result.T_grid[j]), float(m[i, j])
