"""Data-source abstraction (paper §3.4.2 offline memory manager, §3.5 online
input subsystem): a copy of the reference's ``repro.data.memory`` (numpy
only).

The TM-management FSM requests rows through a narrow interface; the concrete
source (block ROM, microcontroller stream, sensor IP...) is swappable without
touching the management logic. We keep that layering: ``DataSource`` is the
interface, ``ROMSource`` mirrors the paper's on-chip ROM with a cyclic
cross-correlation read pattern, ``StreamSource`` wraps a host iterator (the
microcontroller/UART path).
"""
from __future__ import annotations

from typing import Iterator, Protocol

import numpy as np


class DataSource(Protocol):
    n_features: int

    def next_row(self) -> tuple[np.ndarray, int]:
        """Return (x [f] bool, y int). Sources are infinite (cyclic)."""
        ...


class ROMSource:
    """Cyclic reader over an in-memory array — the paper's on-chip ROM."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray):
        assert len(xs) == len(ys) and len(xs) > 0
        self.xs = np.asarray(xs, dtype=bool)
        self.ys = np.asarray(ys, dtype=np.int32)
        self.n_features = self.xs.shape[1]
        self._i = 0

    def next_row(self) -> tuple[np.ndarray, int]:
        x, y = self.xs[self._i], int(self.ys[self._i])
        self._i = (self._i + 1) % len(self.xs)
        return x, y


class StreamSource:
    """Wraps a host iterator of (x, y) pairs (microcontroller/UART analogue)."""

    def __init__(self, it: Iterator[tuple[np.ndarray, int]], n_features: int):
        self._it = it
        self.n_features = n_features

    def next_row(self) -> tuple[np.ndarray, int]:
        return next(self._it)
