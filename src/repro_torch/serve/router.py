"""Ingress: a host-side batch router feeding the ring buffers.

The twin of ``repro.serve.router`` for unpacked rows. Labelled traffic
accumulates in a numpy staging block (``[K, B_ingress]`` rows plus
per-replica fill counts, no device work at all) and flushes through
:func:`_enqueue_rows`, which lands a replica's staged rows in its ring.

Acceptance is decided on the host against the owning service's mirror of
each replica's outstanding rows, so ``submit`` reports backpressure at
once while the device enqueue happens later, batched.

Concurrency: staging is double-buffered, so producers and the flushing
consumer never share an array. Producers fill the *active* block under
:attr:`BatchRouter.lock`; ``take_block`` swaps the blocks, handing the
filled one to the (single) consumer. Lock order is always the service's
device lock, then this lock.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.data import buffer as buf_mod


def _enqueue_rows(buf: buf_mod.RingBuffer, xs: np.ndarray, ys: np.ndarray,
                  count: int) -> tuple[buf_mod.RingBuffer, torch.Tensor]:
    """Push the first ``count`` staged rows (xs [B, f] bool, ys [B] i32)
    into one ring, in submission order. Returns (ring, accepted count as
    a 0-dim device tensor); rows the ring rejects when full are dropped."""
    dev = buf.data_x.device
    x = torch.from_numpy(np.ascontiguousarray(xs[:count])).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(ys[:count])).to(dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(count):
        buf, ok = buf_mod.push(buf, x[i], y[i])
        accepted = accepted + ok.to(torch.int32)
    return buf, accepted


class _StageBlock:
    """One staging block: [K, B] rows + per-replica fill counts."""

    __slots__ = ("x", "y", "count")

    def __init__(self, n_replicas: int, block: int, n_features: int) -> None:
        self.x = np.zeros((n_replicas, block, n_features), dtype=bool)
        self.y = np.zeros((n_replicas, block), dtype=np.int32)
        self.count = np.zeros(n_replicas, dtype=np.int32)


class BatchRouter:
    """Host-side staging queue between producers and the buffers.

    * ``stage_rows(xs, ys, mask, dev_size)`` -- producer side: copy one row
      per masked replica into the active block, accepting it against the
      outstanding-rows mirror (rejections count in ``dropped``). Replicas
      whose staging lane is full come back *blocked*: the caller flushes
      and retries them.
    * ``take_block()`` -- consumer side: swap the blocks and hand over the
      filled one (rows, labels, counts).
    """

    def __init__(self, n_replicas: int, n_features: int, capacity: int,
                 block: int = 32):
        K = n_replicas
        self.n_replicas = K
        self.n_features = n_features
        self.capacity = capacity
        self.block = max(1, min(block, capacity))
        self._blocks = (_StageBlock(K, self.block, n_features),
                        _StageBlock(K, self.block, n_features))
        self._active = 0
        self.lock = threading.RLock()
        self.dropped = np.zeros(K, dtype=np.int64)   # backpressure events
        self.flushes = 0                             # blocks handed over

    @property
    def staged(self) -> np.ndarray:
        """Rows staged but not yet flushed, per replica. [K] i32 (a copy)."""
        with self.lock:
            return self._blocks[self._active].count.copy()

    def lane_full(self) -> bool:
        """True when some replica's staging lane is full."""
        with self.lock:
            return bool((self._blocks[self._active].count >= self.block).any())

    def stage_rows(self, xs, ys, mask,
                   dev_size) -> tuple[np.ndarray, np.ndarray]:
        """Stage one row per masked replica. Returns (accepted, blocked),
        both [K] bool; acceptance is ``dev_size + staged < capacity``."""
        K = self.n_replicas
        xs = np.asarray(xs)
        if xs.dtype == np.uint32:
            raise NotImplementedError(
                "uint32 rows are bit-packed; the port's packed slice has "
                "not landed, so submit bool rows"
            )
        xs = xs.astype(bool)
        if xs.shape != (K, self.n_features):
            xs = np.broadcast_to(xs, (K, self.n_features))
        ys = np.asarray(ys, dtype=np.int32)
        if ys.shape != (K,):
            ys = np.broadcast_to(ys, (K,))
        with self.lock:
            blk = self._blocks[self._active]
            ok = mask & (dev_size + blk.count < self.capacity)
            room = blk.count < self.block
            accepted = ok & room
            blocked = ok & ~room
            idx = np.nonzero(accepted)[0]
            if idx.size:
                c = blk.count[idx]
                blk.x[idx, c] = xs[idx]
                blk.y[idx, c] = ys[idx]
                blk.count[idx] += 1
            self.dropped += mask & ~ok
        return accepted, blocked

    def take_block(self) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Swap the staging blocks; returns the filled (xs [K, B, f],
        ys [K, B], counts [K]) block, or None when nothing is staged. The
        returned arrays are not written again until the next-but-one
        ``take_block``."""
        with self.lock:
            blk = self._blocks[self._active]
            if not blk.count.any():
                return None
            counts = blk.count.copy()
            blk.count[:] = 0
            self._active ^= 1
            self.flushes += 1
            return blk.x, blk.y, counts
