"""Ingress: a host-side batch router feeding the ring buffers.

The twin of ``repro.serve.router``. Labelled traffic accumulates in a
numpy staging block (``[K, B_ingress]`` rows plus per-replica fill counts,
no device work at all) and flushes through :func:`_enqueue_rows`, which
lands a whole block in all K rings with a fixed handful of device ops,
whatever K and B are.

A packed router (DESIGN.md §13 of the reference) stages rows as
ceil(f/32) ``np.uint32`` words: bool rows pack on the host at the staging
boundary (:func:`~repro_torch.kernels.packing.pack_bits_np`) and already
packed uint32 rows pass through. An unpacked router refuses uint32 rows.

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
from repro_torch.kernels import packing


def _rows_to_device(xs: np.ndarray, device) -> torch.Tensor:
    """A staged block to the device: bool rows as bool, np.uint32 words as
    the port's int32 words (same bits)."""
    if xs.dtype == np.uint32:
        return packing.words_from_numpy(xs).to(device)
    return torch.from_numpy(np.ascontiguousarray(xs)).to(device)


def _enqueue_rows(bufs: buf_mod.RingBuffer, xs: np.ndarray, ys: np.ndarray,
                  counts: np.ndarray) -> tuple[buf_mod.RingBuffer,
                                               torch.Tensor]:
    """Push the first ``counts[r]`` staged rows of ``xs [K, B, w]`` /
    ``ys [K, B]`` into ring r, for every r at once (rings with a leading
    K). Returns (rings, accepted [K] i32 on the device).

    Bit for bit the reference's sequential pushes: nothing pops during a
    flush, so ring r takes ``acc = min(counts[r], cap - size[r])`` rows,
    row i landing in slot ``(head + size + i) % cap``, and rejects the
    rest. The write is one gather per ring slot: slot s takes staged row
    ``(s - head - size) % cap`` when that is below ``acc``, else keeps its
    row.
    """
    dev = bufs.data_x.device
    K, B = ys.shape
    cap = bufs.capacity
    x = _rows_to_device(xs, dev)
    y = torch.from_numpy(np.ascontiguousarray(ys)).to(dev)
    c = torch.from_numpy(np.asarray(counts, dtype=np.int32)).to(dev)
    acc = torch.minimum(c, torch.clamp(cap - bufs.size, min=0))     # [K]
    slots = torch.arange(cap, device=dev, dtype=torch.int32)
    idx = torch.remainder(slots - (bufs.head + bufs.size)[:, None], cap)
    take = idx < acc[:, None]                                       # [K, cap]
    src = torch.clamp(idx, max=B - 1).long()
    k = torch.arange(K, device=dev)[:, None]
    new_x = torch.where(take[..., None], x[k, src], bufs.data_x)
    new_y = torch.where(take, y[k, src], bufs.data_y)
    out = bufs._replace(data_x=new_x, data_y=new_y, size=bufs.size + acc)
    return out, acc


class _StageBlock:
    """One staging block: [K, B] rows + per-replica fill counts."""

    __slots__ = ("x", "y", "count")

    def __init__(self, n_replicas: int, block: int, row_shape: tuple,
                 dtype) -> None:
        self.x = np.zeros((n_replicas, block) + row_shape, dtype=dtype)
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
      filled one (rows, labels, counts); ``take_lanes(rids)`` takes only
      the named replicas' rows.
    """

    def __init__(self, n_replicas: int, n_features: int, capacity: int,
                 block: int = 32, *, packed: bool = False):
        K = n_replicas
        self.n_replicas = K
        self.n_features = n_features
        self.capacity = capacity
        self.block = max(1, min(block, capacity))
        self.packed = packed
        if packed:
            row_shape, dtype = (packing.n_words(n_features),), np.uint32
        else:
            row_shape, dtype = (n_features,), np.dtype(bool)
        self._blocks = (_StageBlock(K, self.block, row_shape, dtype),
                        _StageBlock(K, self.block, row_shape, dtype))
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

    def _route_rows(self, xs) -> tuple[np.ndarray, bool]:
        """Producer rows by dtype: bool rows pass (and pack later on a
        packed router); uint32 word rows pass through on a packed router
        and are refused on an unpacked one. Returns (rows broadcast to
        [K, width], already packed?)."""
        K = self.n_replicas
        xs = np.asarray(xs)
        if xs.dtype == np.uint32:
            if not self.packed:
                raise TypeError(
                    "uint32 rows look bit-packed (DESIGN.md §13) but this "
                    "router stages unpacked bool rows — build the service "
                    "with ServiceConfig(packed=True) or submit bool rows"
                )
            W = packing.n_words(self.n_features)
            if xs.shape != (K, W):
                xs = np.broadcast_to(xs, (K, W))
            return xs, True
        xs = xs.astype(bool)
        if xs.shape != (K, self.n_features):
            xs = np.broadcast_to(xs, (K, self.n_features))
        return xs, False

    def stage_rows(self, xs, ys, mask,
                   dev_size) -> tuple[np.ndarray, np.ndarray]:
        """Stage one row per masked replica. Returns (accepted, blocked),
        both [K] bool; acceptance is ``dev_size + staged < capacity``."""
        K = self.n_replicas
        xs, already_packed = self._route_rows(xs)
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
                if self.packed and not already_packed:
                    blk.x[idx, c] = packing.pack_bits_np(xs[idx])
                else:
                    blk.x[idx, c] = xs[idx]
                blk.y[idx, c] = ys[idx]
                blk.count[idx] += 1
            self.dropped += mask & ~ok
        return accepted, blocked

    def take_lanes(self, rids
                   ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Take only the named replicas' staged rows out of the active
        block (copies; their lane counts go to 0, so producers restage from
        the front). Returns (xs [n, B, w], ys [n, B], counts [n]), or None
        when none of the named lanes holds rows.

        The scoped flush of :meth:`TMService.evict`: landing a few
        replicas' rows before a spill must not flush the whole fleet, and
        the other lanes' staged rows stay where they are. Like
        ``take_block`` it assumes one consumer (the service's device lock);
        outside a flush the inactive block holds no rows, so the active
        block is the only staged storage."""
        with self.lock:
            blk = self._blocks[self._active]
            rids = np.asarray(rids, dtype=np.int64).reshape(-1)
            counts = blk.count[rids].copy()
            if not counts.any():
                return None
            xs = blk.x[rids].copy()
            ys = blk.y[rids].copy()
            blk.count[rids] = 0
            return xs, ys, counts

    def take_block(self) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Swap the staging blocks; returns the filled (xs [K, B, w],
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
