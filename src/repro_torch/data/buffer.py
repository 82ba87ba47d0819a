"""Cyclic online-input buffer (paper §3.5.2), on torch.

A fixed-shape ring in device memory: rows, labels, and head/size counters
as int32 tensors. ``pop`` and ``pop_many`` are functional (they return a
new ring and never write into the old one) and never wait on the device:
the head and size stay on it, and rows move with index ops. Rows arrive
in blocks through the router's vectorised enqueue
(:func:`repro_torch.serve.router._enqueue_rows`).

A ring stores bool feature rows, or packed rows of ceil(f/32) int32 words
(``make(..., packed=True)``, the port's word type,
:mod:`repro_torch.kernels.packing`). A fleet keeps K rings as one
``RingBuffer`` whose leaves carry a leading K (``data_x [K, cap, ...]``,
``head``/``size`` [K]); :func:`pop_many` pops all K at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import packing


class RingBuffer(NamedTuple):
    data_x: torch.Tensor  # [capacity, f] bool, or [capacity, ceil(f/32)] int32
    data_y: torch.Tensor  # [capacity] int32
    head: torch.Tensor    # 0-dim int32: next slot to pop
    size: torch.Tensor    # 0-dim int32: valid entries

    @property
    def capacity(self) -> int:
        return self.data_x.shape[-2]


def make(capacity: int, n_features: int, device=None, *,
         packed: bool = False) -> RingBuffer:
    """An empty ring: bool rows, or with ``packed`` rows of ceil(f/32)
    words (1/8 of the bool footprint); producers then enqueue packed
    rows."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if packed:
        data_x = torch.zeros((capacity, packing.n_words(n_features)),
                             dtype=packing.WORD_DTYPE, device=device)
    else:
        data_x = torch.zeros((capacity, n_features), dtype=torch.bool,
                             device=device)
    return RingBuffer(
        data_x=data_x,
        data_y=torch.zeros((capacity,), dtype=torch.int32, device=device),
        head=zero,
        size=zero.clone(),
    )


def pop(buf: RingBuffer
        ) -> tuple[RingBuffer, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Remove the oldest datapoint. Returns (ring, x, y, valid?). Popping
    an empty ring gives valid=False, the row at the head, and the ring
    unchanged."""
    empty = buf.size <= 0
    h = buf.head.reshape(1).long()
    x = buf.data_x.index_select(0, h)[0]
    y = buf.data_y.index_select(0, h)[0]
    out = RingBuffer(
        data_x=buf.data_x,
        data_y=buf.data_y,
        head=torch.where(empty, buf.head,
                         torch.remainder(buf.head + 1, buf.capacity)),
        size=torch.where(empty, buf.size, buf.size - 1),
    )
    return out, x, y, ~empty


def pop_many(bufs: RingBuffer
             ) -> tuple[RingBuffer, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pop` on K rings at once (leaves with a leading K): one gather
    of each ring's row at its head, no loop over the rings. Returns
    (rings, x [K, ...], y [K], valid [K])."""
    empty = bufs.size <= 0
    k = torch.arange(bufs.data_x.shape[0], device=bufs.head.device)
    h = bufs.head.long()
    out = bufs._replace(
        head=torch.where(empty, bufs.head,
                         torch.remainder(bufs.head + 1, bufs.capacity)),
        size=torch.where(empty, bufs.size, bufs.size - 1),
    )
    return out, bufs.data_x[k, h], bufs.data_y[k, h], ~empty


def stack(buf: RingBuffer, n: int) -> RingBuffer:
    """``n`` copies of one ring as a K = n ring plane (fresh storage)."""
    return RingBuffer(*(a.expand((n,) + a.shape).clone() for a in buf))
