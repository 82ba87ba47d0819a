"""Cyclic online-input buffer (paper §3.5.2), on torch.

A fixed-shape ring in device memory: rows, labels, and head/size counters
as 0-dim int32 tensors. ``push`` and ``pop`` are functional (they return a
new ring and never write into the old one) and never wait on the device:
the head and size stay on it, and rows move with index ops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RingBuffer(NamedTuple):
    data_x: torch.Tensor  # [capacity, f] bool
    data_y: torch.Tensor  # [capacity] int32
    head: torch.Tensor    # 0-dim int32: next slot to pop
    size: torch.Tensor    # 0-dim int32: valid entries

    @property
    def capacity(self) -> int:
        return self.data_x.shape[0]


def make(capacity: int, n_features: int, device=None) -> RingBuffer:
    """An empty ring of unpacked bool rows."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return RingBuffer(
        data_x=torch.zeros((capacity, n_features), dtype=torch.bool,
                           device=device),
        data_y=torch.zeros((capacity,), dtype=torch.int32, device=device),
        head=zero,
        size=zero.clone(),
    )


def push(buf: RingBuffer, x: torch.Tensor, y: torch.Tensor
         ) -> tuple[RingBuffer, torch.Tensor]:
    """Append one datapoint. Returns (ring, accepted?). A full ring rejects
    the push and is returned unchanged (backpressure for the caller)."""
    cap = buf.capacity
    full = buf.size >= cap
    tail = torch.remainder(buf.head + buf.size, cap).reshape(1).long()
    new_x = buf.data_x.index_copy(0, tail, x.reshape(1, -1).to(torch.bool))
    new_y = buf.data_y.index_copy(0, tail, y.reshape(1).to(torch.int32))
    out = RingBuffer(
        data_x=torch.where(full, buf.data_x, new_x),
        data_y=torch.where(full, buf.data_y, new_y),
        head=buf.head,
        size=torch.where(full, buf.size, buf.size + 1),
    )
    return out, ~full


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
