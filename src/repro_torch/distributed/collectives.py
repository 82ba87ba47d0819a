"""Gradient compression with error feedback, the twin of the reference's
``distributed/collectives.py``.

int8 quantised gradients (per-tensor max-abs scaling) with an error-feedback
residual, so the compression bias does not accumulate [Seide et al. 2014;
Karimireddy et al. 2019]. On one device nothing crosses a network: the step
quantises, dequantises and carries the residual, as the reference does
before its (sharding-boundary) reduction.

Given the same float32 inputs this is bitwise the reference's: ``round``
is half to even in both packages, and the scale is ``max(max|x|, 1e-12) /
127`` in float32, divided by a tensor (CUDA turns a division by a Python
scalar into a product with its reciprocal).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class CompressionState(NamedTuple):
    residual: Any  # error-feedback tree, same structure as grads


def init_state(params) -> CompressionState:
    return CompressionState(residual=T.map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / d127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, state: CompressionState
                   ) -> tuple[Any, CompressionState, dict]:
    """Quantise (grad + residual) to int8; return the dequantised grads, the
    new residuals and ``{"compress_err_l1": sum |residual|}``."""

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = _quantize_int8(g32)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    outs = [one(g, r) for g, r in zip(T.leaves(grads),
                                      T.leaves(state.residual))]
    new_g = T.unflatten(grads, [o[0] for o in outs])
    new_r = T.unflatten(grads, [o[1] for o in outs])
    err = sum(r.abs().sum() for r in T.leaves(new_r))
    return new_g, CompressionState(residual=new_r), {"compress_err_l1": err}
