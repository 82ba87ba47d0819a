"""Hand-written optimizers, the twins of the reference's
``train/optimizer.py``: AdamW and SGD (momentum), cosine / linear warm-up
schedules, global-norm clipping. No ``torch.optim``: the arithmetic is
the reference's, op for op.

Optimizer state mirrors the parameter tree. ``OptState.step`` is a 0-d
int32 tensor; the moments are stored in ``moment_dtype`` and every update
is computed in float32. Where the reference divides by a Python number,
the port divides by a float32 tensor on the same device: CUDA turns a
division by a Python scalar into a product with its reciprocal, and
``scalar / tensor`` is ``reciprocal() * scalar`` on every device. With
those, :func:`apply` is bitwise the reference's where XLA's and torch's
float32 ``pow`` and ``cos`` agree (``tests/test_torch_train_substrate.py``
measures where they do not).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Any              # first moment (or momentum for sgd)
    nu: Any              # second moment (adamw only; zeros tree for sgd)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device."""
    return torch.full((), value, dtype=_F32, device=like.device)


def init(cfg: OptConfig, params) -> OptState:
    """Zero moments laid out like their parameters (a DTensor parameter's
    moments are DTensors of its placements: ZeRO), and a step of 0."""
    dt = _DTYPES[cfg.moment_dtype]
    zeros = T.map(lambda p: torch.zeros_like(p, dtype=dt), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=T.leaves(params)[0].device)
    return OptState(step=step, mu=zeros, nu=T.map(torch.zeros_like, zeros))


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(_F32)
    warm = torch.clamp_max((s + 1.0) / _f32(max(cfg.warmup_steps, 1), s),
                           1.0)
    if cfg.schedule in ("cosine", "linear"):
        t = torch.clamp((s - cfg.warmup_steps)
                        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
        else:
            decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm), in float32,
    and cast back to the gradient's dtype (so bfloat16 gradients are rounded
    after clipping, as in the reference). Returns (grads, norm). On
    DTensor gradients each leaf's sum of squares is a partial sum over its
    shards, so the norm covers every shard (the sum is reduced across the
    ranks before the square root), and every rank scales by the same
    number."""
    gn = torch.sqrt(sum(torch.square(g.to(_F32)).sum()
                        for g in T.leaves(grads)))
    scale = torch.clamp_max(_f32(max_norm, gn) / torch.clamp_min(gn, 1e-9),
                            1.0)
    return T.map(lambda g: (g.to(_F32) * scale).to(g.dtype), grads), gn


def apply(cfg: OptConfig, state: OptState, params, grads, *,
          donate: bool = False):
    """One update. Returns (new_params, new_state, metrics).

    DTensor leaves (parameters, moments and gradients laid out alike:
    ``train_step`` puts each gradient in its parameter's layout first)
    update shard by shard: every op is element-wise on equal placements.

    ``donate=True`` is the reference's ``donate_argnums``: every leaf of
    ``params``, ``state.mu`` and ``state.nu`` is overwritten with its new
    value as soon as that is computed, so the step holds one leaf's
    temporaries beside the state, not a second state, and ``state.step``
    is advanced in place. The returned trees then hold the given tensors,
    so ``params`` and ``state`` stay one consistent (new) state."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    lr = schedule_lr(cfg, state.step)
    t = (state.step + 1).to(_F32)
    mdt = _DTYPES[cfg.moment_dtype]

    if cfg.name == "sgd":
        def upd(p, g, m, v):
            m = (cfg.b1 * m.to(_F32) + g.to(_F32)).to(mdt)
            return (p.to(_F32) - lr * m.to(_F32)).to(p.dtype), m, v
    else:
        bc1 = 1.0 - torch.pow(_f32(cfg.b1, t), t)
        bc2 = 1.0 - torch.pow(_f32(cfg.b2, t), t)

        def upd(p, g, m, v):
            g32 = g.to(_F32)
            m32 = cfg.b1 * m.to(_F32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.to(_F32) + (1 - cfg.b2) * g32 * g32
            del g32
            step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            p32 = p.to(_F32)
            p32 = p32 - lr * (step_ + cfg.weight_decay * p32)
            return p32.to(p.dtype), m32.to(mdt), v32.to(mdt)

    flat_p = T.leaves(params)
    flat_g = T.leaves(grads)
    flat_m, flat_v = T.leaves(state.mu), T.leaves(state.nu)
    del grads
    out = []
    for i, (p, m, v) in enumerate(zip(flat_p, flat_m, flat_v)):
        g, flat_g[i] = flat_g[i], None      # each clipped gradient goes
        new = upd(p, g, m, v)               # as soon as it is used
        del g
        if donate:
            for old, x in zip((p, m, v), new):
                if old is not x:
                    old.copy_(x)
            new = (p, m, v)
        out.append(new)
    step = state.step.add_(1) if donate else state.step + 1
    return (T.unflatten(params, [o[0] for o in out]),
            OptState(step, T.unflatten(params, [o[1] for o in out]),
                     T.unflatten(params, [o[2] for o in out])),
            {"lr": lr, "grad_norm": gnorm})
