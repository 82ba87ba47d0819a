"""The train step: microbatched gradient accumulation + optimizer update,
the twin of the reference's ``train/train_step.py``.

The reference scans over microbatches inside one jitted call and may donate
the old state's buffers; the port loops in Python and donates by updating
the state's tensors in place (``donate=True``). Gradient compression (int8
+ error feedback) runs between the gradients and the update when
``TrainConfig.grad_compress`` is set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tm import mean_last
from repro_torch.distributed import collectives
from repro_torch.models import layers, transformer
from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_mod.OptConfig = dataclasses.field(
        default_factory=opt_mod.OptConfig)
    microbatches: int = 1
    grad_compress: bool = False
    moe_num_groups: int = 1


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.OptState
    compress: Optional[collectives.CompressionState]


def init_state(tc: TrainConfig, params) -> TrainState:
    return TrainState(
        params=params,
        opt=opt_mod.init(tc.opt, params),
        compress=collectives.init_state(params) if tc.grad_compress else None,
    )


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """``m`` microbatches along the leading dim (a 0-d leaf goes to each)."""
    def split(x):
        if x.dim() == 0:
            return [x] * m
        if x.shape[0] % m:
            raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                             f"{m} microbatches")
        return x.chunk(m)

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def cast_for_compute(cfg: ModelConfig, params):
    """The tree the gradients are taken against: every float32 leaf cast to
    the compute dtype (the norm scales too, unlike serving's
    ``transformer.compute_params``), as a leaf of its own that requires
    grad, so bfloat16 training gets bfloat16 gradients, as in the
    reference. At a float32 compute dtype the leaves share the masters'
    memory."""
    cd = layers.compute_dtype(cfg)
    return T.map(
        lambda p: (p.detach().to(cd) if p.dtype == torch.float32
                   else p.detach()).requires_grad_(), params)


def batch_on(batch: dict, device) -> dict:
    """The batch's arrays (numpy, as ``data.synthetic`` yields them, or
    tensors) on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(device) for k, v in batch.items()}


def _value_and_grad(cfg: ModelConfig, tc: TrainConfig, params_c,
                    batch: dict):
    loss, parts = transformer.loss_fn(cfg, params_c, batch,
                                      num_groups=tc.moe_num_groups)
    leaves = T.leaves(params_c)
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            T.unflatten(params_c, grads))


def grad_fn(cfg: ModelConfig, tc: TrainConfig, params, batch: dict):
    """Loss, its parts and the gradients, with microbatch accumulation.

    Gradients are taken with respect to the compute-dtype copy; with
    microbatches they accumulate in float32 (and stay float32, as in the
    reference), scaled by 1/m."""
    params_c = cast_for_compute(cfg, params)
    batch = batch_on(batch, T.leaves(params)[0].device)
    if tc.microbatches == 1:
        return _value_and_grad(cfg, tc, params_c, batch)

    acc = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
    loss_sum, parts = 0.0, []
    for mb in _split_microbatches(batch, tc.microbatches):
        loss, part, grads = _value_and_grad(cfg, tc, params_c, mb)
        T.map(lambda a, g: a.add_(g.to(torch.float32)), acc, grads)
        del grads
        loss_sum = loss_sum + loss
        parts.append(part)
    inv = 1.0 / tc.microbatches
    grads = T.map(lambda g: g.mul_(inv), acc)
    parts = {k: mean_last(torch.stack([p[k] for p in parts]))
             for k in parts[0]}
    return loss_sum * inv, parts, grads


def train_step(cfg: ModelConfig, tc: TrainConfig, state: TrainState,
               batch: dict, *, donate: bool = False
               ) -> tuple[TrainState, dict]:
    """One step. Returns (new state, metrics: loss, ce, aux, lr, grad_norm,
    and compress_err_l1 with compression).

    ``donate=True`` is the reference's ``donate_argnums=(0,)``: the new
    parameters and moments are written into ``state``'s tensors leaf by
    leaf and its step counter is advanced in place, so the step never
    holds two copies of the state; ``state`` is the returned state's
    storage and must not be read as the old one."""
    loss, parts, grads = grad_fn(cfg, tc, state.params, batch)

    comp = state.compress
    metrics = {"loss": loss, **parts}
    if comp is not None:
        grads, comp, cm = collectives.compress_grads(grads, comp)
        metrics.update(cm)

    params, opt_state, om = opt_mod.apply(tc.opt, state.opt, state.params,
                                          grads, donate=donate)
    metrics.update(om)
    return TrainState(params=params, opt=opt_state, compress=comp), metrics
