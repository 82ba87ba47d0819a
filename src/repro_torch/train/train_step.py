"""The train step: microbatched gradient accumulation + optimizer update,
the twin of the reference's ``train/train_step.py``.

The reference scans over microbatches inside one jitted call and may donate
the old state's buffers; the port loops in Python and donates by updating
the state's tensors in place (``donate=True``). Gradient compression (int8
+ error feedback) runs between the gradients and the update when
``TrainConfig.grad_compress`` is set.

Sharded training: the state's leaves may be DTensors over a
:class:`~repro_torch.launch.mesh.RankMesh` (``distribute(state,
state_shardings(...))``), one ``torch.distributed`` rank a mesh position.
:func:`grad_fn` and :func:`train_step` take such a state as they take a
plain one: they activate its mesh for the model's hints, place a host
batch by ``batch_shardings``, keep the compute copy in its parameters'
placements, and put every gradient in its parameter's layout before the
update (a reduce-scatter where the backward left a partial sum), so the
parameters and moments stay sharded (the reference pins its output state
to the parameter shardings, ``launch/dryrun.py``). Under a mesh
``TrainConfig.moe_num_groups`` should be the data group size
(:func:`repro_torch.distributed.sharding.moe_groups`), so the MoE
dispatch stays group-local.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tm import mean_last
from repro_torch.distributed import autoshard, collectives
from repro_torch.distributed import sharding as shd
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


def batch_on(batch: dict, device, mesh=None) -> dict:
    """The batch's arrays (numpy, as ``data.synthetic`` yields them, or
    tensors) on ``device``; with a :class:`RankMesh`, the global batch laid
    out by ``batch_shardings`` (each rank keeps its rows; a leaf already a
    DTensor stays as it is)."""
    if mesh is not None:
        batch = {k: v if autoshard.is_distributed(v) else
                 torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v) for k, v in batch.items()}
        plain = {k: v for k, v in batch.items()
                 if not autoshard.is_distributed(v)}
        placed = shd.distribute(plain, shd.batch_shardings(
            plain, mesh, shd.ShardingPolicy()))
        return {k: placed.get(k, v) for k, v in batch.items()}
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(device) for k, v in batch.items()}


def state_shardings(cfg: ModelConfig, tc: TrainConfig, mesh,
                    policy: Optional[shd.ShardingPolicy] = None
                    ) -> TrainState:
    """The train state's layout over ``mesh``: parameters by
    ``param_shardings`` (FSDP + TP under the default policy), the moments
    and the compression residual like their parameters, the step
    replicated (the reference's ``state_shard``, ``launch/dryrun.py``)."""
    policy = policy or shd.ShardingPolicy()
    p_shard = shd.param_shardings(transformer.model_specs(cfg), mesh, policy)
    return TrainState(
        params=p_shard,
        opt=opt_mod.OptState(step=shd.NamedSharding(mesh, shd.PartitionSpec()),
                             mu=p_shard, nu=p_shard),
        compress=(collectives.CompressionState(residual=p_shard)
                  if tc.grad_compress else None))


def _value_and_grad(cfg: ModelConfig, tc: TrainConfig, params_c,
                    batch: dict):
    loss, parts = transformer.loss_fn(cfg, params_c, batch,
                                      num_groups=tc.moe_num_groups)
    leaves = T.leaves(params_c)
    grads = iter(torch.autograd.grad(loss, leaves))
    # the loss and its parts whole on every rank (one reduction each)
    return (shd.gather(loss.detach()),
            {k: shd.gather(v.detach()) for k, v in parts.items()},
            T.unflatten(params_c, grads))


def grad_fn(cfg: ModelConfig, tc: TrainConfig, params, batch: dict):
    """Loss, its parts and the gradients, with microbatch accumulation.

    Gradients are taken with respect to the compute-dtype copy; with
    microbatches they accumulate in float32 (and stay float32, as in the
    reference), scaled by 1/m, each in its parameter's layout.

    On a sharded tree (DTensor leaves) it runs under the tree's mesh
    (:func:`autoshard.use_for`) with the batch laid out by
    ``batch_shardings``; the gradients come back in the layouts the
    backward leaves them (often partial sums): :func:`train_step` places
    them. The loss and its parts come back whole, the same on every
    rank."""
    with autoshard.use_for(params) as mesh:
        params_c = cast_for_compute(cfg, params)
        batch = batch_on(batch, T.leaves(params)[0].device, mesh)
        if tc.microbatches == 1:
            return _value_and_grad(cfg, tc, params_c, batch)
        return _accumulate(cfg, tc, params, params_c, batch)


def _accumulate(cfg: ModelConfig, tc: TrainConfig, params, params_c,
                batch: dict):
    acc = T.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    loss_sum, parts = 0.0, []
    for mb in _split_microbatches(batch, tc.microbatches):
        loss, part, grads = _value_and_grad(cfg, tc, params_c, mb)
        T.map(lambda a, g: a.add_(shd.place_like(g.to(torch.float32), a)),
              acc, grads)
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
    # each gradient in its parameter's layout (a reduce-scatter of a
    # partial sum): the update then runs shard by shard (ZeRO)
    grads = shd.place_like(grads, state.params)

    comp = state.compress
    metrics = {"loss": loss, **parts}
    if comp is not None:
        grads, comp, cm = collectives.compress_grads(grads, comp)
        metrics.update(shd.gather(cm))

    params, opt_state, om = opt_mod.apply(tc.opt, state.opt, state.params,
                                          grads, donate=donate)
    metrics.update(shd.gather(om))
    return TrainState(params=params, opt=opt_state, compress=comp), metrics
