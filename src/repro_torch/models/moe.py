"""Mixture-of-Experts FFN: top-k routing, capacity-bounded grouped dispatch,
the twin of the reference's ``models/moe.py``.

Tokens are split into ``num_groups`` groups; each group scatters its tokens
into per-expert capacity buffers ``[G, E, C+1, D]`` (``index_put`` with
accumulation, a discard row ``C`` for the slots dropped by capacity), the
experts' gated MLPs run over the buffers as batched products, and the
combine gathers each token's ``top_k`` outputs back, weighted by its
renormalised gates. arctic-480b's ``dense_residual`` adds the
architecture's parallel dense FFN.

Under a mesh (:func:`repro_torch.distributed.autoshard.use`) the groups
shard over the data axes: routing, dispatch and combine stay group-local
(the dispatch and the combine run on each rank's own groups,
:func:`~repro_torch.distributed.autoshard.local_call`), and the buffers
are hinted to [groups -> data, experts -> model] for the expert products
(expert parallelism; the hint boundary is the all-to-all), as in the
reference. ``setting("moe_expert_axis")`` puts the experts over ``data``
instead (weight-stationary serving), and the groups then stay over
``pod`` where the mesh has one. Without a mesh every hint is the
identity.

Where a straight translation would go wrong:
* ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order among ties (and its CPU
  and CUDA orders differ), so :func:`route` takes the first ``k`` of a
  stable descending sort. At bf16 the router logits are coarse, and ties
  among 64 experts do occur.
* the capacity uses Python's ``round`` (half to even), as the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.autoshard import (
    DP, group_size, hint, local_call, pin, setting,
)
from repro_torch.models import layers
from repro_torch.models.params import PSpec


def _expert_axis():
    # training: experts over `model` (EP in the TP axis); serving: experts
    # over `data` (weight-stationary, expert_ff stays on `model`).
    return setting("moe_expert_axis", "model")


def moe_specs(cfg: ModelConfig) -> dict:
    assert cfg.moe is not None
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    sp = {
        "router": PSpec((d, e), ("embed", "experts")),
        "w_gate": PSpec((e, d, f), ("experts", "embed", "expert_ff")),
        "w_up": PSpec((e, d, f), ("experts", "embed", "expert_ff")),
        "w_down": PSpec((e, f, d), ("experts", "expert_ff", "embed")),
    }
    if m.dense_residual:
        sp["dense"] = layers.mlp_specs(cfg)
    return sp


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert holds per group: ``round(Tg * k * cf / E)``, at
    least one."""
    m = cfg.moe
    return max(1, int(round(tokens_per_group * m.top_k * m.capacity_factor
                            / m.n_experts)))


class Routing(NamedTuple):
    """One call's routing, per group ``[G, Tg, k]`` unless noted."""
    expert_idx: torch.Tensor   # int64 expert of each (token, k) slot
    pos: torch.Tensor          # int64 slot position in its expert's buffer
    keep: torch.Tensor         # bool: pos < capacity
    gates: torch.Tensor        # renormalised gates (float32)
    aux: torch.Tensor          # the Switch load-balance loss, scalar
    capacity: int


def route(cfg: ModelConfig, p: dict, xt: torch.Tensor) -> Routing:
    """Router logits (compute dtype, then float32), softmax, top-k with the
    reference's tie order, renormalised gates, the aux loss, and each
    slot's position in its expert's buffer. xt: [G, Tg, D] in the compute
    dtype."""
    m = cfg.moe
    cd = layers.compute_dtype(cfg)
    acc = layers.acc_dtype(cd)
    G, Tg, _ = xt.shape
    E, k = m.n_experts, m.top_k
    logits = hint(layers._dot(xt, p["router"].to(cd), 1).to(acc),
                  DP, None, None)
    probs = torch.softmax(logits, dim=-1)                       # [G,Tg,E]
    # group-local; on each rank's own groups under a mesh (the sort's
    # backward scatters into a plain tensor, which a DTensor refuses)
    values, indices = local_call(
        lambda p: tuple(torch.sort(p, dim=-1, descending=True,
                                   stable=True)), (probs,),
        ((DP, None, None),))
    gates, expert_idx = values[..., :k], indices[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # Switch-style load-balance loss: E * sum_e mean(probs_e) * mean(top1==e).
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], E).to(acc).mean(dim=(0, 1))
    aux = E * (me * ce).sum() * m.router_aux_weight

    C = capacity(cfg, Tg)
    # Position of each (token, k) slot inside its expert's buffer, per
    # group: the exclusive cumsum of the one-hot over the flat [Tg*k] axis.
    flat = F.one_hot(expert_idx.reshape(G, Tg * k), E)          # [G,Tk,E]
    before = flat.cumsum(dim=1) - flat
    pos = torch.gather(before, -1,
                       expert_idx.reshape(G, Tg * k, 1)).reshape(G, Tg, k)
    return Routing(expert_idx, pos, pos < C, gates, aux, C)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            num_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], router aux loss scalar, float32)."""
    m = cfg.moe
    cd = layers.compute_dtype(cfg)
    B, S, D = x.shape
    T, G = B * S, num_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    # The views regroup the tokens: the rows may stay sharded over the
    # data axes only where the groups split over them too (and back)
    n = group_size(DP)
    x = hint(x, DP if G % n == 0 else None, None, None)
    xt = hint(x.reshape(G, Tg, D).to(cd), DP, None, None)
    r = route(cfg, p, xt)
    C = r.capacity
    w = torch.where(r.keep, r.gates, 0.0).to(cd)                # [G,Tg,k]
    # Dropped slots scatter into a discard row (index C, sliced off below).
    pos_c = torch.where(r.keep, r.pos, C)
    grouped = (DP, None, None)

    def dispatch(xt, expert_idx, pos_c, keep):
        # multiplied by 0 first, the dropped slots land in row C; each kept
        # (e, pos) receives exactly one token, so the kept rows are exact
        # whatever order the adds land in
        g = torch.arange(xt.shape[0], device=xt.device)[:, None, None]
        xk = xt[:, :, None, :] * keep.to(cd)[..., None]         # [G,Tg,k,D]
        buf = torch.zeros((xt.shape[0], m.n_experts, C + 1, D), dtype=cd,
                          device=xt.device)
        buf = buf.index_put((g.expand_as(pos_c), expert_idx, pos_c), xk,
                            accumulate=True)
        return buf[:, :, :C, :]

    buffers = local_call(dispatch, (xt, r.expert_idx, pos_c, r.keep),
                         (grouped,) * 4)
    # Dispatch happened group-local (buffers sharded over G = DP); the
    # expert products want the expert axis sharded: this hint boundary is
    # the all-to-all. The groups keep the data axes the experts do not
    # take: serving's experts over `data` leave G over `pod` (the
    # reference leaves G whole there, and DTensor reaches that layout by
    # gathering every group's buffers on each rank before it cuts E).
    ea = _expert_axis()
    g_axis = tuple(a for a in DP if a != ea)
    buffers = hint(buffers, g_axis, ea, None, None)

    # Expert FFN over [G, E, C, D] buffers (weights shared across groups).
    g_ = torch.einsum("gecd,edf->gecf", buffers, p["w_gate"].to(cd))
    act = layers.silu(g_) if cfg.act == "swiglu" else layers.gelu_tanh(g_)
    if "w_up" in p:
        act = act * torch.einsum("gecd,edf->gecf", buffers, p["w_up"].to(cd))
    ex_out = hint(torch.einsum("gecf,efd->gecd", act, p["w_down"].to(cd)),
                  g_axis, ea, None, None)

    def combine(ex_out, expert_idx, pos_c, w):
        # the gate-weighted sum of each token's expert outputs
        g = torch.arange(ex_out.shape[0], device=ex_out.device)[:, None, None]
        got = ex_out[g.expand_as(pos_c), expert_idx,
                     torch.clamp_max(pos_c, C - 1)]               # [G,Tg,k,D]
        return (got * w[..., None]).sum(dim=2)

    out = local_call(combine, (ex_out, r.expert_idx, pos_c, w),
                     ((DP, None, None, None),) + (grouped,) * 3)
    if m.dense_residual:
        out = out + layers.mlp(cfg, p["dense"], xt)
    out = hint(out, DP if B % n == 0 else None, None, None)
    return pin(out.reshape(B, S, D)).to(x.dtype), r.aux
