"""Ambient sharding hints for model-internal tensors, the twin of the
reference's ``distributed/autoshard.py``.

The model code calls ``hint(x, axis_names...)`` at the few points where the
reference pins a layout (the residual stream, the MoE dispatch buffers);
the trainer activates a mesh with ``use(mesh)``. With no active mesh, or on
a plain tensor, a hint is the identity, so the model code stays
mesh-agnostic. On a DTensor it redistributes to the named layout (the
reference's ``with_sharding_constraint``); autograd carries the gradient
back to the input's layout.

Axis-name entries may be None, a mesh axis name, or a tuple of axis names
(e.g. ("pod", "data") for a combined DP dimension). Names missing from the
active mesh or not dividing the dimension are dropped: the fallback is
replication on that dim, never a crash.
"""
from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

# The combined data-parallel axes (batch, MoE groups, FSDP).
DP = ("pod", "data")

# Process-wide, not per thread as in the reference: autograd runs a CUDA
# backward (and the forward it recomputes under remat) on its own device
# threads, and the hints there must see the mesh the step runs under.
_state = types.SimpleNamespace(mesh=None, settings={})


def current_mesh():
    return _state.mesh


def setting(name: str, default=None):
    """Launcher-provided knob (e.g. moe_expert_axis: 'model' for training EP,
    'data' for weight-stationary serving EP)."""
    return _state.settings.get(name, default)


@contextlib.contextmanager
def use(mesh, **settings):
    prev = current_mesh()
    prev_s = _state.settings
    _state.mesh = mesh
    _state.settings = settings
    try:
        yield
    finally:
        _state.mesh = prev
        _state.settings = prev_s


@contextlib.contextmanager
def use_for(tree):
    """The mesh of ``tree``'s DTensor leaves made current when no mesh is
    (the train step's entry: the model's hints then read it); yields the
    current mesh, or None for a plain tree."""
    mesh = current_mesh()
    if mesh is None:
        from repro_torch import tree as T

        dt = next((x for x in T.leaves(tree) if is_distributed(x)), None)
        if dt is not None:
            from repro_torch.launch.mesh import RankMesh

            mesh = RankMesh.wrap(dt.device_mesh, dt.to_local().device)
            with use(mesh, **_state.settings):
                yield mesh
            return
    yield mesh


def group_size(axes) -> int:
    """The product of the active mesh's sizes along ``axes`` (1 without a
    mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in axes if a in mesh.shape]))


def _filter_entry(mesh, dim: int, entry):
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    names = tuple(n for n in names if n in mesh.shape)
    if not names:
        return None
    size = int(np.prod([mesh.shape[n] for n in names]))
    if size <= 1 or dim % size != 0:
        return None
    return names if len(names) > 1 else names[0]


def spec(mesh, shape, *axes):
    """The PartitionSpec a hint of ``axes`` gives a tensor of ``shape`` on
    ``mesh``: each entry filtered as above, and an axis already used by an
    earlier dim dropped."""
    from repro_torch.distributed.sharding import PartitionSpec

    assert len(axes) == len(shape), (axes, tuple(shape))
    used: set = set()
    parts = []
    for dim, entry in zip(shape, axes):
        e = _filter_entry(mesh, dim, entry)
        if e is not None:
            flat = e if isinstance(e, tuple) else (e,)
            if any(n in used for n in flat):
                e = None
            else:
                used.update(flat)
        parts.append(e)
    return PartitionSpec(*parts)


def hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain x's layout (the identity without an active mesh or on a
    plain tensor)."""
    from repro_torch.distributed.sharding import NamedSharding

    mesh = current_mesh()
    if mesh is None or not is_distributed(x):
        return x
    placements = NamedSharding(mesh, spec(mesh, x.shape, *axes)).placements()
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh.device_mesh, placements)


class _Pin(torch.autograd.Function):
    """The identity, whose backward puts the gradient in the forward
    value's layout."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # a partial sum's gradient is the same on every rank: replicated
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, with its gradient laid out as ``x`` is (the identity
    on a plain tensor). For the output of an op whose backward views its
    gradient (a product over [B, S, ...] viewed as [B * S, ...]): the
    gradient arriving from the residual stream is sharded over S, which
    the view cannot merge."""
    if not is_distributed(x) or not torch.is_grad_enabled() \
            or not x.requires_grad:
        return x
    return _Pin.apply(x)


def whole_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with the listed dims no longer sharded (replicated over the
    mesh dims that sharded them), its other placements kept; the identity
    on a plain tensor. For an op that views a sharded dim away, which
    DTensor's view rule refuses unless the dim is the first of the ones
    it merges."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.dim() for d in dims}
    placements = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole over the data axes :data:`DP` (replicated there), its
    other placements kept: a parameter's FSDP all-gather at its use, so
    that the products see whole weights beside batch-sharded activations
    (the layout ZeRO-3 computes in; DTensor's own choice there is often
    to move the activations and reduce the products instead). The
    gradient comes back reduce-scattered to the parameter's layout. The
    identity on a plain tensor."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    names = tuple(x.device_mesh.mesh_dim_names or ())
    placements = tuple(Replicate() if names[i] in DP and p.is_shard()
                       else p for i, p in enumerate(x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def local_call(fn, inputs, axes, *, out_of: int = 0,
               partial_grads: dict = None):
    """``fn`` on each rank's own blocks, for work that is independent
    across the sharded dims (attention over its batch and heads): every
    DTensor input hinted to its ``axes`` entry, ``fn`` called on the local
    tensors, its output (or each of a tuple of outputs) a DTensor laid out
    as input ``out_of``. Inputs
    that every rank reads whole but uses in part (one kv head read by the
    rank's own query heads) get a gradient that sums over the mesh axes
    ``partial_grads[i]`` names. Without an active mesh, or on plain
    tensors, it is ``fn(*inputs)``.

    Inside ``fn`` everything is a plain tensor, so the masks and angles
    it makes need no DTensor rule, in the forward or the backward."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = current_mesh()
    if mesh is None or not any(is_distributed(a) for a in inputs):
        return fn(*inputs)
    partial_grads = partial_grads or {}
    names = tuple(mesh.axis_names)
    local, placed = [], []
    for i, (a, ax) in enumerate(zip(inputs, axes)):
        a = hint(a, *ax)
        grad = list(a.placements)
        for name in partial_grads.get(i, ()):
            if name in names:
                grad[names.index(name)] = Partial()
        local.append(a.to_local(grad_placements=grad))
        placed.append(a)
    out = fn(*local)
    place = placed[out_of].placements
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh.device_mesh, place,
                                        run_check=False) for o in out)
    return DTensor.from_local(out, mesh.device_mesh, place, run_check=False)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)
