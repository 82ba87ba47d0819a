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


def local_call(fn, inputs, axes, *, out_of=0,
               partial_grads: dict = None):
    """``fn`` on each rank's own blocks, for work that is independent
    across the sharded dims (attention over its batch and heads): every
    DTensor input hinted to its ``axes`` entry, ``fn`` called on the local
    tensors, its output (or each of a tuple of outputs) a DTensor laid out
    as input ``out_of`` (a tuple of outputs may name one input each in a
    tuple ``out_of``). Inputs
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
    if isinstance(out, tuple):
        of = out_of if isinstance(out_of, tuple) else (out_of,) * len(out)
        return tuple(DTensor.from_local(o, mesh.device_mesh,
                                        placed[i].placements,
                                        run_check=False)
                     for o, i in zip(out, of))
    return DTensor.from_local(out, mesh.device_mesh,
                              placed[out_of].placements, run_check=False)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# Caches laid out over a mesh: each rank reads and writes its own block
# ---------------------------------------------------------------------------


def replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t`` (a plain tensor every rank holds whole: a mask, positions) as
    a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor, so that
    an op may take both; else ``t`` itself."""
    if not is_distributed(x) or is_distributed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def block(x) -> tuple[tuple, tuple]:
    """(local shape, global offset) of a DTensor's own block."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(shape), tuple(off)


def all_reduce_over(t: torch.Tensor, mesh, dims, op: str) -> torch.Tensor:
    """A rank's plain ``t`` reduced (``op``: "sum" or "max") over the mesh
    dims ``dims`` (a DTensor ``Partial`` there, redistributed whole); the
    other mesh dims are left as they are."""
    if not dims:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    n = mesh.ndim
    part = [Partial(op) if i in dims else Replicate() for i in range(n)]
    d = DTensor.from_local(t, mesh, part, run_check=False)
    return d.redistribute(mesh, [Replicate()] * n).to_local()


def layer_of(buf, idx: int):
    """Layer ``idx`` of a stacked cache leaf ``buf`` [L, ...]: ``buf[idx]``
    for a plain tensor (a view). For a DTensor, a DTensor [...] laid out as
    ``buf`` without its first dim, a view of the rank's block where the
    layer dim is not sharded; where it is, the ranks that hold the layer
    send it to the others (a sum in which the rest add zeros)."""
    if not is_distributed(buf):
        return buf[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = buf.device_mesh
    shape, off = block(buf)
    loc = buf.to_local()
    own = off[0] <= idx < off[0] + shape[0]
    place, lead = [], False
    for p in buf.placements:
        if p.is_shard(0):
            place.append(Partial("sum"))
            lead = True
        elif p.is_shard():
            place.append(Shard(p.dim - 1))
        else:
            place.append(p)
    local = loc[idx - off[0]] if own else torch.zeros_like(loc[0])
    out = DTensor.from_local(local, mesh, place, run_check=False,
                             shape=buf.shape[1:],
                             stride=contiguous_stride(buf.shape[1:]))
    if lead:
        out = out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in place])
    return out


def write_block(buf, value, index: tuple) -> None:
    """``buf[index] = value`` in place: on a DTensor ``buf`` from a
    DTensor ``value``, each rank writing its own block; a plain ``buf``
    is one block at offset 0, written from a plain ``value``. ``index``
    has one entry a dim of ``buf``: an int (that coordinate; ``value``
    has no such dim), ``slice(None)`` (the whole dim; ``value``'s
    matching dim is as long) or a sequence of positions (``value``'s
    matching dim has one row each; at most one such entry; a ``range``
    of step 1 is written as one slice). A DTensor ``value`` is first laid
    out like ``buf`` on the whole dims and whole elsewhere, so a rank
    finds the rows of its block."""
    vdim, j = {}, 0
    for d, e in enumerate(index):
        if not isinstance(e, int):
            vdim[d], j = j, j + 1
    whole = not is_distributed(buf)
    if whole:
        v, tgt = value, buf
        shape, off = tuple(buf.shape), (0,) * buf.dim()
    else:
        from torch.distributed.tensor import Replicate, Shard

        place = [Shard(vdim[p.dim]) if p.is_shard() and p.dim in vdim
                 and isinstance(index[p.dim], slice) else Replicate()
                 for p in buf.placements]
        v = value.redistribute(buf.device_mesh, place).to_local()
        shape, off = block(buf)
        tgt = buf.to_local()
    posdim, positions = None, None
    for d in reversed(range(len(index))):
        e = index[d]
        if isinstance(e, int):
            if not whole and not off[d] <= e < off[d] + shape[d]:
                return
            tgt = tgt.select(d, e - off[d])
        elif not isinstance(e, slice):
            posdim, positions = d, e
    if posdim is None:
        tgt.copy_(v.to(tgt.dtype))
        return
    lo, n = off[posdim], shape[posdim]
    pd = vdim[posdim]
    if isinstance(positions, range) and positions.step == 1:
        a, b = max(positions.start, lo), min(positions.stop, lo + n)
        if a < b:
            tgt.narrow(pd, a - lo, b - a).copy_(
                v.narrow(pd, a - positions.start, b - a).to(tgt.dtype))
        return
    rows = [(i, p - lo) for i, p in enumerate(positions) if lo <= p < lo + n]
    if not rows:
        return
    src = torch.tensor([r[0] for r in rows], device=tgt.device)
    dst = torch.tensor([r[1] for r in rows], device=tgt.device)
    tgt.index_copy_(pd, dst, v.index_select(pd, src).to(tgt.dtype))
