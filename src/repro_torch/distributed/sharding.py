"""Replica-axis sharding over a device mesh: the TM half of the reference's
``repro.distributed.sharding``.

The cross-validation engine (:mod:`repro_torch.eval.crossval`) and the
serving fleet (:mod:`repro_torch.serve.service`) run R independent TMs as
one program over a leading replica axis. Every replica is data-parallel by
construction, so the only sharding decision is the replica axis itself:
:func:`replica_shardings` shards the leaves whose leading dim is the full
replica count and replicates the rest (the per-data-stream leaves of
leading ``D | R``), so every replica's ``r % D`` read stays on its own
device and nothing crosses devices inside a step.

One process drives every device (single-controller): :func:`device_put`
turns a tensor into a :class:`Sharded` value, one contiguous slab of rows
per mesh position along the sharded axes (or, replicated, one copy per
distinct device, shared where the mesh repeats a device), and
:func:`gather` puts it back together. The caller runs its per-plane code
once per slab (:func:`slabs`), on that slab's device.

The LM rules (``ShardingPolicy``, ``spec_partition``,
``param_/batch_/cache_shardings``) need ``torch.distributed`` and more
than one card, and wait for the LM half of the mesh (ROADMAP queue 1).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.launch.mesh import Mesh


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a leaf (None: not sharded), as the
    reference's ``jax.sharding.PartitionSpec``; ``PartitionSpec()`` is
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout over ``mesh``: ``spec``'s first entry names the
    axes its leading dim shards over (None or an empty spec: replicated).
    ``axes`` are the axes a replicated leaf's slabs follow, so that every
    slab finds a copy on its own device."""

    mesh: Mesh
    spec: PartitionSpec
    axes: tuple = ("data",)

    @property
    def sharded(self) -> bool:
        return len(self.spec) > 0 and self.spec[0] is not None

    @property
    def slab_axes(self) -> tuple:
        if not self.sharded:
            return _mesh_axes_present(self.mesh, self.axes)
        first = self.spec[0]
        return tuple(first) if isinstance(first, tuple) else (first,)


def _mesh_axes_present(mesh: Mesh, axes: tuple) -> tuple:
    return tuple(a for a in axes if a in mesh.shape)


def slab_devices(mesh: Mesh, axes: tuple = ("data",)) -> list:
    """The device of each slab along ``axes``: the mesh's devices over the
    axes present, in order, taking the first device along the others (one
    process computes a slab once; the other axes would only repeat it)."""
    present = _mesh_axes_present(mesh, axes)
    names = mesh.axis_names
    order = [names.index(a) for a in present]
    rest = [i for i in range(len(names)) if i not in order]
    grid = np.transpose(mesh.devices, order + rest)
    grid = grid.reshape(grid.shape[:len(order)] + (-1,))[..., 0]
    return list(np.asarray(grid, dtype=object).reshape(-1))


def replica_shardings(tree, mesh: Mesh, *, axes: tuple = ("data",),
                      n_replicas: Optional[int] = None):
    """Shard each leaf's LEADING replica axis over the given mesh axes.

    ``n_replicas`` pins the layout rule for mixed trees: sweep inputs mix
    full-R leaves (TA banks, per-replica s/T) with per-data-stream leaves
    of leading ``D | R`` (ordering datapoints, RNG keys). ONLY leaves whose
    leading dim equals ``n_replicas`` and divides the mesh group shard, in
    contiguous slabs; every other leaf is replicated onto every device, so
    the kernels' ``r % D`` read never crosses a device. A leading dim that
    does not divide the group replicates too (never crash). The form
    without ``n_replicas`` sharded any divisible leading dim, scattering
    the streams away from the replicas that read them: it is a
    ``TypeError``, as in the reference.
    """
    if n_replicas is None:
        raise TypeError(
            "replica_shardings() requires n_replicas: the old "
            "n_replicas=None form sharded ANY divisible leading dim, "
            "scattering D | R data-stream leaves away from the replicas "
            "that read them (cross-device r % D gathers). Pass the fleet's "
            "replica count so only the full-R grid-major axis shards.")
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    present = _mesh_axes_present(mesh, axes)
    group = int(np.prod([mesh.shape[a] for a in present])) if present else 1
    spec_axes = present if len(present) > 1 else (
        present[0] if present else None)

    def one(x):
        shape = tuple(getattr(x, "shape", ()))
        if (present and len(shape) >= 1 and shape[0] % group == 0
                and shape[0] == n_replicas):
            return NamedSharding(mesh, PartitionSpec(spec_axes), axes)
        return NamedSharding(mesh, PartitionSpec(), axes)

    return T.map(one, tree)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor laid out over a mesh: ``shards[j]`` is slab j's tensor on
    ``devices[j]`` (rows ``bounds[j]`` of the whole when sharded; the whole
    when replicated, one tensor object per distinct device). Not a tuple,
    so trees treat it as a leaf."""

    sharding: NamedSharding
    shards: tuple
    devices: tuple
    bounds: Optional[tuple]   # ((lo, hi), ...) rows of each slab, or None

    @property
    def shape(self) -> tuple:
        if self.bounds is None:
            return tuple(self.shards[0].shape)
        return ((self.bounds[-1][1],) + tuple(self.shards[0].shape[1:]))


def _tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x))


def device_put(x, sharding: NamedSharding) -> Sharded:
    """``x`` (a tensor, a numpy array or a scalar) laid out by
    ``sharding``: its slabs on their devices (a slab already there is a
    view, not a copy), or one copy per distinct device."""
    x = _tensor(x)
    devs = tuple(slab_devices(sharding.mesh, sharding.slab_axes))
    if not sharding.sharded:
        copies: dict = {}
        for d in devs:
            if d not in copies:
                copies[d] = x.to(d)
        return Sharded(sharding, tuple(copies[d] for d in devs), devs, None)
    n = len(devs)
    size = x.shape[0] // n
    bounds = tuple((j * size, (j + 1) * size) for j in range(n))
    return Sharded(sharding, tuple(x[lo:hi].to(d) for (lo, hi), d
                                   in zip(bounds, devs)), devs, bounds)


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole of a :class:`Sharded` on ``device`` (default: its first
    slab's): the slabs concatenated in order, or the first copy."""
    dev = x.devices[0] if device is None else torch.device(device)
    if x.bounds is None:
        return x.shards[0].to(dev)
    return torch.cat([s.to(dev) for s in x.shards])


class Slab(NamedTuple):
    """One slab of a put tree: rows [lo, hi) of the replica axis on
    ``device``, with ``tree`` holding that slab's tensor of every leaf."""

    device: torch.device
    lo: int
    hi: int
    tree: object


def slabs(put_tree) -> list:
    """The per-slab trees of a tree of :class:`Sharded` leaves (from
    :func:`device_put` under :func:`replica_shardings`). When no leaf
    shards (the replica axis did not divide the group), the whole tree is
    one slab on the first device: every device would compute the same
    values, and one process needs them once."""
    flat = [s for s in T.leaves(put_tree) if isinstance(s, Sharded)]
    ref = next((s for s in flat if s.bounds is not None), None)
    if ref is None:
        first = flat[0]
        n = first.shape[0] if first.shape else 1
        return [Slab(first.devices[0], 0, n,
                     T.map(lambda s: s.shards[0], put_tree))]
    return [Slab(d, lo, hi, T.map(lambda s, _j=j: s.shards[_j], put_tree))
            for j, (d, (lo, hi)) in enumerate(zip(ref.devices, ref.bounds))]


def put_slabs(tree, mesh: Optional[Mesh], n_replicas: int,
              device=None) -> list:
    """``tree`` (replica-leading leaves, streams, scalars) as slabs: under
    ``mesh`` laid out by :func:`replica_shardings`, else one slab of every
    row on ``device``."""
    if mesh is None:
        dev = torch.device(device)
        return [Slab(dev, 0, n_replicas,
                     T.map(lambda a: _tensor(a).to(dev), tree))]
    sh = replica_shardings(tree, mesh, n_replicas=n_replicas)
    return slabs(T.map(device_put, tree, sh))


def on(device):
    """The context a slab's work runs in: its card made current (a
    hand-written kernel launches on the current device's stream), or
    nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def sync(devices) -> None:
    """Wait for every distinct CUDA device among ``devices``."""
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
