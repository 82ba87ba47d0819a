"""Sharding over a device mesh: the reference's
``repro.distributed.sharding``, both halves.

**The LM half** maps every parameter's logical axis names (its
:class:`~repro_torch.models.params.PSpec`) to mesh axes by a rule table
(:data:`DEFAULT_RULES`: TP / EP over ``model``), and on top of that shards
each parameter's largest still-unsharded dim over ``("pod", "data")``
(ZeRO-3 / FSDP; the optimizer's moments reuse the parameters' layout). A
dim the mesh axis does not divide is replicated, never a crash.
:func:`spec_partition`, :func:`param_shardings`, :func:`batch_shardings`
and :func:`cache_shardings` make the reference's decisions entry for
entry; they read only ``mesh.shape``, so a :class:`Mesh` over ``"meta"``
devices (:func:`~repro_torch.launch.mesh.abstract_mesh`, the reference's
``AbstractMesh``) evaluates them for a 256-chip mesh without ranks. On a
:class:`~repro_torch.launch.mesh.RankMesh` (one ``torch.distributed``
rank a mesh position) :func:`distribute` turns a tree into DTensors laid
out by those shardings, each rank keeping its own shard
(:meth:`NamedSharding.placements`: a tuple entry such as ``("pod",
"data")`` shards one tensor dim over both mesh dims, major first), and
:func:`gather` puts the whole of each leaf back on every rank.

**The replica half** serves the cross-validation engine
(:mod:`repro_torch.eval.crossval`) and the serving fleet
(:mod:`repro_torch.serve.service`), which run R independent TMs as one
program over a leading replica axis. Every replica is data-parallel by
construction, so the only sharding decision is the replica axis itself:
:func:`replica_shardings` shards the leaves whose leading dim is the full
replica count and replicates the rest (the per-data-stream leaves of
leading ``D | R``), so every replica's ``r % D`` read stays on its own
device and nothing crosses devices inside a step. One process drives
every device (single-controller): :func:`device_put` turns a tensor into
a :class:`Sharded` value, one contiguous slab of rows per mesh position
along the sharded axes (or, replicated, one copy per distinct device,
shared where the mesh repeats a device), and :func:`gather` puts it back
together. The caller runs its per-plane code once per slab
(:func:`slabs`), on that slab's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed.autoshard import (
    DP, contiguous_stride, is_distributed,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import PSpec, ShapeDtype, tree_map_specs


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a leaf, as the reference's
    ``jax.sharding.PartitionSpec``: one entry per tensor dim, each None
    (not sharded), a mesh axis name, or a tuple of names (the dim sharded
    over all of them, the first the major one); missing trailing entries
    are None, so ``PartitionSpec()`` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout over ``mesh``: ``spec`` gives each tensor dim's mesh
    axes. The replica half reads only its first entry (the axes the
    leading replica dim shards over) and ``axes``, the axes a replicated
    leaf's slabs follow, so that every slab finds a copy on its own
    device; the LM half maps the whole spec to DTensor placements
    (:meth:`placements`)."""

    mesh: Mesh
    spec: PartitionSpec
    axes: tuple = ("data",)

    def placements(self, ndim: Optional[int] = None) -> tuple:
        """The DTensor placements of ``spec`` on the mesh's dims, in the
        mesh's axis order: ``Shard(d)`` on every mesh dim that tensor dim
        d's entry names, ``Replicate()`` on the others and on a mesh dim
        of size 1 (the same layout; DTensor cannot reshape a dim sharded
        over one rank). A tuple entry must list its axes in the mesh's
        order (DTensor shards one tensor dim over several mesh dims major
        first, left to right)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.axis_names)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            flat = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in flat]
            if idx != sorted(idx):
                raise ValueError(f"{entry} is not in the mesh's axis order "
                                 f"{names}")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]} shards two dims "
                                     f"of {self.spec}")
                if self.mesh.shape[names[i]] > 1:
                    out[i] = Shard(d)
        if ndim is not None and len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than {ndim} dims")
        return tuple(out)

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


# ---------------------------------------------------------------------------
# The LM rules: logical axes -> mesh axes (DP / FSDP / TP / EP / SP)
# ---------------------------------------------------------------------------

# Logical-axis -> mesh-axis table (TP/EP on "model").
DEFAULT_RULES: dict = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "expert_ff": "model",
    "experts": "model",
    "embed": None,
    "inner": "model",       # ssm/rglru inner width
    "ssm_heads": "model",
    "conv": None,
    "state": None,
    "layers": None,
    None: None,
}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = True                      # ZeRO-3 over (pod, data)
    fsdp_axes: tuple = ("pod", "data")
    data_axes: tuple = ("pod", "data")     # batch sharding
    seq_axis: Optional[str] = None         # SP: shard sequence/cache over this


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return mesh.shape[name] if name in mesh.shape else 1


def _group(mesh, axes: tuple) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _entry(axes: tuple):
    """A spec entry for the present ``axes``: None, one name or a tuple."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def spec_partition(spec: PSpec, mesh, policy: ShardingPolicy
                   ) -> PartitionSpec:
    """PartitionSpec for one parameter: each dim's rule axis where the mesh
    has it, it is not used yet and it divides the dim; then (FSDP) the
    largest still-unsharded dim that the ``fsdp_axes`` group divides goes
    over that group."""
    parts: list = []
    used: set = set()
    for dim, ax in zip(spec.shape, spec.axes):
        mesh_ax = policy.rules.get(ax)
        if (mesh_ax is not None and mesh_ax in mesh.shape
                and mesh_ax not in used and dim % mesh.shape[mesh_ax] == 0):
            parts.append(mesh_ax)
            used.add(mesh_ax)
        else:
            parts.append(None)

    if policy.fsdp:
        fsdp = tuple(a for a in _mesh_axes_present(mesh, policy.fsdp_axes)
                     if a not in used)
        if fsdp:
            group = _group(mesh, fsdp)
            # shard the largest still-unsharded dim that divides the group
            # (the reference sorts by the dim over its rule axis's size)
            order = sorted(
                range(len(spec.shape)),
                key=lambda i: -(spec.shape[i] // max(
                    _axis_size(mesh, parts[i]) if isinstance(parts[i], str)
                    else 1, 1)))
            for i in order:
                if parts[i] is None and spec.shape[i] % group == 0:
                    parts[i] = _entry(fsdp)
                    break
    return PartitionSpec(*parts)


def param_shardings(specs_tree, mesh, policy: ShardingPolicy):
    """NamedSharding tree matching a PSpec tree."""
    return tree_map_specs(
        lambda s: NamedSharding(mesh, spec_partition(s, mesh, policy)),
        specs_tree)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", np.shape(x)))


def _map_structs(fn, tree):
    """``fn`` over a tree whose leaves may be ShapeDtype (a NamedTuple,
    which :func:`repro_torch.tree.map` would descend into)."""
    if isinstance(tree, ShapeDtype):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_structs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_structs(fn, v) for v in tree)
    return T.map(fn, tree)


def batch_shardings(batch_struct, mesh, policy: ShardingPolicy):
    """Shard inputs: leading batch dim over the data axes; optional SP on
    the sequence. ``batch_struct`` is a tree of ShapeDtype, tensors or
    arrays (a 0-d leaf, or a Python int such as decode's ``pos``,
    replicates)."""
    data = _mesh_axes_present(mesh, policy.data_axes)
    group = _group(mesh, data)

    def one(x):
        shape = _shape(x)
        parts: list = [None] * len(shape)
        if len(shape) == 0:
            return NamedSharding(mesh, PartitionSpec())
        if group > 1 and shape[0] % group == 0:
            parts[0] = _entry(data)
        if (policy.seq_axis is not None and len(shape) >= 2
                and policy.seq_axis in mesh.shape
                and shape[1] % mesh.shape[policy.seq_axis] == 0):
            parts[1] = policy.seq_axis
        return NamedSharding(mesh, PartitionSpec(*parts))

    return _map_structs(one, batch_struct)


def cache_shardings(cache_struct, mesh, policy: ShardingPolicy):
    """KV/state cache shardings, keyed on each leaf's name:

    * self-attention ``k``/``v`` ([L?, B, S|W, Hkv, Dh]): a long cache
      (S >= 4096) shards S over model (context parallelism: a decode read
      touches 1/model of it), a short (window) one shards head_dim, so
      the one-token write stays shard-local;
    * cross-attention ``ck``/``cv``: read-only and small, batch over data
      only;
    * the SSM / RG-LRU ``h`` / ``conv`` states: the largest dim after the
      first that is >= 1024 and divides over model (the inner width,
      matching the recurrent weights' TP);

    then the first of the two leading dims that the data group divides
    goes over the data axes."""
    model = "model" if "model" in mesh.shape else None
    data = _mesh_axes_present(mesh, policy.data_axes)
    group = _group(mesh, data)
    msize = mesh.shape[model] if model else 1

    def one(key, x):
        shape = _shape(x)
        parts: list = [None] * len(shape)
        if key in ("k", "v") and len(shape) >= 4:
            seq_dim = len(shape) - 3
            if model and shape[seq_dim] >= 4096 and \
                    shape[seq_dim] % msize == 0:
                parts[seq_dim] = model
            elif model and shape[-1] % msize == 0 and shape[-1] >= msize:
                parts[-1] = model
        elif key in ("ck", "cv"):
            pass  # replicate over model; batch over data below
        else:  # h / conv and other states: inner width over model
            for i in sorted(range(1, len(shape)), key=lambda i: -shape[i]):
                if model and shape[i] >= 1024 and shape[i] % msize == 0:
                    parts[i] = model
                    break
        for i in range(min(2, len(shape))):
            if parts[i] is None and group > 1 and shape[i] % group == 0:
                parts[i] = _entry(data)
                break
        return NamedSharding(mesh, PartitionSpec(*parts))

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return one(key, node)

    return walk(cache_struct, "")


# ---------------------------------------------------------------------------
# The LM layout over ranks: DTensors
# ---------------------------------------------------------------------------


def _local_chunk(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``x`` under ``sharding``: for every sharded
    dim, the contiguous chunk at the rank's combined coordinate over the
    dim's mesh axes (major first)."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.axis_names, mesh.coordinate))
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        n, j = 1, 0
        for a in flat:
            n, j = n * mesh.shape[a], j * mesh.shape[a] + coord[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {entry}")
        size = x.shape[d] // n
        x = x.narrow(d, j * size, size)
    return x


def distribute(tree, shardings):
    """``tree`` (tensors or numpy arrays, the same whole value on every
    rank) as DTensors laid out by ``shardings`` (a tree of NamedSharding
    over a :class:`~repro_torch.launch.mesh.RankMesh`) on the mesh's
    device. Each rank cuts its own shard, a copy; nothing is
    communicated. A ``None`` subtree stays None; a Python scalar, or a
    leaf already a DTensor, stays as it is."""
    from torch.distributed.tensor import DTensor

    def one(x, sh):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
                or is_distributed(x):
            return x
        x = torch.as_tensor(x)
        mesh = sh.mesh
        # a copy of its own: neither a view keeping the whole alive nor
        # the caller's tensor (a donating step writes into it)
        local = _local_chunk(x, sh).to(mesh.device).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh.device_mesh,
                                  sh.placements(x.dim()), run_check=False,
                                  shape=x.shape, stride=x.contiguous().stride())

    return T.map(one, tree, shardings)


def zeros(structs, shardings):
    """A tree of zero DTensors: each ShapeDtype leaf of ``structs`` laid
    out by the matching NamedSharding over a RankMesh, every rank making
    only its own block (a cache built where it lives)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    def one(s, sh):
        mesh = sh.mesh
        place = sh.placements(len(s.shape))
        local, _ = compute_local_shape_and_global_offset(
            s.shape, mesh.device_mesh, place)
        return DTensor.from_local(
            torch.zeros(tuple(local), dtype=s.dtype, device=mesh.device),
            mesh.device_mesh, place, run_check=False, shape=s.shape,
            stride=contiguous_stride(s.shape))

    def walk(node, sh):
        if isinstance(node, ShapeDtype):
            return one(node, sh)
        return {k: walk(node[k], sh[k]) for k in node}

    return walk(structs, shardings)


def place_like(tree, like):
    """Every DTensor leaf of ``tree`` redistributed to the placements of
    the matching leaf of ``like`` (a gradient to its parameter's layout:
    a partial sum becomes a reduce-scatter); other leaves pass."""
    def one(x, ref):
        if (is_distributed(x) and is_distributed(ref)
                and tuple(x.placements) != tuple(ref.placements)):
            return x.redistribute(ref.device_mesh, ref.placements)
        return x

    return T.map(one, tree, like)


def policy_for(cfg, shape) -> ShardingPolicy:
    """The layout a dry-run cell runs under (the reference's
    ``launch/dryrun._policy_for``): training, the default policy (FSDP
    over the data axes, TP / EP over ``model``); serving is
    weight-stationary: no FSDP (a weight all-gather every step would
    dominate decode), experts over ``data`` (EP all-to-all), the rest TP
    over ``model``, and a decode batch under 16 sequences shards its
    sequence (the KV cache) over ``model`` too."""
    if shape.kind == "train":
        return ShardingPolicy()
    rules = dict(DEFAULT_RULES)
    rules["experts"] = "data"
    seq_axis = ("model" if shape.kind == "decode" and shape.global_batch < 16
                else None)
    return ShardingPolicy(rules=rules, fsdp=False, seq_axis=seq_axis)


def moe_groups(cfg, mesh) -> int:
    """MoE dispatch groups under ``mesh``: the data group size (the
    reference's ``launch/dryrun._moe_groups``), 1 for a dense model."""
    if cfg.moe is None or mesh is None:
        return 1
    return _group(mesh, _mesh_axes_present(mesh, DP))


def local_numel(tree) -> int:
    """Elements this rank holds of ``tree``'s tensors (a DTensor's local
    shard)."""
    return sum(int(x.to_local().numel() if is_distributed(x) else x.numel())
               for x in T.leaves(tree) if torch.is_tensor(x))


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


def gather(x, device=None):
    """The whole of a :class:`Sharded` on ``device`` (default: its first
    slab's): the slabs concatenated in order, or the first copy. Given a
    tree of DTensors (:func:`distribute`), every rank gets the whole of
    each leaf (an all-gather a sharded leaf; collective, so every rank
    calls it), on ``device`` when one is named; other leaves pass."""
    if not isinstance(x, Sharded):
        def full(t):
            if not is_distributed(t):
                return t
            t = t.full_tensor()
            return t if device is None else t.to(device)
        return T.map(full, x)
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
