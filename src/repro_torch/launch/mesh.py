"""Device meshes for the port: a named grid of torch devices, and a mesh
over the ranks of a process group.

The reference's ``jax.sharding.Mesh`` has no torch counterpart, so the
port keeps two. Both expose ``.shape`` as a name -> size mapping and
``.axis_names``, which is all the sharding rules read.

* :class:`Mesh` is an array of ``torch.device``s. One process drives
  every device of it (single-controller), so no process group is
  involved: the TM fleet, the service and the cross-validation engine lay
  slabs of their replica axis on it. A mesh may name a device more than
  once. That is how a test lays four slabs of a replica axis on the CPU,
  and how one card holds four slabs: the counterpart of the reference's
  ``--xla_force_host_platform_device_count``. A mesh over ``"meta"``
  devices (:func:`abstract_mesh`) is the counterpart of the reference's
  ``AbstractMesh``: the rules evaluate a 16 x 16 or 2 x 16 x 16 mesh
  with no ranks and no memory.
* :class:`RankMesh` wraps a ``torch.distributed`` ``DeviceMesh``: one rank
  a mesh position, each computing on its own device, the LM's
  parameters, moments and batch laid out over it as DTensors (SPMD;
  :func:`init_ranks` starts a rank's process group).

A mesh that names a CUDA device raises when no such card is present;
nothing falls back to the CPU.

Axes:
  pod   -- across pods; the outer DP / FSDP axis
  data  -- the replica axis's shards (the TM fleet, the sweep's grid);
           the LM's DP / FSDP axis
  model -- the LM's TP / EP / SP axis

:func:`make_production_mesh` is the reference's production meshes, (16, 16)
``("data", "model")`` or (pods, 16, 16) ``("pod", "data", "model")``, as
a :class:`RankMesh` over the current process group: the dry run
(:mod:`repro_torch.launch.dryrun`) evaluates every cell on them as rank 0
of a fake world of 256 or 512 ranks.
"""
from __future__ import annotations

import datetime
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch


def _device(d) -> torch.device:
    """One mesh entry as a concrete torch device (``"cuda"`` is card 0);
    a CUDA device with no such card raises."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh names {dev} but no CUDA device is available; build "
                "the mesh over 'cpu' to run the plain versions on the CPU")
        idx = 0 if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise ValueError(
                f"mesh names {dev} but only {torch.cuda.device_count()} "
                "CUDA devices are present")
        dev = torch.device("cuda", idx)
    return dev


class Mesh:
    """A named grid of devices: ``devices`` an array (any nesting of lists,
    or a numpy array) of torch devices or device strings, one axis of it
    per name in ``axis_names``. Devices may repeat."""

    def __init__(self, devices, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if isinstance(devices, (torch.device, str)):
            devices = [devices]
        raw = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        flat = np.asarray(devices, dtype=object).reshape(-1)
        raw.reshape(-1)[:] = [_device(d) for d in flat]
        if raw.ndim != len(axis_names):
            raise ValueError(
                f"mesh devices have {raw.ndim} axes, names "
                f"{axis_names} give {len(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if raw.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = raw
        self.axis_names = axis_names

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_host_mesh(model: int = 1, *, devices=None) -> Mesh:
    """A ``("data", "model")`` mesh over every card present (tests and
    examples), or over ``devices`` when the caller names them (say
    ``["cpu"] * 4`` for four CPU slabs). Without a card and without
    ``devices`` it raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh() spans the CUDA devices and none is "
                "available; pass devices=['cpu', ...] for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model, model), ("data", "model"))


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``"meta"`` devices, for the rules
    alone (the reference's ``AbstractMesh(axis_sizes, axis_names)``)."""
    grid = np.empty(tuple(shape), dtype=object)
    grid.reshape(-1)[:] = [torch.device("meta")] * grid.size
    return Mesh(grid, axis_names)


def _rank_device(device, rank: int) -> torch.device:
    """The device a rank computes on: ``cuda:rank % cards`` for "cuda"
    (ranks share cards when there are fewer cards than ranks), or the
    CPU. "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a rank mesh on 'cuda' needs a CUDA device and none is "
            "available; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def rank_backend(device, world_size: int, staged: bool = False) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU; and
    when ranks share a card (NCCL refuses two ranks on one GPU), gloo for
    host tensors and the staged backend of
    :mod:`repro_torch.distributed.collectives` for the card's (DTensor's
    collectives on CUDA tensors over gloo never return). ``staged`` puts
    the CPU's tensors through the staged backend too (the CPU tests of
    that backend)."""
    from repro_torch.distributed import collectives

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    if dev.type == "cuda":
        return f"cpu:gloo,cuda:{collectives.register_staged_backend()}"
    if staged:
        return f"cpu:{collectives.register_staged_backend()}"
    return "gloo"


def init_ranks(rank: int, world_size: int, *, init_method: str,
               device="cuda", timeout_s: float = 120.0,
               staged: bool = False) -> str:
    """Join this process to the world group (``init_method`` a
    ``file://`` path or ``tcp://localhost:<port>``) with the backend
    :func:`rank_backend` names; the rank's card is made current. Returns
    the backend."""
    import torch.distributed as dist

    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = rank_backend(dev, world_size, staged)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


class RankMesh:
    """A mesh over the ranks of the world process group: ``shape`` (its
    product the world size), ``axis_names`` the reference's (``("data",
    "model")`` or ``("pod", "data", "model")``), each rank computing on
    ``device`` ("cuda": ``cuda:rank % cards``; "cpu"). ``device_mesh`` is
    the ``torch.distributed`` ``DeviceMesh`` the DTensors live on,
    ``coordinate`` this rank's position on it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and names {axis_names} "
                             "differ in rank")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs an initialised process group "
                               "(init_ranks)")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} does not cover the "
                             f"{world} ranks")
        self.device = _rank_device(device, dist.get_rank())
        self.axis_names = axis_names
        # a rank on "meta" (the dry run: shapes without memory) keeps its
        # tensors there over a CPU mesh of the process group
        self.device_mesh = DeviceMesh(
            "cpu" if self.device.type == "meta" else self.device.type,
            torch.arange(world).reshape(shape), mesh_dim_names=axis_names)
        self.coordinate = tuple(self.device_mesh.get_coordinate())

    @classmethod
    def wrap(cls, device_mesh, device) -> "RankMesh":
        """The RankMesh of an existing named ``DeviceMesh`` (a DTensor's),
        this rank computing on ``device``."""
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.device_mesh = device_mesh
        self.coordinate = tuple(device_mesh.get_coordinate())
        return self

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.device_mesh.shape))

    def __repr__(self) -> str:
        return f"RankMesh({dict(self.shape)}, {self.device})"


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2,
                         device="cuda") -> RankMesh:
    """The reference's production mesh over the current process group:
    (16, 16) ``("data", "model")``, or (n_pods, 16, 16) ``("pod", "data",
    "model")``. The world must have exactly that many ranks (the dry run's
    fake world does; a real one would need 256 or 512 GPUs)."""
    shape = (n_pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankMesh(shape, axes, device=device)
