"""Device meshes for the port: a named grid of torch devices.

The reference's ``jax.sharding.Mesh`` has no torch counterpart, so the port
keeps its own :class:`Mesh`: an array of ``torch.device``s, its axis names,
``.shape`` as a name -> size mapping and ``.devices.size``, read the way the
reference's code reads them. One process drives every device of a mesh
(single-controller), so no process group is involved.

A mesh may name a device more than once. That is how a test lays four
slabs of a replica axis on the CPU, and how one card holds four slabs:
the counterpart of the reference's ``--xla_force_host_platform_device_count``.
A mesh that names a CUDA device raises when no such card is present;
nothing falls back to the CPU.

Axes:
  data  -- the replica axis's shards (the TM fleet, the sweep's grid)
  model -- TP / EP / SP for the LM half, which is not ported yet

``make_production_mesh`` (the 256 / 512-chip dry-run meshes) comes with the
dry run, after the LM half of the mesh (ROADMAP queue 1).
"""
from __future__ import annotations

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
