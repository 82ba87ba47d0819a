"""Checkpoints: atomic, keep-k, resumable; the reference's layout.

Layout: ``<dir>/step_<n>/arrays.npz + manifest.json (+ <dir>/LATEST)``,
key for key the layout of ``repro.train.checkpoint``, so a checkpoint one
package writes restores in the other.

* Atomicity: written into ``step_<n>.tmp``, fsynced, renamed; a crash in
  the middle of a save never corrupts the restore point.
* keep-k garbage collection bounds disk use on long runs.
* Dtype fidelity: every leaf restores with exactly the dtype it was saved
  with (pinned against the manifest): int8 TA banks, uint32 packed words
  and keys, bool rows.

Leaves are numpy arrays or tensors (saved through ``.cpu().numpy()``);
trees are dicts, tuples, lists and NamedTuples (a ``TrainState``: its
``OptState``, a 0-d int32 step), and ``None`` leaves are skipped.
:func:`restore` returns host arrays; :func:`restore_tensors` places each
leaf on its template leaf's device. The port has no typed key arrays:
keys are plain uint32 pairs, so ``key_impls`` is always empty.

Sharded trees (DTensor leaves over a ``RankMesh``): :func:`save` is
collective. Every rank gathers each sharded leaf whole (its shards
all-gathered), rank 0 writes, and the ranks meet at a barrier, so the
files hold whole arrays and do not depend on the writer's mesh.
``restore(..., shardings=)`` and ``restore_tensors(..., shardings=)``
lay every leaf out by ``shardings`` (a tree of ``NamedSharding``) on the
current mesh, whatever mesh wrote it, or none (reshard-on-load); each
rank cuts its own shards from the arrays it reads.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.autoshard import is_distributed


def _flatten_with_paths(tree) -> dict[str, Any]:
    flat = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            flat[path] = node

    walk(tree, "")
    return flat


def _unflatten_like(template, flat: dict[str, Any]):
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, tuple):
            vals = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else tuple(vals))
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return flat[path]

    return walk(template, "")


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(directory: str, step: int, tree, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write. Returns the final path. With DTensor
    leaves every rank must call it (see the module's docstring)."""
    flat = _flatten_with_paths(tree)
    final = os.path.join(directory, f"step_{step:09d}")
    if any(is_distributed(v) for v in flat.values()):
        import torch.distributed as dist

        writer = dist.get_rank() == 0
        arrays = {}
        for k, v in flat.items():   # each leaf whole on every rank, in turn
            v = shd.gather(v)
            if writer:
                arrays[k] = _host(v)
            del v
        if writer:
            _write(directory, step, arrays, final, keep, extra)
        collectives.barrier()
        return final
    arrays = {k: _host(v) for k, v in flat.items()}
    _write(directory, step, arrays, final, keep, extra)
    return final


def _write(directory: str, step: int, arrays: dict, final: str, keep: int,
           extra: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "key_impls": {},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(os.path.basename(final))

    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    marker = os.path.join(directory, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _step_dir(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return os.path.join(directory, f"step_{step:09d}")


def read_manifest(directory: str, *, step: Optional[int] = None) -> dict:
    """The manifest alone (no array IO), for callers that build a restore
    template from ``extra`` before loading the arrays."""
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


def restore_tensors(directory: str, template, *,
                    step: Optional[int] = None, shardings=None):
    """:func:`restore`, with every leaf whose template leaf is a tensor made
    a tensor on that leaf's device (the reference's default placement; a
    ``TrainState`` restores this way), or, with ``shardings``, every leaf
    laid out by them. Returns (tree, manifest)."""
    if shardings is not None:
        return restore(directory, template, step=step, shardings=shardings)
    tree, manifest = restore(directory, template, step=step)
    return T.map(lambda t, a: (torch.from_numpy(a).to(t.device)
                               if torch.is_tensor(t) else a),
                 template, tree), manifest


def restore(directory: str, template, *, step: Optional[int] = None,
            shardings=None):
    """Load a checkpoint into the template's structure: host numpy arrays,
    each with exactly the dtype its manifest names. Returns
    (tree, manifest); the caller places leaves on its device.

    ``shardings`` (a tree of ``NamedSharding`` over a ``RankMesh``,
    matching the template) places every leaf under that mesh instead, as
    DTensors: a restart may use another mesh than the writer
    (reshard-on-load)."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("key_impls"):
        raise ValueError("checkpoint holds typed key arrays; the port reads "
                         "raw uint32 key data only")
    npz = os.path.join(path, "arrays.npz")
    data = _mapped(npz) if shardings is not None else None
    if data is None:
        data = np.load(npz)
    flat = {k: np.asarray(data[k], dtype=np.dtype(manifest["dtypes"][k]))
            for k in manifest["keys"]}
    tree = _unflatten_like(template, flat)
    if shardings is not None:
        tree = shd.distribute(tree, shardings)
    return tree, manifest


def _mapped(npz: str) -> Optional[dict]:
    """The arrays of an ``np.savez`` file as copy-on-write maps of it
    (``savez`` stores its members uncompressed), so that a rank that
    cuts its shards out of them reads only those pages; None when a
    member is compressed."""
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            # the member's data follow its local header: 30 bytes, then
            # the name and the extra field, whose lengths end the header
            f.seek(info.header_offset)
            n, m = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + n + m)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            out[info.filename[:-len(".npy")]] = np.memmap(
                npz, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                order="F" if fortran else "C")
    return out
