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
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


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
    """Atomic checkpoint write. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}
    final = os.path.join(directory, f"step_{step:09d}")
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
    return final


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
                    step: Optional[int] = None):
    """:func:`restore`, with every leaf whose template leaf is a tensor made
    a tensor on that leaf's device (the reference's default placement; a
    ``TrainState`` restores this way). Returns (tree, manifest)."""
    tree, manifest = restore(directory, template, step=step)
    return T.map(lambda t, a: (torch.from_numpy(a).to(t.device)
                               if torch.is_tensor(t) else a),
                 template, tree), manifest


def restore(directory: str, template, *, step: Optional[int] = None):
    """Load a checkpoint into the template's structure: host numpy arrays,
    each with exactly the dtype its manifest names. Returns
    (tree, manifest); the caller places leaves on its device."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("key_impls"):
        raise ValueError("checkpoint holds typed key arrays; the port reads "
                         "raw uint32 key data only")
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = {k: np.asarray(data[k], dtype=np.dtype(manifest["dtypes"][k]))
            for k in manifest["keys"]}
    return _unflatten_like(template, flat), manifest
