"""Carry TA banks, runtimes, RNG keys and data sets between the two packages.

The reference package's ``TMState`` (one bank [C, J, L] or R replicas
[R, C, J, L]), ``TMRuntime`` (scalar or per-replica [R] s/T ports), uint32
key pairs ([2] or batches [D, 2]) and ``manager.Sets``, taken as numpy
arrays (``jax.tree.map(np.asarray, x)``), become the port's on a given
device; :func:`to_numpy` goes back. Both packages then compute
the same thing from the same values. The port imports nothing of the
reference: these functions read fields by name.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tm import TMRuntime, TMState, resolve_device


def state_from_numpy(state: Any, device=None) -> TMState:
    """A ``TMState`` whose ``ta_state`` is a numpy [(R,) C, J, L] int8/int16
    bank -> the port's ``TMState`` on ``device``."""
    dev = resolve_device(device)
    return TMState(ta_state=torch.from_numpy(
        np.array(state.ta_state)).to(dev))


def runtime_from_numpy(rt: Any, device=None) -> TMRuntime:
    """A ``TMRuntime`` of numpy arrays -> the port's, with the ports
    ``s``/``T`` (0-dim or [R]) as CPU tensors and the masks on
    ``device``."""
    dev = resolve_device(device)
    return TMRuntime(
        s=torch.from_numpy(np.array(rt.s, dtype=np.float32)),
        T=torch.from_numpy(np.array(rt.T, dtype=np.int32)),
        **{name: torch.from_numpy(np.array(getattr(rt, name), dtype=bool))
           .to(dev)
           for name in ("clause_mask", "class_mask", "ta_and_mask",
                        "ta_or_mask")},
    )


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A uint32 key pair [2], or a batch [..., 2] (the reference's raw key
    data) -> the port's int64 key tensor on ``device``."""
    dev = resolve_device(device)
    words = np.asarray(key, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(words).to(dev)


def to_numpy(x):
    """A tensor, or a NamedTuple of tensors (``TMState``, ``TMRuntime``,
    ``Sets``), -> numpy (a NamedTuple of the same type with numpy fields;
    None stays None). A key comes back as its two int64 words, each
    < 2**32."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return type(x)(*(to_numpy(f) for f in x))


def sets_from_numpy(sets: Any, device=None):
    """A reference ``manager.Sets`` of numpy arrays (any leading ordering
    axis) -> the port's ``Sets`` on ``device``: x and valid as bool, y as
    int32; a missing ``offline_train_valid`` stays None."""
    from repro_torch.core.manager import Sets

    dev = resolve_device(device)
    out = {}
    for name in Sets._fields:
        v = getattr(sets, name)
        if v is None:
            out[name] = None
            continue
        dtype = np.int32 if name.endswith("_y") else bool
        out[name] = torch.from_numpy(np.array(v, dtype=dtype)).to(dev)
    return Sets(**out)
