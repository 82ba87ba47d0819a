"""Carry TA banks, runtimes and RNG keys between the two packages.

The reference package's ``TMState``, ``TMRuntime`` and uint32 key pairs,
taken as numpy arrays (``jax.tree.map(np.asarray, x)``), become the port's
on a given device; :func:`to_numpy` goes back. Both packages then compute
the same thing from the same values. The port imports nothing of the
reference: these functions read fields by name.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tm import TMRuntime, TMState, resolve_device


def state_from_numpy(state: Any, device=None) -> TMState:
    """A ``TMState`` whose ``ta_state`` is a numpy [C, J, L] int8/int16
    bank -> the port's ``TMState`` on ``device``."""
    dev = resolve_device(device)
    return TMState(ta_state=torch.from_numpy(
        np.array(state.ta_state)).to(dev))


def runtime_from_numpy(rt: Any, device=None) -> TMRuntime:
    """A ``TMRuntime`` of numpy arrays -> the port's, with the scalar ports
    ``s``/``T`` as 0-dim CPU tensors and the masks on ``device``."""
    dev = resolve_device(device)
    return TMRuntime(
        s=torch.tensor(np.float32(rt.s), dtype=torch.float32),
        T=torch.tensor(np.int32(rt.T), dtype=torch.int32),
        **{name: torch.from_numpy(np.array(getattr(rt, name), dtype=bool))
           .to(dev)
           for name in ("clause_mask", "class_mask", "ta_and_mask",
                        "ta_or_mask")},
    )


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A uint32 key pair [2] (the reference's raw key data) -> the port's
    int64 key tensor on ``device``."""
    dev = resolve_device(device)
    words = np.asarray(key, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(words).to(dev)


def to_numpy(x):
    """A tensor, or a NamedTuple of tensors (``TMState``, ``TMRuntime``),
    -> numpy (a NamedTuple of the same type with numpy fields). A key
    comes back as its two int64 words, each < 2**32."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return type(x)(*(to_numpy(f) for f in x))
