"""Parameter specification trees.

Every model is declared once as a tree of :class:`PSpec` (shape + logical
axis names + initializer), as in the reference. From that one declaration
come the real parameters (:func:`materialize`) and the parameter count
(:func:`count_params`).

The reference seeds each leaf with ``fold_in(key, hash(path) % 2**31)``.
Python salts ``hash`` of a string per process, so the reference's initial
weights cannot be reproduced in another process, and the port does not
try: :func:`materialize` draws every leaf in turn from one explicit
``torch.Generator``. Parity with the reference goes through
``convert.lm_params_from_numpy`` on the reference's own parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.tm import resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis per dim, e.g. ("vocab","embed")
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 1.0                # stddev multiplier / fan-in override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


class ShapeDtype(NamedTuple):
    """An abstract array (cache and input trees): shape and torch dtype."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_map_specs(fn: Callable[[PSpec], Any], tree):
    """Map over a nested dict-of-PSpec tree."""
    if isinstance(tree, PSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    raise TypeError(f"unexpected node {type(tree)}")


def stack_specs(tree, n: int, axis_name: Optional[str] = None):
    """Add a leading stacked-layers dim of size n to every spec."""
    return tree_map_specs(
        lambda s: PSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        tree,
    )


def _init_one(spec: PSpec, gen: torch.Generator, dtype,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "normal":
        # fan-in scaled normal over the first axis (or only axis); for a
        # stacked spec that is the layer dim, as in the reference.
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
        std = spec.scale / math.sqrt(fan_in)
        return std * torch.randn(spec.shape, generator=gen, dtype=dtype,
                                 device=device)
    if spec.init == "scaled":
        return spec.scale * torch.randn(spec.shape, generator=gen,
                                        dtype=dtype, device=device)
    raise ValueError(f"unknown init {spec.init}")


def materialize(tree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Real parameters, drawn leaf by leaf (in the tree's order) from
    ``generator`` straight into ``device`` memory. The generator must live
    on that device (``torch.Generator(device=...).manual_seed(seed)``)."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters on {dev}")

    def walk(node):
        if isinstance(node, PSpec):
            return _init_one(node, generator, dtype, dev)
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def count_params(tree) -> int:
    total = 0

    def add(s: PSpec):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map_specs(add, tree)
    return total
