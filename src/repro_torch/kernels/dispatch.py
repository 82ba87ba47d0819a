"""Backend dispatch: the one seam between the TM core and its kernels.

* ``"ref"``  -- plain PyTorch (:mod:`repro_torch.kernels.ref`) on any
  device; the ground truth the kernels are held to.
* ``"cuda"`` -- the hand-written CUDA kernels (:mod:`repro_torch.kernels.ops`).
  A CPU tensor takes each kernel's plain version; a CUDA tensor launches
  the kernel or raises.
* ``"auto"`` -- ``"cuda"``, unless ``TM_BACKEND`` names another backend.

Every backend implements :class:`KernelBackend`, the twelve entries of
the reference's contract (``repro.kernels.dispatch``).
This module is the only place that knows which module backs which name.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch


class KernelBackend(NamedTuple):
    """The typed kernel contract.

    * ``clause_eval(include [C,J,L] bool, literals [L] bool, *, training)
      -> [C,J] bool`` -- one datapoint's clause plane.
    * ``clause_eval_batch(include [C,J,L] bool, literals [B,L] bool, *,
      training) -> [B,C,J] bool`` -- MUST equal stacking ``clause_eval``
      over rows bit for bit.
    * ``feedback_step(ta_state [C,J,L], literals [L], clause_out [C,J],
      type1_sel [C,J], type2_sel [C,J], u [C,J,L], *, s, n_states,
      s_policy, boost_true_positive) -> new ta_state`` -- one datapoint's
      TA update.

    Replica-first entries run R independent machines at once. Per-replica
    state and control carry a leading R; per-data-stream operands
    (literals, uniforms) a leading D with D | R, and replica r reads data
    row r % D:

    * ``clause_eval_replicated(include [R,C,J,L], literals [D,L], *,
      training) -> [R,C,J]`` -- MUST equal stacking
      ``clause_eval(include[r], literals[r % D])``.
    * ``clause_eval_batch_replicated(include [R,C,J,L], literals [D,B,L],
      *, training) -> [R,B,C,J]`` -- MUST equal stacking
      ``clause_eval_batch(include[r], literals[r % D])``.
    * ``feedback_step_replicated(ta_state [R,C,J,L], literals [D,L],
      clause_out / type1_sel / type2_sel [R,C,J], u [D,C,J,L], *, s [R] or
      0-dim, n_states, s_policy, boost_true_positive) -> [R,C,J,L]`` --
      MUST equal stacking ``feedback_step(ta[r], literals[r % D], ...,
      u[r % D], s=s[r])``.

    Bit-packed entries take words: int32 tensors holding the uint32 bits
    of the reference's packed rows (:mod:`repro_torch.kernels.packing`),
    W = 2 * ceil(f / 32) words in the two-half layout, include tail bits
    zero:

    * ``clause_eval_batch_packed(include_packed [C,J,W], literals_packed
      [B,W], *, training) -> [B,C,J]`` -- MUST equal
      ``clause_eval_batch`` on the corresponding unpacked operands.
    * ``clause_eval_batch_replicated_packed(include_packed [R,C,J,W],
      literals_packed [D,B,W], *, training) -> [R,B,C,J]`` -- the same
      ``r % D`` rule; MUST equal ``clause_eval_batch_replicated`` on the
      unpacked operands.

    Pruned (budgeted) entries take a selection ``sel`` of clause ids per
    class (int, within [0, J)) and contract only those clauses:

    * ``clause_eval_batch_pruned(include [C,J,L], sel [C,M], literals
      [B,L], *, training) -> [B,C,M]`` -- the include bank compacts to the
      selected clauses (a gather along J) before the contraction, so the
      work shrinks with the budget M. Column m MUST equal
      ``clause_eval_batch(...)[:, c, sel[c, m]]`` bit for bit.
    * ``clause_eval_batch_pruned_replicated(include [R,C,J,L], sel
      [R,C,M], literals [D,B,L], *, training) -> [R,B,C,M]`` -- replica r
      reads batch r % D and its own ranking ``sel[r]``.
    * ``clause_eval_batch_pruned_packed(include_packed [C,J,W], sel [C,M],
      literals_packed [B,W], *, training) -> [B,C,M]`` and
      ``clause_eval_batch_pruned_replicated_packed([R,C,J,W], [R,C,M],
      [D,B,W], *, training) -> [R,B,C,M]`` -- the packed twins: the gather
      never touches the word axis, so packed pruned MUST equal unpacked
      pruned bit for bit.
    """

    name: str
    clause_eval: Callable[..., torch.Tensor]
    clause_eval_batch: Callable[..., torch.Tensor]
    feedback_step: Callable[..., torch.Tensor]
    clause_eval_replicated: Callable[..., torch.Tensor]
    clause_eval_batch_replicated: Callable[..., torch.Tensor]
    feedback_step_replicated: Callable[..., torch.Tensor]
    clause_eval_batch_packed: Callable[..., torch.Tensor]
    clause_eval_batch_replicated_packed: Callable[..., torch.Tensor]
    clause_eval_batch_pruned: Callable[..., torch.Tensor]
    clause_eval_batch_pruned_replicated: Callable[..., torch.Tensor]
    clause_eval_batch_pruned_packed: Callable[..., torch.Tensor]
    clause_eval_batch_pruned_replicated_packed: Callable[..., torch.Tensor]


_FACTORIES: dict[str, Callable[[], KernelBackend]] = {}
_CACHE: dict[str, KernelBackend] = {}


def register(name: str, factory: Callable[[], KernelBackend]) -> None:
    """Register (or replace) a backend under ``name``."""
    _FACTORIES[name] = factory
    _CACHE.pop(name, None)


def available() -> tuple[str, ...]:
    """Registered backend names (plus the ``auto`` alias)."""
    return tuple(sorted(_FACTORIES)) + ("auto",)


def _auto_name() -> str:
    # TM_BACKEND overrides auto-resolution, as in the reference.
    return os.environ.get("TM_BACKEND") or "cuda"


def resolve(name: str) -> KernelBackend:
    """Backend name (or ``"auto"``) -> the :class:`KernelBackend`."""
    if name == "auto":
        name = _auto_name()
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown kernel backend {name!r}; available: {available()}"
        )
    if name not in _CACHE:
        _CACHE[name] = _FACTORIES[name]()
    return _CACHE[name]


def _make_ref() -> KernelBackend:
    from repro_torch.kernels import ref

    return KernelBackend(
        name="ref",
        clause_eval=ref.clause_eval,
        clause_eval_batch=ref.clause_eval_batch,
        feedback_step=ref.feedback_step,
        clause_eval_replicated=ref.clause_eval_replicated,
        clause_eval_batch_replicated=ref.clause_eval_batch_replicated,
        feedback_step_replicated=ref.feedback_step_replicated,
        clause_eval_batch_packed=ref.clause_eval_batch_packed,
        clause_eval_batch_replicated_packed=(
            ref.clause_eval_batch_replicated_packed),
        clause_eval_batch_pruned=ref.clause_eval_batch_pruned,
        clause_eval_batch_pruned_replicated=(
            ref.clause_eval_batch_pruned_replicated),
        clause_eval_batch_pruned_packed=ref.clause_eval_batch_pruned_packed,
        clause_eval_batch_pruned_replicated_packed=(
            ref.clause_eval_batch_pruned_replicated_packed),
    )


def _make_cuda() -> KernelBackend:
    from repro_torch.kernels import ops

    return KernelBackend(
        name="cuda",
        clause_eval=ops.clause_eval,
        clause_eval_batch=ops.clause_eval_batch,
        feedback_step=ops.feedback_step,
        clause_eval_replicated=ops.clause_eval_replicated,
        clause_eval_batch_replicated=ops.clause_eval_batch_replicated,
        feedback_step_replicated=ops.feedback_step_replicated,
        clause_eval_batch_packed=ops.clause_eval_batch_packed,
        clause_eval_batch_replicated_packed=(
            ops.clause_eval_batch_replicated_packed),
        clause_eval_batch_pruned=ops.clause_eval_batch_pruned,
        clause_eval_batch_pruned_replicated=(
            ops.clause_eval_batch_pruned_replicated),
        clause_eval_batch_pruned_packed=ops.clause_eval_batch_pruned_packed,
        clause_eval_batch_pruned_replicated_packed=(
            ops.clause_eval_batch_pruned_replicated_packed),
    )


register("ref", _make_ref)
register("cuda", _make_cuda)
