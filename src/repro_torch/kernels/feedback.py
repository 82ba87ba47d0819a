"""Fused Type I/II TA-bank update: the hand-written CUDA kernel K8.

Replaces the Pallas kernel ``feedback_plane`` of the reference package's
``kernels/feedback.py``, which tiled the [CJ, L] plane in 32 x 512 blocks
with the per-row control packed into an int8 tile. Here
(``csrc/feedback.cu``) it is one elementwise pass over the flattened bank,
for int8 and int16 TAs, with the three per-row controls as [CJ] bool
vectors and the two probabilities passed by value.

Bound on an H100: memory. At the MNIST width it moves about 6.0 MB per
datapoint (the TA bank in and out, 2.0 MB; the float32 uniforms u, 4.0 MB)
and does a handful of integer operations per TA, so it is launch-bound at
1 M TAs. Reading u from memory keeps it bitwise the reference; a variant
that draws u in registers from the same threefry counters is later work.

The wrapper takes the plain PyTorch version for CPU tensors. For CUDA
tensors it launches the kernel, counts the launch in
``feedback_plane.launches``, or raises; it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clause_eval import _bytes, _stream

_ENTRY = {torch.int8: "feedback_plane_i8", torch.int16: "feedback_plane_i16"}


def feedback_plane_plain(ta_state, literals, clause_out, type1_sel, type2_sel,
                         u, p_strengthen: float, p_erase: float, *,
                         n_states: int) -> torch.Tensor:
    """K8's plain version over the flattened plane: new ta_state [CJ, L]."""
    # Python-float operands compare in u's float32, as the kernel does.
    ps, pe = float(p_strengthen), float(p_erase)
    lit = literals.to(torch.bool)[None, :]
    c_out = clause_out.to(torch.bool)[:, None]
    include = ta_state > n_states
    d1 = torch.where(c_out & lit, (u < ps).to(torch.int32),
                     -(u < pe).to(torch.int32))
    d2 = (c_out & ~lit & ~include).to(torch.int32)
    delta = (torch.where(type1_sel.to(torch.bool)[:, None], d1, 0)
             + torch.where(type2_sel.to(torch.bool)[:, None], d2, 0))
    out = torch.clamp(ta_state.to(torch.int32) + delta, 1, 2 * n_states)
    return out.to(ta_state.dtype)


def feedback_plane(ta_state, literals, clause_out, type1_sel, type2_sel, u,
                   p_strengthen: float, p_erase: float, *,
                   n_states: int) -> torch.Tensor:
    """K8: ta_state [CJ, L] int8/int16, literals [L] bool, clause_out /
    type1_sel / type2_sel [CJ] bool, u [CJ, L] f32, and the two float32
    probabilities -> new ta_state [CJ, L]."""
    cj, L = ta_state.shape
    if literals.shape != (L,) or u.shape != (cj, L):
        raise ValueError("feedback_plane operand shapes disagree")
    for name, t in (("clause_out", clause_out), ("type1_sel", type1_sel),
                    ("type2_sel", type2_sel)):
        if t.shape != (cj,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({cj},)")
    if ta_state.device.type == "cpu":
        return feedback_plane_plain(
            ta_state, literals, clause_out, type1_sel, type2_sel, u,
            p_strengthen, p_erase, n_states=n_states)
    if ta_state.dtype not in _ENTRY:
        raise TypeError(f"TA bank must be int8/int16, got {ta_state.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    dev = ta_state.device
    ops = (literals, clause_out, type1_sel, type2_sel, u)
    if any(t.device != dev for t in ops):
        raise ValueError("feedback_plane operands on different devices")
    ta = ta_state.contiguous()
    uu = u.contiguous()
    lit = _bytes(literals, "literals")
    c, t1, t2 = (_bytes(t, n) for t, n in (
        (clause_out, "clause_out"), (type1_sel, "type1_sel"),
        (type2_sel, "type2_sel")))
    out = torch.empty_like(ta)
    fn = getattr(_build.library("feedback"), _ENTRY[ta.dtype])
    _build.check(fn(
        out.data_ptr(), ta.data_ptr(), lit.data_ptr(), c.data_ptr(),
        t1.data_ptr(), t2.data_ptr(), uu.data_ptr(), float(p_strengthen),
        float(p_erase), cj, L, n_states, _stream(ta)), "feedback_plane")
    feedback_plane.launches += 1
    return out


feedback_plane.launches = 0
