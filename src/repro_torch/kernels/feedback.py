"""Fused Type I/II TA-bank update: the hand-written CUDA kernels K8 and K9.

Replaces the Pallas kernels ``feedback_plane`` (K8) and
``feedback_plane_replicated`` (K9) of the reference package's
``kernels/feedback.py``, which tiled the [CJ, L] planes in 32 x 512 blocks
with the per-row control packed into an int8 tile. Here
(``csrc/feedback.cu``) both are one elementwise pass over the flattened
banks, for int8 and int16 TAs, with the three per-row controls as bool
planes. K8 is one bank with the two probabilities passed by value; K9
takes R banks, reads literals and uniforms at data stream r % D, and reads
p_strengthen / p_erase from two [R] float32 device arrays. Where L % 16 ==
0 and every operand is 16-byte aligned (iris and MNIST widths), a thread
updates 16 TAs of a row from 16-byte loads; other widths, and views with a
storage offset, take a one-thread-per-TA scalar path. The CUDA launcher
picks the path from the shapes and pointers.

Bound on an H100: memory. At the MNIST width K8 moves about 6.0 MB per
datapoint (the TA bank in and out, 2.0 MB; the float32 uniforms u,
4.0 MB); K9 at R = D = 8 moves about 48 MB (16 MB of banks in and out,
32 MB of u), a 14 us bound. Both do a handful of integer operations per
TA. Reading u from memory keeps them bitwise the reference; a variant that
draws u in registers from the same threefry counters is later work.

The wrappers take the plain PyTorch version for CPU tensors. For CUDA
tensors they launch the kernel, count the launch in ``<wrapper>.launches``,
or raise; they never fall back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clause_eval import (
    _bytes,
    _same_device,
    _stream,
    _streams,
)

_ENTRY = {torch.int8: "feedback_plane_i8", torch.int16: "feedback_plane_i16"}
_ENTRY_REP = {torch.int8: "feedback_plane_replicated_i8",
              torch.int16: "feedback_plane_replicated_i16"}


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


def feedback_plane_replicated_plain(ta_state, literals, clause_out,
                                    type1_sel, type2_sel, u, p_strengthen,
                                    p_erase, *, n_states: int
                                    ) -> torch.Tensor:
    """K9's plain version: new ta_state [R, CJ, L], replica r reading
    literal and u row r % D and probabilities p_*[r]."""
    R, cj, L = ta_state.shape
    D = literals.shape[0]
    H = R // D
    ps = p_strengthen.to(torch.float32).reshape(H, D, 1, 1)
    pe = p_erase.to(torch.float32).reshape(H, D, 1, 1)
    lit = literals.to(torch.bool)[None, :, None, :]
    ctl = [t.to(torch.bool).reshape(H, D, cj, 1)
           for t in (clause_out, type1_sel, type2_sel)]
    ta = ta_state.reshape(H, D, cj, L)
    include = ta > n_states
    d1 = torch.where(ctl[0] & lit, (u[None] < ps).to(torch.int32),
                     -(u[None] < pe).to(torch.int32))
    d2 = (ctl[0] & ~lit & ~include).to(torch.int32)
    delta = torch.where(ctl[1], d1, 0) + torch.where(ctl[2], d2, 0)
    out = torch.clamp(ta.to(torch.int32) + delta, 1, 2 * n_states)
    return out.to(ta_state.dtype).reshape(R, cj, L)


def _check_banks(ta_state, u, entries):
    if ta_state.dtype not in entries:
        raise TypeError(f"TA bank must be int8/int16, got {ta_state.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")


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
    _check_banks(ta_state, u, _ENTRY)
    _same_device(ta_state, literals, clause_out, type1_sel, type2_sel, u)
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


def feedback_plane_replicated(ta_state, literals, clause_out, type1_sel,
                              type2_sel, u, p_strengthen, p_erase, *,
                              n_states: int) -> torch.Tensor:
    """K9: ta_state [R, CJ, L] int8/int16, literals [D, L] bool,
    clause_out / type1_sel / type2_sel [R, CJ] bool, u [D, CJ, L] f32,
    p_strengthen / p_erase [R] f32 (D | R; replica r reads literal and u
    row r % D) -> new ta_state [R, CJ, L]."""
    R, cj, L = ta_state.shape
    D = literals.shape[0]
    _streams(R, D)
    if literals.shape != (D, L) or u.shape != (D, cj, L):
        raise ValueError("feedback_plane_replicated operand shapes disagree")
    for name, t in (("clause_out", clause_out), ("type1_sel", type1_sel),
                    ("type2_sel", type2_sel)):
        if t.shape != (R, cj):
            raise ValueError(f"{name} {tuple(t.shape)} != ({R}, {cj})")
    for name, t in (("p_strengthen", p_strengthen), ("p_erase", p_erase)):
        if t.shape != (R,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({R},)")
    if ta_state.device.type == "cpu":
        return feedback_plane_replicated_plain(
            ta_state, literals, clause_out, type1_sel, type2_sel, u,
            p_strengthen, p_erase, n_states=n_states)
    _check_banks(ta_state, u, _ENTRY_REP)
    for name, t in (("p_strengthen", p_strengthen), ("p_erase", p_erase)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    _same_device(ta_state, literals, clause_out, type1_sel, type2_sel, u,
                 p_strengthen, p_erase)
    ta = ta_state.contiguous()
    uu = u.contiguous()
    ps, pe = p_strengthen.contiguous(), p_erase.contiguous()
    lit = _bytes(literals, "literals")
    c, t1, t2 = (_bytes(t, n) for t, n in (
        (clause_out, "clause_out"), (type1_sel, "type1_sel"),
        (type2_sel, "type2_sel")))
    out = torch.empty_like(ta)
    fn = getattr(_build.library("feedback"), _ENTRY_REP[ta.dtype])
    _build.check(fn(
        out.data_ptr(), ta.data_ptr(), lit.data_ptr(), c.data_ptr(),
        t1.data_ptr(), t2.data_ptr(), uu.data_ptr(), ps.data_ptr(),
        pe.data_ptr(), R, D, cj, L, n_states, _stream(ta)),
        "feedback_plane_replicated")
    feedback_plane_replicated.launches += 1
    return out


feedback_plane_replicated.launches = 0
