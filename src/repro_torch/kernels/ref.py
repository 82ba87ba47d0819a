"""Plain PyTorch versions of the kernel-contract entries the port runs.

The twins of ``repro.kernels.ref``'s ``clause_eval``, ``clause_eval_batch``
and ``feedback_step``, of their replica-first forms, of the two
bit-packed batch entries and of the four pruned (budgeted) entries with
their ``gather_include``: the ``"ref"`` backend on any device, and the
semantic ground truth the hand-written kernels are held to.

Packed words are int32 tensors holding uint32 bits
(:mod:`repro_torch.kernels.packing`); :func:`popcount` counts their bits
with a SWAR sum on int64.

Replica-first entries follow the contract's stacking rule: per-replica
operands carry a leading R, per-data-stream operands (literals, uniforms) a
leading D with D | R, and replica r reads data row r % D. A view as
[H, D, ...] (H = R / D) puts replica r = h * D + d on row d, so the data is
broadcast across H and never tiled.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packing import as_words


def clause_eval(include: torch.Tensor, literals: torch.Tensor, *,
                training: bool) -> torch.Tensor:
    """[C, J, L] bool x [L] bool -> [C, J] bool clause outputs.

    A clause fires iff every included literal is 1; an empty clause
    outputs ``training``.
    """
    match = ~include | literals[None, None, :]
    fired = torch.all(match, dim=-1)
    empty = ~torch.any(include, dim=-1)
    return torch.where(empty, training, fired)


def clause_eval_batch(include: torch.Tensor, literals: torch.Tensor, *,
                      training: bool) -> torch.Tensor:
    """[C, J, L] bool x [B, L] bool -> [B, C, J] bool.

    violations[b, cj] = sum_l (1 - literal[b, l]) * include[cj, l], as one
    float32 matrix product. The counts are integers <= L < 2**24, so the
    product is exact and row b equals :func:`clause_eval` on literals[b].
    """
    C, J, L = include.shape
    B = literals.shape[0]
    inc = include.reshape(C * J, L).to(torch.float32)
    neg = 1.0 - literals.to(torch.float32)
    violations = neg @ inc.T                                  # [B, CJ]
    fired = (violations == 0).reshape(B, C, J)
    empty = ~torch.any(include, dim=-1)
    return torch.where(empty[None], training, fired)


def clause_eval_loop(include: torch.Tensor, literals: torch.Tensor, *,
                     training: bool) -> torch.Tensor:
    """Per-sample-loop batched eval: [C, J, L] x [B, L] -> [B, C, J], row
    b :func:`clause_eval` on literals[b] (the reference's vmap of it); the
    oracle the batch paths are tested against."""
    return torch.stack([clause_eval(include, lit, training=training)
                        for lit in literals]) if literals.shape[0] else \
        torch.zeros((0,) + include.shape[:2], dtype=torch.bool,
                    device=include.device)


def feedback_probabilities(s: torch.Tensor, *, s_policy: str,
                           boost_true_positive: bool):
    """(p_strengthen, p_erase) as float32 0-dim tensors on ``s``'s device.

    standard: p_strengthen = (s-1)/s (or 1 with boost), p_erase = 1/s;
    hardware: p_strengthen as above, p_erase = (s-1)/s. Single IEEE float32
    operations, so the values equal the reference's bit for bit.
    """
    s = torch.as_tensor(s, dtype=torch.float32)
    ratio = (s - 1.0) / s
    p_strengthen = torch.ones_like(s) if boost_true_positive else ratio
    p_erase = (1.0 / s) if s_policy == "standard" else ratio
    return p_strengthen, p_erase


def feedback_step(
    ta_state: torch.Tensor,    # [C, J, L] int8/int16 (pre-update)
    literals: torch.Tensor,    # [L] bool
    clause_out: torch.Tensor,  # [C, J] bool (training-mode outputs)
    type1_sel: torch.Tensor,   # [C, J] bool
    type2_sel: torch.Tensor,   # [C, J] bool
    u: torch.Tensor,           # [C, J, L] f32 uniforms in [0, 1)
    *,
    s: torch.Tensor,           # 0-dim f32
    n_states: int,
    s_policy: str,
    boost_true_positive: bool,
) -> torch.Tensor:
    """One datapoint's TA-bank update (Type I + Type II); new ta_state.

    Type I: clause=1 & lit=1 strengthens w.p. p_strengthen, otherwise the
    TA moves toward exclude w.p. p_erase. Type II: clause=1 & lit=0 &
    excluded moves toward include. The result is clipped to [1, 2N].
    """
    p_strengthen, p_erase = feedback_probabilities(
        s, s_policy=s_policy, boost_true_positive=boost_true_positive
    )
    lit = literals[None, None, :]
    c_out = clause_out[:, :, None]
    include = ta_state > n_states
    d1 = torch.where(
        c_out & lit,
        (u < p_strengthen).to(torch.int32),
        -(u < p_erase).to(torch.int32),
    )
    d2 = (c_out & ~lit & ~include).to(torch.int32)
    delta = (type1_sel[:, :, None].to(torch.int32) * d1
             + type2_sel[:, :, None].to(torch.int32) * d2)
    new_state = torch.clamp(ta_state.to(torch.int32) + delta, 1, 2 * n_states)
    return new_state.to(ta_state.dtype)


def _streams(R: int, D: int) -> int:
    if R % D:
        raise ValueError(f"data replicas {D} must divide replicas {R}")
    return R // D


def clause_eval_replicated(include: torch.Tensor, literals: torch.Tensor, *,
                           training: bool) -> torch.Tensor:
    """[R, C, J, L] bool x [D, L] bool -> [R, C, J] bool; replica r reads
    literal row r % D. Equals stacking :func:`clause_eval` per replica."""
    R, C, J, L = include.shape
    D = literals.shape[0]
    H = _streams(R, D)
    inc = include.reshape(H, D, C, J, L)
    fired = torch.all(~inc | literals[None, :, None, None, :], dim=-1)
    empty = ~torch.any(inc, dim=-1)
    return torch.where(empty, training, fired).reshape(R, C, J)


def clause_eval_batch_replicated(include: torch.Tensor,
                                 literals: torch.Tensor, *,
                                 training: bool) -> torch.Tensor:
    """[R, C, J, L] bool x [D, B, L] bool -> [R, B, C, J] bool; replica r
    reads batch r % D. One float32 batched product, exact as in
    :func:`clause_eval_batch`."""
    R, C, J, L = include.shape
    D, B, _ = literals.shape
    H = _streams(R, D)
    inc = include.reshape(H, D, C * J, L).to(torch.float32)
    neg = 1.0 - literals.to(torch.float32)                    # [D, B, L]
    viol = neg[None] @ inc.transpose(-1, -2)                  # [H, D, B, CJ]
    fired = (viol == 0).reshape(H, D, B, C, J)
    empty = ~torch.any(include, dim=-1).reshape(H, D, 1, C, J)
    return torch.where(empty, training, fired).reshape(R, B, C, J)


def feedback_step_replicated(
    ta_state: torch.Tensor,    # [R, C, J, L] int8/int16 (pre-update)
    literals: torch.Tensor,    # [D, L] bool, replica r reads row r % D
    clause_out: torch.Tensor,  # [R, C, J] bool
    type1_sel: torch.Tensor,   # [R, C, J] bool
    type2_sel: torch.Tensor,   # [R, C, J] bool
    u: torch.Tensor,           # [D, C, J, L] f32, replica r reads row r % D
    *,
    s: torch.Tensor,           # [R] (or 0-dim) f32
    n_states: int,
    s_policy: str,
    boost_true_positive: bool,
) -> torch.Tensor:
    """R TA banks updated as one plane: replica r equals
    ``feedback_step(ta[r], literals[r % D], ..., u[r % D], s=s[r])``.

    The uniforms stay [D, C, J, L]: replicas that share a data stream (one
    ordering under many (s, T) cells) read the same draws.
    """
    R, C, J, L = ta_state.shape
    D = literals.shape[0]
    H = _streams(R, D)
    s = torch.as_tensor(s, dtype=torch.float32).to(ta_state.device)
    p_strengthen, p_erase = feedback_probabilities(
        s.expand(R).reshape(H, D, 1, 1, 1), s_policy=s_policy,
        boost_true_positive=boost_true_positive)
    ta = ta_state.reshape(H, D, C, J, L)
    lit = literals[None, :, None, None, :]
    c_out = clause_out.reshape(H, D, C, J)[..., None]
    include = ta > n_states
    d1 = torch.where(c_out & lit, (u[None] < p_strengthen).to(torch.int32),
                     -(u[None] < p_erase).to(torch.int32))
    d2 = (c_out & ~lit & ~include).to(torch.int32)
    delta = (torch.where(type1_sel.reshape(H, D, C, J)[..., None], d1, 0)
             + torch.where(type2_sel.reshape(H, D, C, J)[..., None], d2, 0))
    new_state = torch.clamp(ta.to(torch.int32) + delta, 1, 2 * n_states)
    return new_state.to(ta_state.dtype).reshape(R, C, J, L)


# ---------------------------------------------------------------------------
# Bit-packed datapath: AND + popcount over 32-bit words
# ---------------------------------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its uint32 pattern), as int64: a SWAR
    sum on the word widened to int64 and masked to its 32 bits, so no
    step overflows or sign-extends."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def packed_violations(include_packed: torch.Tensor,
                      literals_packed: torch.Tensor) -> torch.Tensor:
    """sum_w popcount(include[..., w] & ~literal[..., w]) over the last
    axis, in int32; the operands broadcast against each other."""
    inc, lit = as_words(include_packed), as_words(literals_packed)
    return popcount(inc & ~lit).sum(-1).to(torch.int32)


def clause_eval_batch_packed(include_packed: torch.Tensor,
                             literals_packed: torch.Tensor, *,
                             training: bool) -> torch.Tensor:
    """[C, J, W] words x [B, W] words -> [B, C, J] bool.

    violations[b, c, j] = sum_w popcount(include[c, j, w] & ~literal[b, w]);
    a clause fires when that is 0 and is empty when its include words are
    all 0. Include tail bits are zero by the packing contract, so the
    count equals the unpacked one bit for bit and the result equals
    :func:`clause_eval_batch` on the unpacked operands.
    """
    viol = packed_violations(include_packed[None],
                             literals_packed[:, None, None, :])  # [B, C, J]
    empty = ~torch.any(include_packed != 0, dim=-1)              # [C, J]
    return torch.where(empty[None], training, viol == 0)


def clause_eval_batch_replicated_packed(include_packed: torch.Tensor,
                                        literals_packed: torch.Tensor, *,
                                        training: bool) -> torch.Tensor:
    """[R, C, J, W] words x [D, B, W] words -> [R, B, C, J] bool; replica r
    reads batch r % D. Equals stacking :func:`clause_eval_batch_packed`
    per replica, and :func:`clause_eval_batch_replicated` on the unpacked
    operands."""
    R, C, J, W = include_packed.shape
    D, B, _ = literals_packed.shape
    H = _streams(R, D)
    inc = include_packed.reshape(H, D, 1, C, J, W)
    lit = literals_packed[None, :, :, None, None, :]          # [1, D, B, 1, 1, W]
    viol = packed_violations(inc, lit)                        # [H, D, B, C, J]
    empty = ~torch.any(include_packed != 0, dim=-1).reshape(H, D, 1, C, J)
    return torch.where(empty, training, viol == 0).reshape(R, B, C, J)


# ---------------------------------------------------------------------------
# Budgeted (pruned) eval: the include bank compacted to the elected clauses
# ---------------------------------------------------------------------------


def check_sel(sel: torch.Tensor, n_clauses: int) -> None:
    """Reject clause ids outside [0, J) with a ValueError. The check reads
    ``sel`` only where it lies on the CPU, so no caller waits on the card:
    the port makes its selections from numpy rankings on the host and
    checks them there, before they cross to the device."""
    if sel.dtype.is_floating_point or sel.dtype == torch.bool:
        raise TypeError(f"sel must hold integer clause ids, got {sel.dtype}")
    if sel.device.type == "cpu" and sel.numel() and (
            int(sel.min()) < 0 or int(sel.max()) >= n_clauses):
        raise ValueError(f"sel holds clause ids outside [0, {n_clauses})")


def as_selection(sel, n_clauses: int, device) -> torch.Tensor:
    """Clause ids (numpy or a tensor) checked by :func:`check_sel` where
    they lie and moved to ``device``."""
    sel = torch.as_tensor(sel)
    check_sel(sel, n_clauses)
    return sel.to(device)


def gather_include(include: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Compact an include bank to the selected clauses: [..., C, J, L|W] x
    sel [..., C, M] -> [..., C, M, L|W]. Works on bool banks and on int32
    word banks alike: the gather never touches the last axis, so packed
    tail bits stay zero. Column m equals full-bank clause ``sel[c, m]``
    bit for bit, empty clauses included."""
    check_sel(sel, include.shape[-2])
    idx = sel.to(include.device, torch.int64)[..., None]
    return torch.take_along_dim(include, idx, dim=-2)


def clause_eval_batch_pruned(include: torch.Tensor, sel: torch.Tensor,
                             literals: torch.Tensor, *,
                             training: bool) -> torch.Tensor:
    """[C, J, L] x sel [C, M] x [B, L] -> [B, C, M]: column m is clause
    ``sel[c, m]``'s output, :func:`clause_eval_batch` on the compacted
    bank."""
    return clause_eval_batch(gather_include(include, sel), literals,
                             training=training)


def clause_eval_batch_pruned_replicated(include: torch.Tensor,
                                        sel: torch.Tensor,
                                        literals: torch.Tensor, *,
                                        training: bool) -> torch.Tensor:
    """[R, C, J, L] x sel [R, C, M] x [D, B, L] -> [R, B, C, M]; replica r
    reads batch r % D and its own ranking ``sel[r]``."""
    return clause_eval_batch_replicated(gather_include(include, sel),
                                        literals, training=training)


def clause_eval_batch_pruned_packed(include_packed: torch.Tensor,
                                    sel: torch.Tensor,
                                    literals_packed: torch.Tensor, *,
                                    training: bool) -> torch.Tensor:
    """[C, J, W] words x sel [C, M] x [B, W] words -> [B, C, M]; equals
    :func:`clause_eval_batch_pruned` on the unpacked operands."""
    return clause_eval_batch_packed(gather_include(include_packed, sel),
                                    literals_packed, training=training)


def clause_eval_batch_pruned_replicated_packed(
        include_packed: torch.Tensor, sel: torch.Tensor,
        literals_packed: torch.Tensor, *, training: bool) -> torch.Tensor:
    """[R, C, J, W] words x sel [R, C, M] x [D, B, W] words ->
    [R, B, C, M]."""
    return clause_eval_batch_replicated_packed(
        gather_include(include_packed, sel), literals_packed,
        training=training)
