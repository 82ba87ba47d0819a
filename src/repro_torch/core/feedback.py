"""TM learning on torch: feedback selection and TA updates (paper §2, §4).

The twin of ``repro.core.feedback`` for one machine. Datapoints stream
through a Python loop in the FPGA's serial row order (feedback at step t
sees the TA state of step t-1), where the reference runs ``lax.scan`` and
``fori_loop``. The key schedule is the reference's, draw for draw:
``split(key)`` per datapoint update, ``split(key, n)`` per pass over a set
and ``fold_in(key, epoch)`` per epoch. So the TA banks agree bit for bit.

The replica-first engine (``*_replicated``) advances R machines per step in
one fused plane: per-replica state and control carry a leading R, the data
streams (rows, labels, keys) a leading D with D | R, and replica r consumes
stream r % D. The keys are batched ``[D, 2]`` and every draw is one
threefry call over all streams, so a step costs the same launches whatever
R is. Replica r is bitwise :func:`train_update` on stream r % D.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import random as rnd
from repro_torch.core import tm as tm_mod
from repro_torch.core.tm import TMConfig, TMRuntime, TMState
from repro_torch.kernels import dispatch


class StepAux(NamedTuple):
    """Per-step observability (feeds the accuracy/energy analysis)."""

    votes: torch.Tensor      # [C] i32 class sums (training-mode outputs)
    predicted: torch.Tensor  # 0-dim i32 argmax class (inference mode)
    correct: torch.Tensor    # 0-dim bool
    activity: torch.Tensor   # 0-dim f32: fraction of TAs that changed


def _selection_core(cfg: TMConfig, T: int, clause_mask: torch.Tensor,
                    class_mask: torch.Tensor, votes: torch.Tensor,
                    y: torch.Tensor, key: torch.Tensor):
    """Per-clause feedback types for the target and one sampled non-target.

    Target class y:   P(feedback) = (T - clip(v_y)) / 2T; positive-polarity
                      clauses get Type I, negative Type II.
    Sampled class ny: P(feedback) = (T + clip(v_ny)) / 2T; positive get
                      Type II, negative Type I.
    Returns (type1, type2), both [C, J] bool.
    """
    k_neg, k_t, k_n = rnd.split(key, 3)
    C, J = cfg.max_classes, cfg.max_clauses
    dev = votes.device
    cls = torch.arange(C, device=dev)
    y = y.reshape(1).to(torch.int64)

    neg_ok = class_mask & (cls != y)
    logits = torch.where(neg_ok, 0.0, float("-inf"))
    ny = rnd.categorical(k_neg, logits).reshape(1)

    # T is an integer below 2**24, so the float32 operations below are the
    # reference's single IEEE operations on the same values.
    Tf = float(T)
    v = torch.clamp(votes, -T, T).to(torch.float32)
    p_t = (Tf - v.gather(0, y)) / (2.0 * Tf)
    p_n = (Tf + v.gather(0, ny)) / (2.0 * Tf)

    sel_t = (rnd.uniform(k_t, (J,)) < p_t) & clause_mask
    sel_n = (rnd.uniform(k_n, (J,)) < p_n) & clause_mask

    pos = tm_mod.clause_polarity(cfg, dev) > 0
    onehot_y = cls == y
    onehot_n = cls == ny
    type1 = (onehot_y[:, None] & (sel_t & pos)[None, :]
             | onehot_n[:, None] & (sel_n & ~pos)[None, :])
    type2 = (onehot_y[:, None] & (sel_t & ~pos)[None, :]
             | onehot_n[:, None] & (sel_n & pos)[None, :])
    # Inactive classes never receive feedback (over-provisioning, §3.1.1).
    return type1 & class_mask[:, None], type2 & class_mask[:, None]


def train_update(cfg: TMConfig, state: TMState, rt: TMRuntime,
                 x: torch.Tensor, y: torch.Tensor, key: torch.Tensor
                 ) -> tuple[TMState, torch.Tensor, torch.Tensor]:
    """One supervised datapoint's TA-bank update, without monitoring.

    One training-mode clause plane (K1), the feedback selection, one
    uniform per TA, and the fused update (K8). Returns (new_state,
    training-mode votes [C], activity).
    """
    k_sel, k_u = rnd.split(key)
    lits = tm_mod.make_literals(x)
    include = tm_mod.ta_actions(cfg, state, rt)

    clauses_tr = tm_mod.eval_clauses(cfg, include, lits, rt, training=True)
    votes = tm_mod.class_sums(cfg, clauses_tr)

    type1, type2 = _selection_core(cfg, int(rt.T), rt.clause_mask,
                                   rt.class_mask, votes, y, k_sel)
    u = rnd.uniform(k_u, (cfg.max_classes, cfg.max_clauses, cfg.n_literals))

    new_ta = dispatch.resolve(cfg.backend).feedback_step(
        state.ta_state, lits, clauses_tr, type1, type2, u,
        s=rt.s, n_states=cfg.n_states, s_policy=cfg.s_policy,
        boost_true_positive=cfg.boost_true_positive,
    )
    activity = tm_mod.mean_of_count((new_ta != state.ta_state).sum(),
                                    new_ta.numel())
    return TMState(ta_state=new_ta), votes, activity


def train_step(cfg: TMConfig, state: TMState, rt: TMRuntime,
               x: torch.Tensor, y: torch.Tensor, key: torch.Tensor
               ) -> tuple[TMState, StepAux]:
    """One supervised datapoint: feedback plus inference-mode monitoring
    under the pre-update state."""
    new_state, votes, activity = train_update(cfg, state, rt, x, y, key)

    lits = tm_mod.make_literals(x)
    include = tm_mod.ta_actions(cfg, state, rt)
    clauses_inf = tm_mod.eval_clauses(cfg, include, lits, rt, training=False)
    votes_inf = tm_mod.class_sums(cfg, clauses_inf)
    pred = tm_mod._masked_argmax(votes_inf, rt.class_mask)
    aux = StepAux(votes=votes, predicted=pred,
                  correct=pred == y.to(torch.int32), activity=activity)
    return new_state, aux


def train_datapoints(cfg: TMConfig, state: TMState, rt: TMRuntime,
                     xs: torch.Tensor, ys: torch.Tensor, key: torch.Tensor,
                     valid: Optional[torch.Tensor] = None
                     ) -> tuple[TMState, StepAux]:
    """Stream datapoints serially in row order. Rows where ``valid`` is
    False leave the state untouched. Returns the final state and the
    per-step :class:`StepAux`, stacked."""
    n = xs.shape[0]
    keys = rnd.split(key, n)
    auxes = []
    for i in range(n):
        new_st, aux = train_step(cfg, state, rt, xs[i], ys[i], keys[i])
        if valid is None:
            state = new_st
        else:
            v = valid[i]
            state = TMState(torch.where(v, new_st.ta_state, state.ta_state))
            aux = aux._replace(
                activity=torch.where(v, aux.activity, 0.0),
                correct=aux.correct & v,
            )
        auxes.append(aux)
    return state, StepAux(*(torch.stack(f) for f in zip(*auxes)))


def train_epochs(cfg: TMConfig, state: TMState, rt: TMRuntime,
                 xs: torch.Tensor, ys: torch.Tensor, key: torch.Tensor,
                 n_epochs: int, valid: Optional[torch.Tensor] = None
                 ) -> TMState:
    """Repeat the set for ``n_epochs`` passes, epoch i keyed by
    ``fold_in(key, i)``."""
    for i in range(int(n_epochs)):
        state, _ = train_datapoints(cfg, state, rt, xs, ys,
                                    rnd.fold_in(key, i), valid)
    return state


# ---------------------------------------------------------------------------
# Replica-first training (cross-validation x hyperparameter sweep axis)
# ---------------------------------------------------------------------------


def _replica_counts(state: TMState, xs: torch.Tensor) -> tuple[int, int]:
    R = state.ta_state.shape[0]
    D = xs.shape[0]
    if R % D:
        raise ValueError(f"data replicas {D} must divide replicas {R}")
    return R, D


def _selection_core_replicated(cfg: TMConfig, T: torch.Tensor,
                               clause_mask: torch.Tensor,
                               class_mask: torch.Tensor, votes: torch.Tensor,
                               y: torch.Tensor, key: torch.Tensor):
    """:func:`_selection_core` for R replicas at once: T [R] i32 and votes
    [R, C] on the device, y [R], keys [R, 2]. Row r draws exactly what the
    single-machine core draws from key r. Returns (type1, type2), both
    [R, C, J] bool."""
    ks = rnd.split(key, 3)                                   # [R, 3, 2]
    k_neg, k_t, k_n = ks[:, 0], ks[:, 1], ks[:, 2]
    C, J = cfg.max_classes, cfg.max_clauses
    dev = votes.device
    cls = torch.arange(C, device=dev)
    y = y.to(torch.int64)[:, None]                           # [R, 1]

    neg_ok = class_mask & (cls != y)                         # [R, C]
    logits = torch.where(neg_ok, 0.0, float("-inf"))
    ny = rnd.categorical(k_neg, logits)[:, None]             # [R, 1]

    # T is an integer below 2**24: the float32 operations below are the
    # reference's single IEEE operations on the same values.
    Ti = T[:, None]
    Tf = T.to(torch.float32)
    v = torch.minimum(torch.maximum(votes, -Ti), Ti).to(torch.float32)
    p_t = (Tf - v.gather(1, y)[:, 0]) / (2.0 * Tf)
    p_n = (Tf + v.gather(1, ny)[:, 0]) / (2.0 * Tf)

    sel_t = (rnd.uniform(k_t, (J,)) < p_t[:, None]) & clause_mask
    sel_n = (rnd.uniform(k_n, (J,)) < p_n[:, None]) & clause_mask

    pos = tm_mod.clause_polarity(cfg, dev) > 0
    onehot_y = (cls == y)[:, :, None]                        # [R, C, 1]
    onehot_n = (cls == ny)[:, :, None]
    type1 = (onehot_y & (sel_t & pos)[:, None, :]
             | onehot_n & (sel_n & ~pos)[:, None, :])
    type2 = (onehot_y & (sel_t & ~pos)[:, None, :]
             | onehot_n & (sel_n & pos)[:, None, :])
    gate = class_mask[:, None]
    return type1 & gate, type2 & gate


def train_update_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                            x: torch.Tensor, y: torch.Tensor,
                            key: torch.Tensor
                            ) -> tuple[TMState, torch.Tensor, torch.Tensor]:
    """One datapoint's TA-bank update for all R replicas at once.

    state leaves [R, ...], x [D, f], y [D], keys [D, 2]; ``rt.s``/``rt.T``
    0-dim or [R] (copied to the card here unless :func:`~repro_torch.core.
    tm.replica_ports` already put them there), masks shared. Replica r performs exactly
    :func:`train_update` on stream r % D with ``s[r]``/``T[r]``: one
    replica-first clause plane (K3), the batched selection, one [D, C, J,
    L] uniform draw shared by the replicas of a stream, and the fused
    update (K9). Returns (new_state, votes [R, C], activity [R]).
    """
    R, D = _replica_counts(state, x)
    H = R // D
    rt = tm_mod.replica_ports(rt, R, state.ta_state.device)
    k2 = rnd.split(key)                                      # [D, 2, 2]
    k_sel, k_u = k2[:, 0], k2[:, 1]

    lits = tm_mod.make_literals(x)                           # [D, L]
    include = tm_mod.ta_actions(cfg, state, rt)              # [R, C, J, L]
    backend = dispatch.resolve(cfg.backend)
    clauses_tr = backend.clause_eval_replicated(include, lits, training=True)
    clauses_tr = clauses_tr & rt.clause_mask[None, None, :]
    votes = tm_mod.class_sums(cfg, clauses_tr)               # [R, C]

    type1, type2 = _selection_core_replicated(
        cfg, rt.T, rt.clause_mask, rt.class_mask, votes, y.repeat(H),
        k_sel.repeat(H, 1))
    u = rnd.uniform(k_u, (cfg.max_classes, cfg.max_clauses, cfg.n_literals))

    new_ta = backend.feedback_step_replicated(
        state.ta_state, lits, clauses_tr, type1, type2, u,
        s=rt.s, n_states=cfg.n_states, s_policy=cfg.s_policy,
        boost_true_positive=cfg.boost_true_positive,
    )
    changed = (new_ta != state.ta_state).reshape(R, -1).sum(-1)
    activity = tm_mod.mean_of_count(changed, new_ta[0].numel())
    return TMState(ta_state=new_ta), votes, activity


def train_datapoints_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                                xs: torch.Tensor, ys: torch.Tensor,
                                key: torch.Tensor,
                                valid: Optional[torch.Tensor] = None
                                ) -> tuple[TMState, torch.Tensor]:
    """Stream the D data sets serially (xs [D, n, f], ys [D, n], keys
    [D, 2], valid [D, n]) while updating all R replicas per step. Replica r
    is gated by stream r % D's valid row, on the device. Returns
    (final_state, activity [n, R])."""
    R, D = _replica_counts(state, xs)
    H = R // D
    n = xs.shape[1]
    rt = tm_mod.replica_ports(rt, R, state.ta_state.device)  # once a pass
    keys = rnd.split(key, n).transpose(0, 1)                 # [n, D, 2]
    acts = []
    for i in range(n):
        new_st, _, act = train_update_replicated(
            cfg, state, rt, xs[:, i], ys[:, i], keys[i])
        if valid is None:
            state = new_st
        else:
            vR = valid[:, i].repeat(H)                       # replica r: r % D
            state = TMState(torch.where(vR[:, None, None, None],
                                        new_st.ta_state, state.ta_state))
            act = torch.where(vR, act, 0.0)
        acts.append(act)
    return state, torch.stack(acts)


def train_epochs_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                            xs: torch.Tensor, ys: torch.Tensor,
                            key: torch.Tensor, n_epochs: int,
                            valid: Optional[torch.Tensor] = None) -> TMState:
    """Replica-first :func:`train_epochs`: epoch i keyed by
    ``fold_in(keys, i)`` per stream."""
    for i in range(int(n_epochs)):
        state, _ = train_datapoints_replicated(
            cfg, state, rt, xs, ys, rnd.fold_in(key, i), valid)
    return state
