"""Contract wrappers over the hand-written CUDA kernels (the ``"cuda"``
backend).

Same contracts as :mod:`repro_torch.kernels.ref`, so the TM core switches
backends through ``TMConfig.backend`` alone. The entries reshape the
[(R,) C, J, ...] contract operands to the kernels' flattened [(R,) CJ, ...]
planes. CPU tensors go to each kernel's plain version; CUDA tensors launch
it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import feedback as _fb
# K1 to K7 already take the contract's [(R,) C, J, L | W] operands.
from repro_torch.kernels.clause_eval import (  # noqa: F401
    clause_eval,
    clause_eval_batch,
    clause_eval_batch_packed,
    clause_eval_batch_pruned,
    clause_eval_batch_pruned_packed,
    clause_eval_batch_pruned_replicated,
    clause_eval_batch_pruned_replicated_packed,
    clause_eval_batch_replicated,
    clause_eval_batch_replicated_packed,
    clause_eval_replicated,
)
from repro_torch.kernels.ref import feedback_probabilities


def feedback_step(ta_state, literals, clause_out, type1_sel, type2_sel, u, *,
                  s, n_states: int, s_policy: str,
                  boost_true_positive: bool) -> torch.Tensor:
    """Same contract as ref.feedback_step, backed by K8.

    p_strengthen and p_erase come from ``s`` in float32, exactly as the
    reference's wrapper derives them; ``s`` is a host scalar port, so
    reading the two values costs no device round trip.
    """
    C, J, L = ta_state.shape
    p_strengthen, p_erase = feedback_probabilities(
        torch.as_tensor(s).cpu(), s_policy=s_policy,
        boost_true_positive=boost_true_positive)
    out = _fb.feedback_plane(
        ta_state.reshape(C * J, L), literals,
        clause_out.reshape(C * J), type1_sel.reshape(C * J),
        type2_sel.reshape(C * J), u.reshape(C * J, L),
        float(p_strengthen), float(p_erase), n_states=n_states,
    )
    return out.reshape(C, J, L)


def feedback_step_replicated(ta_state, literals, clause_out, type1_sel,
                             type2_sel, u, *, s, n_states: int, s_policy: str,
                             boost_true_positive: bool) -> torch.Tensor:
    """Same contract as ref.feedback_step_replicated, backed by K9.

    p_strengthen [R] and p_erase [R] come from ``s`` (0-dim or [R]) in
    float32, exactly as the reference's wrapper derives them, on the
    device of ``s``: the replica-first engine hands the kernel ports that
    are already on the card (:func:`~repro_torch.core.tm.replica_ports`), so
    a step costs three small elementwise launches and no host transfer.
    """
    R, C, J, L = ta_state.shape
    D = literals.shape[0]
    s = torch.as_tensor(s, dtype=torch.float32).to(ta_state.device)
    p_strengthen, p_erase = feedback_probabilities(
        s.expand(R), s_policy=s_policy,
        boost_true_positive=boost_true_positive)
    out = _fb.feedback_plane_replicated(
        ta_state.reshape(R, C * J, L), literals,
        clause_out.reshape(R, C * J), type1_sel.reshape(R, C * J),
        type2_sel.reshape(R, C * J), u.reshape(D, C * J, L),
        p_strengthen, p_erase, n_states=n_states,
    )
    return out.reshape(R, C, J, L)
