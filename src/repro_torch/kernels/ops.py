"""Contract wrappers over the hand-written CUDA kernels (the ``"cuda"``
backend).

Same contracts as :mod:`repro_torch.kernels.ref`, so the TM core switches
backends through ``TMConfig.backend`` alone. The entries reshape the
[C, J, ...] contract operands to the kernels' flattened [CJ, ...] planes.
CPU tensors go to each kernel's plain version; CUDA tensors launch it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import feedback as _fb
# K1 and K2 already take the contract's [C, J, L] operands.
from repro_torch.kernels.clause_eval import (  # noqa: F401
    clause_eval,
    clause_eval_batch,
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
