"""Tsetlin Machine core on torch: the datapath of ``repro.core.tm``.

Same machine, same shapes, same bits as the reference: a bank of Tsetlin
automata per (class, clause, literal), clause evaluation as an
include-masked AND over the literals and their complements, a +/- polarity
vote per class, over-provisioned classes and clauses gated by runtime
masks, and the fault controller's AND/OR masks on the TA actions.

Everything is a plain function over explicit state. Tensors live on the
device the state was made on; the entry points that make state
(:func:`init_state`, :func:`init_runtime`) take ``device`` and default to
the card. The scalar ports ``s`` and ``T`` are CPU tensors (0-dim, or
[R] for R replicas): the host reads them (vote clipping, feedback
probabilities) without waiting on the device, and the replica-first
engine copies them to the card once per pass over a set
(:func:`replica_ports`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.kernels import dispatch, packing, ref

INT32_MIN = -(2 ** 31)


def mean_of_count(count: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's float32 mean of ``n`` 0/1 values that sum to
    ``count``. XLA computes such a mean as sum * f32(1/n), not sum / n;
    the sum itself is exact below 2**24. Returns a 0-dim f32 tensor."""
    return count.to(torch.float32) * float(np.float32(1) / np.float32(n))


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """The reference's float32 ``jnp.mean(x, axis=-1)`` by XLA's product
    rule: the float32 sum over the last axis times f32(1/n). Bitwise the
    reference's where XLA sums in order (n = 3, 8); over long axes of
    non-0/1 values (n = 120) XLA's order differs and so may the last bits
    (ROADMAP queue 3 gives the measured tolerance)."""
    n = x.shape[-1]
    return (x.to(torch.float32).sum(-1)
            * float(np.float32(1) / np.float32(n)))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without CUDA, asking for the card raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on "
            "the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Configuration (the paper's design-time parameters, §3.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Design-time parameters (the FPGA's synthesis-time choices).

    ``max_classes``/``max_clauses`` over-provision resources; the active
    subset is selected at run time by the masks in :class:`TMRuntime`.
    ``backend`` names a kernel backend (:mod:`repro_torch.kernels.dispatch`).
    """

    n_features: int                  # booleanized input width (iris: 16)
    max_classes: int                 # provisioned classes (>= active classes)
    max_clauses: int                 # provisioned clauses per class (even)
    n_states: int = 99               # N states per action (TA has 2N states)
    s_policy: str = "standard"       # "standard" | "hardware"
    boost_true_positive: bool = True # deterministic strengthen on (clause=1,lit=1)
    backend: str = "auto"            # kernel backend name

    def __post_init__(self):
        if self.max_clauses % 2:
            raise ValueError("max_clauses must be even (half +, half - polarity)")
        if self.n_states < 1:
            raise ValueError("n_states must be >= 1")
        if self.s_policy not in ("standard", "hardware"):
            raise ValueError(f"unknown s_policy {self.s_policy!r}")
        if self.backend not in dispatch.available():
            raise ValueError(
                f"unknown backend {self.backend!r}; "
                f"available: {dispatch.available()}"
            )

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def state_dtype(self) -> torch.dtype:
        # 2N must fit the dtype; int8 keeps the TA bank small.
        return torch.int8 if 2 * self.n_states <= 127 else torch.int16


# ---------------------------------------------------------------------------
# Runtime ports and learnt state
# ---------------------------------------------------------------------------


class TMRuntime(NamedTuple):
    """Runtime ports, adjustable without rebuilding anything.

    * ``s``/``T``: the hyperparameter ports (CPU f32 / i32 tensors, 0-dim,
      or [R] per replica under the replica-first engine),
    * ``clause_mask`` [J] / ``class_mask`` [C]: over-provisioning gates,
    * ``ta_and_mask``/``ta_or_mask`` [C, J, L]: the fault controller,
      action' = (action AND and_mask) OR or_mask. Fault-free: and=1, or=0.
    """

    s: torch.Tensor
    T: torch.Tensor
    clause_mask: torch.Tensor
    class_mask: torch.Tensor
    ta_and_mask: torch.Tensor
    ta_or_mask: torch.Tensor


def replica_ports(rt: TMRuntime, n: int, device) -> TMRuntime:
    """``rt`` with its s/T ports as [n] float32 / int32 tensors on
    ``device`` (a 0-dim port is broadcast). The replica-first engine calls
    this once per pass over a set, so the ports cross to the card once per
    pass and never inside the step loop; ports already there stay as
    they are."""
    return rt._replace(
        s=torch.as_tensor(rt.s, dtype=torch.float32).to(device).expand(n),
        T=torch.as_tensor(rt.T, dtype=torch.int32).to(device).expand(n))


class TMState(NamedTuple):
    """Learnt state: the TA bank. States 1..N exclude, N+1..2N include."""

    ta_state: torch.Tensor  # [max_classes, max_clauses, 2f] int8/int16


def init_state(cfg: TMConfig, key: Optional[torch.Tensor] = None,
               device=None) -> TMState:
    """TA bank at the decision boundary: all N without a key, else N or
    N+1 by a fair coin per TA (``bernoulli(key, 0.5)``, as the reference)."""
    dev = resolve_device(device)
    shape = (cfg.max_classes, cfg.max_clauses, cfg.n_literals)
    n = cfg.n_states
    if key is None:
        ta = torch.full(shape, n, dtype=cfg.state_dtype, device=dev)
    else:
        coin = rnd.bernoulli(key.to(dev), 0.5, shape)
        ta = torch.where(coin, n + 1, n).to(cfg.state_dtype)
    return TMState(ta_state=ta)


def init_runtime(
    cfg: TMConfig,
    *,
    s: float = 3.9,
    T: int = 15,
    n_active_classes: Optional[int] = None,
    n_active_clauses: Optional[int] = None,
    device=None,
) -> TMRuntime:
    """Fault-free runtime with the first ``n_active_*`` resources enabled."""
    dev = resolve_device(device)
    n_cls = cfg.max_classes if n_active_classes is None else n_active_classes
    n_clz = cfg.max_clauses if n_active_clauses is None else n_active_clauses
    shape = (cfg.max_classes, cfg.max_clauses, cfg.n_literals)
    return TMRuntime(
        s=torch.tensor(s, dtype=torch.float32),
        T=torch.tensor(T, dtype=torch.int32),
        clause_mask=torch.arange(cfg.max_clauses, device=dev) < n_clz,
        class_mask=torch.arange(cfg.max_classes, device=dev) < n_cls,
        ta_and_mask=torch.ones(shape, dtype=torch.bool, device=dev),
        ta_or_mask=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# Datapath: literals -> faulted actions -> clauses -> votes (paper Fig. 1)
# ---------------------------------------------------------------------------


def is_packed(xs: torch.Tensor) -> bool:
    """True for rows of packed words. The port's words are int32 tensors
    holding uint32 bits (:mod:`repro_torch.kernels.packing`), so the
    datapath routes on that dtype where the reference routes on uint32; a
    ``torch.uint32`` tensor counts as words too. Bool features are any
    other dtype."""
    return xs.dtype in (packing.WORD_DTYPE, torch.uint32)


def make_literals(x: torch.Tensor) -> torch.Tensor:
    """Boolean features -> literal vector [x, ~x] (length 2f)."""
    x = x.to(torch.bool)
    return torch.cat([x, ~x], dim=-1)


def ta_actions(cfg: TMConfig, state: TMState, rt: TMRuntime) -> torch.Tensor:
    """Include bits with the fault controller applied (§3.1.2)."""
    include = state.ta_state > cfg.n_states
    return (include & rt.ta_and_mask) | rt.ta_or_mask


def make_literals_packed(xs_packed: torch.Tensor,
                         n_features: int) -> torch.Tensor:
    """Packed features [..., ceil(f/32)] -> packed literals
    [..., 2*ceil(f/32)]: the complement half is a word operation, so
    buffered packed rows become literal words without unpacking."""
    return packing.literals_from_packed(xs_packed, n_features)


def ta_actions_packed(cfg: TMConfig, state: TMState,
                      rt: TMRuntime) -> torch.Tensor:
    """Post-fault include masks packed to words [..., C, J, 2*ceil(f/32)]:
    the include plane packs once per batched clause-eval call, on the
    device of the bank (one pack of the [..., 2, f] view)."""
    return packing.pack_include(ta_actions(cfg, state, rt), cfg.n_features)


def clause_polarity(cfg: TMConfig, device=None) -> torch.Tensor:
    """+1 for even-indexed clauses, -1 for odd. [J] i32."""
    j = torch.arange(cfg.max_clauses, device=device)
    return torch.where(j % 2 == 0, 1, -1).to(torch.int32)


def eval_clauses(cfg: TMConfig, include: torch.Tensor,
                 literals: torch.Tensor, rt: TMRuntime, *,
                 training: bool) -> torch.Tensor:
    """Clause outputs [C, J] bool (empty clauses: ``training``)."""
    out = dispatch.resolve(cfg.backend).clause_eval(
        include, literals, training=training
    )
    return out & rt.clause_mask[None, :]


def eval_clauses_batch(cfg: TMConfig, include: torch.Tensor,
                       literals: torch.Tensor, rt: TMRuntime, *,
                       training: bool) -> torch.Tensor:
    """Batch-first clause outputs [B, C, J] bool."""
    out = dispatch.resolve(cfg.backend).clause_eval_batch(
        include, literals, training=training
    )
    return out & rt.clause_mask[None, None, :]


def eval_clauses_batch_packed(cfg: TMConfig, include_packed: torch.Tensor,
                              literals_packed: torch.Tensor, rt: TMRuntime, *,
                              training: bool) -> torch.Tensor:
    """Batch-first clause outputs [B, C, J] bool from packed words; bit for
    bit :func:`eval_clauses_batch` on the unpacked operands."""
    out = dispatch.resolve(cfg.backend).clause_eval_batch_packed(
        include_packed, literals_packed, training=training
    )
    return out & rt.clause_mask[None, None, :]


def class_sums(cfg: TMConfig, clause_out: torch.Tensor) -> torch.Tensor:
    """Per-class vote [..., C] i32 from clause outputs [..., C, J]."""
    pol = clause_polarity(cfg, clause_out.device)
    return torch.sum(clause_out.to(torch.int32) * pol, dim=-1,
                     dtype=torch.int32)


def forward(cfg: TMConfig, state: TMState, rt: TMRuntime, x: torch.Tensor,
            *, training: bool = False):
    """One datapoint. Returns (clause_out [C, J], votes [C])."""
    lits = make_literals(x)
    include = ta_actions(cfg, state, rt)
    clauses = eval_clauses(cfg, include, lits, rt, training=training)
    return clauses, class_sums(cfg, clauses)


def forward_batch(cfg: TMConfig, state: TMState, rt: TMRuntime,
                  xs: torch.Tensor, *, training: bool = False):
    """A batch. Returns (clause_out [B, C, J], votes [B, C]).

    ``xs`` is bool features [B, f] or packed words [B, ceil(f/32)] (the
    port's int32 words, :func:`is_packed`); packed rows go through the
    packed entry (K5), bit for bit the unpacked route.
    """
    if is_packed(xs):
        lits = make_literals_packed(xs, cfg.n_features)
        include = ta_actions_packed(cfg, state, rt)
        clauses = eval_clauses_batch_packed(cfg, include, lits, rt,
                                            training=training)
    else:
        lits = make_literals(xs)
        include = ta_actions(cfg, state, rt)
        clauses = eval_clauses_batch(cfg, include, lits, rt,
                                     training=training)
    return clauses, class_sums(cfg, clauses)


def _masked_argmax(votes: torch.Tensor, class_mask: torch.Tensor):
    votes = torch.where(class_mask, votes, INT32_MIN)
    return torch.argmax(votes, dim=-1).to(torch.int32)


def predict(cfg: TMConfig, state: TMState, rt: TMRuntime,
            x: torch.Tensor) -> torch.Tensor:
    """argmax class over active classes (inactive classes vote -inf)."""
    _, votes = forward(cfg, state, rt, x, training=False)
    return _masked_argmax(votes, rt.class_mask)


def predict_batch(cfg: TMConfig, state: TMState, rt: TMRuntime,
                  xs: torch.Tensor) -> torch.Tensor:
    """Batch-first inference [B] i32: one ``clause_eval_batch`` call."""
    _, votes = forward_batch(cfg, state, rt, xs, training=False)
    return _masked_argmax(votes, rt.class_mask[None, :])


# ---------------------------------------------------------------------------
# Replica-first datapath: R machines, D data streams, replica r on r % D
# ---------------------------------------------------------------------------


def forward_batch_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                             xs: torch.Tensor, *, training: bool = False):
    """R machines on their batches in one replica-first clause plane:
    state leaves [R, ...], xs [D, B, f] bool or packed words
    [D, B, ceil(f/32)] (:func:`is_packed`; replica r reads batch r % D).
    Returns (clause_out [R, B, C, J], votes [R, B, C]); replica r equals
    :func:`forward_batch` on batch r % D bit for bit. Bool rows go through
    ``clause_eval_batch_replicated`` (K4), words through
    ``clause_eval_batch_replicated_packed`` (K6)."""
    backend = dispatch.resolve(cfg.backend)
    if is_packed(xs):
        lits = make_literals_packed(xs, cfg.n_features)       # [D, B, W]
        include = ta_actions_packed(cfg, state, rt)           # [R, C, J, W]
        clauses = backend.clause_eval_batch_replicated_packed(
            include, lits, training=training)
    else:
        lits = make_literals(xs)                              # [D, B, 2f]
        include = ta_actions(cfg, state, rt)                  # [R, C, J, L]
        clauses = backend.clause_eval_batch_replicated(
            include, lits, training=training)
    clauses = clauses & rt.clause_mask
    return clauses, class_sums(cfg, clauses)


def predict_batch_replicated_(cfg: TMConfig, state: TMState, rt: TMRuntime,
                              xs: torch.Tensor) -> torch.Tensor:
    """Replica-first prediction [R, B] i32: :func:`forward_batch_replicated`
    and the active-class argmax (inactive classes vote -inf)."""
    _, votes = forward_batch_replicated(cfg, state, rt, xs, training=False)
    return _masked_argmax(votes, rt.class_mask)


def predict_batch_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                             xs: torch.Tensor) -> torch.Tensor:
    """The fleet ``infer`` entry: :func:`predict_batch_replicated_` (the
    reference jits it; the port runs eagerly)."""
    return predict_batch_replicated_(cfg, state, rt, xs)


# ---------------------------------------------------------------------------
# Budgeted (pruned / weighted) inference
# ---------------------------------------------------------------------------


def vote_weights(cfg: TMConfig, rt: TMRuntime,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Signed per-clause vote weights [.., C, J] i32: polarity x
    clause_mask x |weight|, ``weights`` an optional [.., C, J] plane of
    positive magnitudes (None = unit). With unit weights the budgeted vote
    over a full permutation is :func:`class_sums` term for term."""
    dev = rt.clause_mask.device
    base = clause_polarity(cfg, dev) * rt.clause_mask.to(torch.int32)  # [J]
    if weights is None:
        return base.expand(cfg.max_classes, cfg.max_clauses)
    return torch.as_tensor(weights).to(dev, torch.int32) * base


def _pruned_votes(clauses: torch.Tensor, swt: torch.Tensor,
                  sel: torch.Tensor) -> torch.Tensor:
    """Budgeted class sums [.., B, C] i32: the elected clauses' outputs
    [.., B, C, M] times their signed weights ``swt`` [.., C, J] gathered by
    ``sel`` [.., C, M]."""
    wsel = torch.take_along_dim(swt, sel.to(torch.int64), dim=-1)
    return torch.sum(clauses.to(torch.int32) * wsel.unsqueeze(-3), dim=-1,
                     dtype=torch.int32)


def forward_batch_pruned(cfg: TMConfig, state: TMState, rt: TMRuntime,
                         xs: torch.Tensor, sel,
                         weights: Optional[torch.Tensor] = None):
    """Budgeted batch datapath: (clause_out [B, C, M], votes [B, C] i32).

    Only the ``sel``-elected clauses ([C, M] ids) are contracted, through
    the contract's pruned entries (K7), and the class vote folds the
    signed :func:`vote_weights` of the elected clauses. With ``sel`` a
    full permutation and unit weights the int32 sums reorder
    :func:`forward_batch`'s: bitwise the same votes. Packed rows (the
    port's int32 words) take the packed entry.
    """
    kb = dispatch.resolve(cfg.backend)
    sel = ref.as_selection(sel, cfg.max_clauses, state.ta_state.device)
    if is_packed(xs):
        lits = make_literals_packed(xs, cfg.n_features)
        include = ta_actions_packed(cfg, state, rt)
        clauses = kb.clause_eval_batch_pruned_packed(include, sel, lits,
                                                     training=False)
    else:
        lits = make_literals(xs)
        include = ta_actions(cfg, state, rt)
        clauses = kb.clause_eval_batch_pruned(include, sel, lits,
                                              training=False)
    return clauses, _pruned_votes(clauses, vote_weights(cfg, rt, weights),
                                  sel)


def predict_batch_pruned_(cfg: TMConfig, state: TMState, rt: TMRuntime,
                          xs: torch.Tensor, sel,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Budgeted prediction [B] i32 (inactive classes vote int32 min)."""
    _, votes = forward_batch_pruned(cfg, state, rt, xs, sel, weights)
    return _masked_argmax(votes, rt.class_mask[None, :])


def predict_batch_pruned(cfg: TMConfig, state: TMState, rt: TMRuntime,
                         xs: torch.Tensor, sel,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The budgeted serving entry: :func:`predict_batch_pruned_` (the
    reference jits it; the port runs eagerly)."""
    return predict_batch_pruned_(cfg, state, rt, xs, sel, weights)


def forward_batch_pruned_replicated(cfg: TMConfig, state: TMState,
                                    rt: TMRuntime, xs: torch.Tensor, sel,
                                    weights: Optional[torch.Tensor] = None):
    """Replica-first budgeted datapath: state leaves [R, ...], xs [D, B, ...]
    (replica r reads batch r % D), sel [R, C, M], weights [R, C, J] or
    None. Returns (clauses [R, B, C, M], votes [R, B, C] i32): every
    replica serves from its own ranked subset in one K7 launch."""
    kb = dispatch.resolve(cfg.backend)
    sel = ref.as_selection(sel, cfg.max_clauses, state.ta_state.device)
    if is_packed(xs):
        lits = make_literals_packed(xs, cfg.n_features)
        include = ta_actions_packed(cfg, state, rt)
        clauses = kb.clause_eval_batch_pruned_replicated_packed(
            include, sel, lits, training=False)
    else:
        lits = make_literals(xs)
        include = ta_actions(cfg, state, rt)
        clauses = kb.clause_eval_batch_pruned_replicated(
            include, sel, lits, training=False)
    swt = vote_weights(cfg, rt, weights)
    if swt.ndim == 2:
        swt = swt.expand((sel.shape[0],) + tuple(swt.shape))
    return clauses, _pruned_votes(clauses, swt, sel)


def predict_batch_pruned_replicated_(cfg: TMConfig, state: TMState,
                                     rt: TMRuntime, xs: torch.Tensor, sel,
                                     weights: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Replica-first budgeted prediction [R, B] i32."""
    _, votes = forward_batch_pruned_replicated(cfg, state, rt, xs, sel,
                                               weights)
    return _masked_argmax(votes, rt.class_mask)


def predict_batch_pruned_replicated(cfg: TMConfig, state: TMState,
                                    rt: TMRuntime, xs: torch.Tensor, sel,
                                    weights: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """The fleet's budgeted serve entry:
    :func:`predict_batch_pruned_replicated_` (eager in the port)."""
    return predict_batch_pruned_replicated_(cfg, state, rt, xs, sel, weights)
