"""Runtime-tunable serving on torch: clause ranking, budgeted inference,
early exit.

The twin of ``repro.serve.tunable``. A trained machine's serve cost is
traded against accuracy at run time, without retraining:

* **Ranking.** :func:`clause_scores` / :func:`clause_scores_replicated`
  score every clause's net helpful vote over a calibration set (one batch
  clause plane, K2/K5 or K4/K6); :func:`rank_from_scores` turns scores
  into a per-class permutation of the clause axis (descending score, ties
  by clause index; polarity-balanced when given the polarity).
* **Budgeted serve.** A budget b elects the top ``m = ceil(b * J)`` ranked
  clauses per class, and the contract's pruned entries (K7) contract only
  those. :func:`weights_from_scores` derives small integer vote weights
  from the same scores.
* **Early exit.** :func:`predict_pruned_replicated_host` evaluates the
  elected clauses in ranked groups and stops once every request's margin
  provably exceeds what the remaining groups can swing. The bound is
  conservative, so predictions equal early exit off bit for bit; only the
  per-request ``evaluated`` counts change.
* **TuneController.** The per-service policy object: calibrated
  ranks/weights (host numpy, per replica), the live budget, and the
  queue-depth rule ``tick`` applies under load.

Budget 1.0 with unit weights and no early exit equals the plain serve
path bit for bit: the full ranking is a permutation and int32 sums
commute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import tm as tm_mod
from repro_torch.core.tm import TMConfig, TMRuntime, TMState


# ---------------------------------------------------------------------------
# Clause ranking (calibration)
# ---------------------------------------------------------------------------


def clause_scores(cfg: TMConfig, state: TMState, rt: TMRuntime,
                  xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Net helpful vote contribution of every clause, [C, J] i32:

        score[c, j] = sum_b fired[b, c, j] * pol[j] * (+1 if y_b == c else -1)

    over one batch clause plane of the calibration set (inference
    semantics: empty clauses and masked clauses score 0)."""
    clauses, _ = tm_mod.forward_batch(cfg, state, rt, xs, training=False)
    dev = clauses.device
    pol = tm_mod.clause_polarity(cfg, dev)
    agree = torch.where(ys.to(dev)[:, None]
                        == torch.arange(cfg.max_classes, device=dev)[None],
                        1, -1).to(torch.int32)                  # [B, C]
    return torch.sum(clauses.to(torch.int32) * pol * agree[..., None], dim=0,
                     dtype=torch.int32)


def clause_scores_replicated(cfg: TMConfig, state: TMState, rt: TMRuntime,
                             xs: torch.Tensor, ys: torch.Tensor
                             ) -> torch.Tensor:
    """Per-replica clause scores [R, C, J] i32 in one replica-first clause
    plane: xs [D, B, ...] / ys [D, B], replica r scored on stream r % D,
    exactly :func:`clause_scores` on it."""
    clauses, _ = tm_mod.forward_batch_replicated(cfg, state, rt, xs,
                                                 training=False)
    R, dev = clauses.shape[0], clauses.device
    D = ys.shape[0]
    pol = tm_mod.clause_polarity(cfg, dev)
    agree = torch.where(ys.to(dev)[..., None]
                        == torch.arange(cfg.max_classes, device=dev),
                        1, -1).to(torch.int32)                  # [D, B, C]
    agree = agree.repeat(R // D, 1, 1)                          # [R, B, C]
    return torch.sum(clauses.to(torch.int32) * pol * agree[..., None], dim=1,
                     dtype=torch.int32)


def rank_from_scores(score, polarity=None) -> np.ndarray:
    """Scores [.., C, J] -> ranking [.., C, J] int32, clause ids best first.

    Descending score, ties by ascending clause index (a stable sort of the
    negated scores). With ``polarity`` ([J], +-1) the ranking is
    polarity-balanced: the best positive and best negative clauses
    interleave, so every top-m prefix keeps near-equal numbers of for- and
    against-voters (calibrated serving always ranks balanced).
    """
    s = np.asarray(score)
    if polarity is None:
        return np.argsort(-s, axis=-1, kind="stable").astype(np.int32)
    pol = np.asarray(polarity).reshape(-1)
    pos = np.nonzero(pol > 0)[0]
    neg = np.nonzero(pol <= 0)[0]
    po = pos[np.argsort(-s[..., pos], axis=-1, kind="stable")]
    ne = neg[np.argsort(-s[..., neg], axis=-1, kind="stable")]
    out = np.empty(s.shape, dtype=np.int32)
    k = min(len(pos), len(neg))
    out[..., 0:2 * k:2] = po[..., :k]
    out[..., 1:2 * k:2] = ne[..., :k]
    if len(pos) > k:
        out[..., 2 * k:] = po[..., k:]
    elif len(neg) > k:
        out[..., 2 * k:] = ne[..., k:]
    return out


def weights_from_scores(score, weight_bits: int) -> Optional[np.ndarray]:
    """Integer vote weights in [1, 2^bits - 1], linear in the clamped
    positive score per class (all-integer arithmetic): the top clause of a
    class gets ``2^bits - 1``, non-positive scores get 1.
    ``weight_bits <= 0`` returns None (unit weights)."""
    if weight_bits <= 0:
        return None
    s = np.maximum(np.asarray(score, dtype=np.int64), 0)
    wmax = (1 << weight_bits) - 1
    peak = np.maximum(s.max(axis=-1, keepdims=True), 1)
    return (1 + (s * (wmax - 1)) // peak).astype(np.int32)


def m_for_budget(budget: float, n_clauses: int) -> int:
    """Compute budget (fraction of clauses) -> elected clauses per class."""
    if not 0.0 < budget <= 1.0:
        raise ValueError(f"budget must be in (0, 1], got {budget}")
    return max(1, min(n_clauses, math.ceil(budget * n_clauses)))


# ---------------------------------------------------------------------------
# Budgeted + early-exit prediction (host driver over K7)
# ---------------------------------------------------------------------------


_NEG = np.int64(-1) << 40   # "inactive class" vote floor (host-side int64)


def predict_pruned_replicated_host(
    cfg: TMConfig,
    state: TMState,          # leaves [R, ...]
    rt: TMRuntime,
    xs: torch.Tensor,        # [D, B, ...]: replica r reads batch r % D
    order: np.ndarray,       # [R, C, J] int32 per-replica rankings
    weights: Optional[np.ndarray],  # [R, C, J] int32 magnitudes (None = unit)
    m: int,                  # elected ranked clauses per class
    *,
    group: Optional[int] = None,    # early-exit group size (None = off)
) -> tuple[np.ndarray, np.ndarray]:
    """Budgeted fleet prediction with optional early-exit voting.

    Returns ``(preds [R, B] int32, evaluated [R, B] int32)``;
    ``evaluated`` counts the ranked clause slots (per class) each request
    needed, ``m`` when early exit is off. Early exit runs the elected
    clauses in ranked groups of ``group`` (one K7 launch each, one H2D
    copy of the group's ids and one D2H copy of its votes) and decides a
    request once

        v[t] - down[t] > max_{c != t} (v[c] + up[c])

    for its leader t, with ``up``/``down`` the remaining elected clauses'
    positive/negative signed weight sums: the final argmax is then ``t``
    whatever they do. The loop stops once every request is decided.
    """
    order = np.asarray(order)
    R, C, J = order.shape
    dev = state.ta_state.device
    w_dev = None if weights is None else torch.from_numpy(
        np.asarray(weights, dtype=np.int32)).to(dev)
    if group is None or group >= m:
        preds = tm_mod.predict_batch_pruned_replicated(
            cfg, state, rt, xs, torch.from_numpy(
                np.ascontiguousarray(order[:, :, :m])), w_dev)
        preds = preds.cpu().numpy()
        return preds, np.full(preds.shape, m, dtype=np.int32)

    # Signed weights of the elected clauses, in ranked order: [R, C, m].
    pol = np.where(np.arange(J) % 2 == 0, 1, -1).astype(np.int64)
    cmask = rt.clause_mask.cpu().numpy().astype(np.int64)
    mag = (np.ones((R, C, J), dtype=np.int64) if weights is None
           else np.asarray(weights, dtype=np.int64))
    signed = np.take_along_axis(mag * pol * cmask, order, axis=-1)[:, :, :m]
    up_tail = np.maximum(signed, 0)[:, :, ::-1].cumsum(axis=-1)[:, :, ::-1]
    dn_tail = np.maximum(-signed, 0)[:, :, ::-1].cumsum(axis=-1)[:, :, ::-1]

    class_mask = rt.class_mask.cpu().numpy()
    B = xs.shape[1]
    votes = np.zeros((R, B, C), dtype=np.int64)
    decided = np.zeros((R, B), dtype=bool)
    preds = np.zeros((R, B), dtype=np.int32)
    evaluated = np.zeros((R, B), dtype=np.int32)
    ridx = np.arange(R)[:, None]

    edges = list(range(0, m, group)) + [m]
    for gi in range(len(edges) - 1):
        lo, hi = edges[gi], edges[gi + 1]
        sel_g = torch.from_numpy(np.ascontiguousarray(order[:, :, lo:hi]))
        _, v = tm_mod.forward_batch_pruned_replicated(cfg, state, rt, xs,
                                                      sel_g, w_dev)
        votes += v.cpu().numpy().astype(np.int64)
        evaluated[~decided] += hi - lo
        masked = np.where(class_mask[None, None, :], votes, _NEG)
        top = masked.argmax(axis=-1)                       # [R, B]
        if hi == m:
            preds[~decided] = top[~decided]
            decided[:] = True
            break
        # Remaining-swing bound after this group ([R, C] per replica).
        rem_up = up_tail[:, :, hi]
        rem_dn = dn_tail[:, :, hi]
        floor = (np.take_along_axis(masked, top[..., None], -1)[..., 0]
                 - rem_dn[ridx, top])                      # [R, B]
        rival = masked + rem_up[:, None, :]
        np.put_along_axis(rival, top[..., None], _NEG, axis=-1)
        newly = (floor > rival.max(axis=-1)) & ~decided
        preds[newly] = top[newly]
        decided |= newly
        if decided.all():
            break
    return preds, evaluated


# ---------------------------------------------------------------------------
# The service-facing controller
# ---------------------------------------------------------------------------


class ServeAux(NamedTuple):
    """What a budgeted serve actually computed (per call)."""

    budget: float        # effective compute budget (fraction of clauses)
    m: int               # elected ranked clauses per class
    sel: np.ndarray      # [K, C, m] int32: the clause ids eligible to run
    evaluated: np.ndarray  # [K, B] int32: ranked slots evaluated per request


@dataclasses.dataclass(frozen=True)
class TunableConfig:
    """The ``ServiceConfig(tunable=...)`` knob set.

    ``budget`` is the default (and maximum) serve budget as a fraction of
    the provisioned clauses; ``weight_bits`` > 0 folds calibrated integer
    vote weights in; ``early_exit``/``group`` chunk the ranked vote and
    stop once the margin is provably decided. With ``adapt`` on,
    ``TMService.tick`` moves the live budget between ``min_budget`` and
    ``budget`` by factors of ``step``: down when any replica's queue
    depth reaches ``high_water``, back up when the deepest queue falls to
    ``low_water``.
    """

    budget: float = 1.0
    weight_bits: int = 0
    early_exit: bool = False
    group: int = 16
    adapt: bool = False
    min_budget: float = 0.125
    high_water: int = 32
    low_water: int = 4
    step: float = 2.0

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError("budget must be in (0, 1]")
        if not 0.0 < self.min_budget <= self.budget:
            raise ValueError("min_budget must be in (0, budget]")
        if self.early_exit and self.group < 1:
            raise ValueError("early-exit group must be >= 1")
        if self.step <= 1.0:
            raise ValueError("step must be > 1")


class TuneController:
    """Calibrated ranks/weights and the live budget of one service.

    Host-side per-replica state ([K, C, J] numpy), written into the
    service checkpoint, so a restored service serves at the same budget
    from the same ranking without calibrating again.
    """

    def __init__(self, tc: TunableConfig, n_replicas: int, n_clauses: int):
        self.tc = tc
        self.n_replicas = n_replicas
        self.n_clauses = n_clauses
        self.budget = float(tc.budget)
        self.order: Optional[np.ndarray] = None    # [K, C, J] int32
        self.weights: Optional[np.ndarray] = None  # [K, C, J] int32
        self.score: Optional[np.ndarray] = None    # [K, C, J] int32

    @property
    def calibrated(self) -> bool:
        return self.order is not None

    @property
    def active(self) -> bool:
        """Does default serving need the budgeted path at all?"""
        return (self.budget < 1.0 or self.tc.weight_bits > 0
                or self.tc.early_exit)

    def set_ranking(self, order: np.ndarray, weights: Optional[np.ndarray],
                    score: Optional[np.ndarray] = None) -> None:
        """Install a ranking: every row must be a permutation of the clause
        axis, which also keeps every id the kernels read inside the bank."""
        order = np.asarray(order, dtype=np.int32)
        K, J = self.n_replicas, self.n_clauses
        if order.ndim != 3 or order.shape[0] != K or order.shape[2] != J:
            raise ValueError(
                f"ranking must be [replicas={K}, C, clauses={J}], "
                f"got {order.shape}")
        if not np.array_equal(
                np.sort(order, axis=-1),
                np.broadcast_to(np.arange(J, dtype=np.int32), order.shape)):
            raise ValueError("ranking rows must be permutations of the "
                             "clause axis")
        self.order = order
        self.weights = (None if weights is None
                        else np.asarray(weights, dtype=np.int32))
        self.score = None if score is None else np.asarray(score)

    def m_for(self, budget: Optional[float] = None) -> int:
        b = self.budget if budget is None else float(budget)
        return m_for_budget(b, self.n_clauses)

    def update(self, queue_depth) -> float:
        """One ``tick``'s budget adaptation from the [K] queue depths
        (staged + buffered): the deepest lane governs. Returns the live
        budget."""
        tc = self.tc
        if not tc.adapt:
            return self.budget
        depth = int(np.max(queue_depth)) if np.size(queue_depth) else 0
        if depth >= tc.high_water:
            self.budget = max(tc.min_budget, self.budget / tc.step)
        elif depth <= tc.low_water:
            self.budget = min(tc.budget, self.budget * tc.step)
        return self.budget
