"""Reference replay of a fleet learning online while it serves.

A run of the online driver records what it offered and what the system
answered (:class:`Trajectory`). :func:`replay` recomputes, for the
sampled replicas, every answer the system gave from the benchmark's
inputs alone and counts the answers that disagree:

* ``accepted``: a labelled row is accepted while a replica holds fewer
  than ``capacity`` rows not yet consumed (its ring plus staged rows);
* ``trained``: a tick consumes ``min(chunk, held)`` rows of each replica,
  oldest first, one datapoint step each; every tick splits each
  replica's key once, (new key, chunk key), and the chunk key splits into
  ``chunk`` step keys;
* ``accuracy`` and ``rolled_back``: a replica that has consumed
  ``analyze_every`` rows since its last analysis is due; at a tick where
  some replica is due every replica's accuracy on the eval set is
  measured, and a due replica whose accuracy fell more than
  ``rollback_threshold`` below its best rolls back to its best bank, and
  one that beat its best (or has none) makes its bank the new best;
* ``bank``: the TA banks when the window has closed;
* ``serve``: each checked request's predictions, which must equal the
  reference's under one of the bank versions the request could have read
  (version v: the banks after v ticks; the driver records the range).

Replicas are independent, so a sample of them is recomputed in one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from reference import tm


@dataclasses.dataclass
class Trajectory:
    """What the driver offered and observed, for the sampled replicas."""

    machine: tm.Machine
    s: float
    T: int
    chunk: int
    capacity: int
    analyze_every: int
    rollback_threshold: float
    service_seed: int
    sample: np.ndarray            # [S] replica ids
    init_bank: np.ndarray         # [S, C, J, L] the banks handed to the system
    pool_x: np.ndarray            # [P, f] bool
    stream_idx: np.ndarray        # [S, N] pool rows of each replica's stream
    stream_y: np.ndarray          # [S, N] labels as offered
    eval_x: np.ndarray            # [E, f] bool
    eval_y: np.ndarray            # [E]
    # observed, in order: submits (stream position, accepted [S]) and
    # ticks (submits before it, trained [S], accuracy [S] or None,
    # rolled back [S])
    submits: list = dataclasses.field(default_factory=list)
    ticks: list = dataclasses.field(default_factory=list)
    # checked serve requests: (pool rows [B], first version, last
    # version, predictions [S, B])
    serves: list = dataclasses.field(default_factory=list)
    final_bank: Optional[np.ndarray] = None   # [S, C, J, L] observed


@dataclasses.dataclass
class Answers:
    """A replay's own answers, in the layout a run observes them (the
    lower-precision control is judged as if it were the system)."""

    submits: list
    ticks: list
    serves: list
    final_bank: np.ndarray


def _to(a, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


def replay(traj: Trajectory, device, uniform_dtype=torch.float32,
           judge: bool = True) -> tuple[dict, Answers]:
    """Recompute the sampled replicas' run. Returns (mismatch counts by
    name, the replay's own answers). With ``judge`` False the counts
    are left at 0 (a replay that only produces answers)."""
    m = traj.machine
    S = len(traj.sample)
    dev = torch.device(device)
    bank = _to(traj.init_bank, dev, torch.int32)
    keys = tm.fold_in(tm.key_from_seed(traj.service_seed, dev),
                      np.asarray(traj.sample))                # [S, 2]
    s_t = torch.full((S,), np.float32(traj.s), dtype=torch.float32,
                     device=dev)
    T_t = torch.full((S,), int(traj.T), dtype=torch.int32, device=dev)
    pool_x = _to(traj.pool_x, dev, torch.bool)
    stream_idx = _to(traj.stream_idx, dev, torch.int64)
    stream_y = _to(traj.stream_y, dev, torch.int64)
    eval_x = _to(traj.eval_x, dev, torch.bool)
    eval_y = _to(traj.eval_y, dev, torch.int64)
    rows = torch.arange(S, device=dev)

    # accepted stream positions of each replica, oldest first
    held = np.zeros((S, max(1, len(traj.submits))), dtype=np.int64)
    n_held = np.zeros(S, dtype=np.int64)
    head = np.zeros(S, dtype=np.int64)
    since = np.zeros(S, dtype=np.int64)
    best = np.full(S, np.nan)
    best_bank = bank.clone()
    bad = dict(accepted=0, trained=0, accuracy=0, rolled_back=0, bank=0,
               serve=0)
    out_submits, out_ticks = [], []

    serves = traj.serves
    matched = np.zeros((len(serves), S), dtype=bool)
    out_serves = [None] * len(serves)

    def check_serves(version: int) -> None:
        for q, (ridx, v_lo, v_hi, preds) in enumerate(serves):
            if not v_lo <= version <= v_hi:
                continue
            ref = tm.predict(m, bank, pool_x[_to(ridx, dev, torch.int64)])
            ref = ref.cpu().numpy()
            if version == v_lo:
                out_serves[q] = (ridx, v_lo, v_hi, ref.astype(np.int8))
            if judge:
                matched[q] |= (ref == np.asarray(preds)).all(-1)

    sub_i = 0
    version = 0
    check_serves(version)
    for n_before, trained_obs, acc_obs, rolled_obs in traj.ticks:
        while sub_i < n_before:
            pos, acc_mask = traj.submits[sub_i]
            ok = n_held - head < traj.capacity
            held[ok, n_held[ok]] = pos
            n_held += ok
            if judge:
                bad["accepted"] += int((ok != np.asarray(acc_mask)).sum())
            out_submits.append((pos, ok))
            sub_i += 1
        n = np.minimum(traj.chunk, n_held - head)
        if judge:
            bad["trained"] += int((n != np.asarray(trained_obs)).sum())
        k2 = tm.split(keys, 2)
        keys, chunk_keys = k2[:, 0], k2[:, 1]
        step_keys = tm.split(chunk_keys, traj.chunk)           # [S, k, 2]
        for i in range(int(n.max(initial=0))):
            live = i < n
            pos = np.where(live, held[np.arange(S),
                                      np.where(live, head + i, 0)], 0)
            p = _to(pos, dev)
            x = pool_x[stream_idx[rows, p]]
            y = stream_y[rows, p]
            valid = _to(live, dev)
            bank = tm.feedback_update(m, bank, x, y, step_keys[:, i], s_t,
                                      T_t, valid, uniform_dtype)
        head += n
        since += n
        due = since >= traj.analyze_every
        acc = None
        rolled = np.zeros(S, dtype=bool)
        if due.any() or acc_obs is not None:
            acc = tm.accuracy(m, bank, eval_x, eval_y)
            if judge:
                bad["accuracy"] += (int(due.sum()) if acc_obs is None else
                                    int((acc != np.asarray(acc_obs)).sum()))
            since[due] = 0
            have = ~np.isnan(best)
            rolled = due & have & (acc < best - traj.rollback_threshold)
            improve = due & (~have | (acc > best))
            best = np.where(improve, acc, best)
            if rolled.any():
                r_t = _to(rolled, dev)[:, None, None, None]
                bank = torch.where(r_t, best_bank, bank)
            if improve.any():
                i_t = _to(improve, dev)[:, None, None, None]
                best_bank = torch.where(i_t, bank, best_bank)
        if judge:
            bad["rolled_back"] += int((rolled != np.asarray(rolled_obs)).sum())
        out_ticks.append((sub_i, n, acc, rolled))
        version += 1
        check_serves(version)
    final = bank.cpu().numpy()
    if judge:
        if traj.final_bank is None:
            bad["bank"] = int(final.size)
        else:
            bad["bank"] = int((final != np.asarray(traj.final_bank)).sum())
        bad["serve"] = int((~matched).sum())
    return bad, Answers(out_submits, out_ticks, out_serves,
                        final.astype(np.int16))
