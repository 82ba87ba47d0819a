"""Host-spilled replica residency: K logical machines on R device slots.

A copy of the reference's ``repro.serve.residency`` (numpy only; the port
imports nothing of the reference). Device memory holds only ``R =
resident`` machines' state -- TA banks, ring buffers, step counters, RNG
keys -- while the remaining ``K - R`` replicas live as host-side snapshots
in an LRU store.

This module is pure bookkeeping: :class:`ResidencyMap` tracks the
replica <-> slot assignment, the LRU clock, and the spilled-snapshot
store. All device traffic (gather on evict, scatter or mask-select on
activate) goes through :mod:`repro_torch.core.online`'s device moves and
is driven by :class:`~repro_torch.serve.service.TMService`, which owns the
locking: every mutation here happens under the service's device lock
(lock order device -> router is unchanged: residency never takes the
router lock).

Correctness contract (pinned by tests/test_torch_residency.py against the
reference): a snapshot is the replica's COMPLETE per-machine consumer
state, so an evict -> activate cycle is invisible to that replica's
trajectory -- it lands bit for bit where an always-resident twin lands.
"""
from __future__ import annotations

from typing import Any

import numpy as np

# EWMA smoothing of the observed active-set size: 0.5 tracks a shifted
# working set within ~3 rounds while one idle round moves the estimate
# only halfway (the hysteresis band absorbs that).
EWMA_ALPHA = 0.5
# Grow/shrink target = ceil(ewma * headroom): room for the active set to
# jitter above its average without immediately re-cohorting.
AUTO_HEADROOM = 1.5


class ResidencyMap:
    """Replica <-> device-slot assignment + LRU + spilled snapshot store.

    ``slot_of[k]`` is replica k's device slot, or -1 when evicted (its
    state then lives in ``store[k]``). ``replica_of[r]`` inverts the
    assignment (-1 = free slot). Eviction order is least-recently-*used*:
    ``touch`` stamps a monotone clock on every slot that serves, flushes
    or drains, and :meth:`lru_victims` returns the stalest slots first.

    Snapshots are immutable once stored (activate pops, evict writes a
    fresh host tree), so initial snapshots may share one broadcast bank
    without copy-on-write hazards.
    """

    def __init__(self, n_replicas: int, n_slots: int):
        # <= (not <): the resident="auto" service may grow the plane to
        # the full fleet while keeping the residency layer's semantics
        # (uniform serve/evict surface across re-partitions).
        if not (1 <= n_slots <= n_replicas):
            raise ValueError(
                f"residency needs 1 <= resident <= replicas, got "
                f"resident={n_slots} replicas={n_replicas}"
            )
        self.n_replicas = int(n_replicas)
        self.n_slots = int(n_slots)
        self.slot_of = np.full(n_replicas, -1, dtype=np.int64)
        self.replica_of = np.full(n_slots, -1, dtype=np.int64)
        self.last_use = np.zeros(n_slots, dtype=np.int64)
        self._clock = 0
        self.store: dict[int, Any] = {}     # rid -> host snapshot tree
        self.activations = 0                # lifetime counters (bench +
        self.evictions = 0                  # observability)
        # EWMA of the per-round active-set size (replicas with buffered
        # rows AND budget per drain round) — the autotune signal.
        self.ewma_active = float("nan")

    @property
    def resident_mask(self) -> np.ndarray:
        """[K] bool — which replicas hold a device slot right now."""
        return self.slot_of >= 0

    def touch(self, slots) -> None:
        """Stamp the LRU clock on the given slots (most recently used)."""
        self._clock += 1
        self.last_use[np.asarray(slots)] = self._clock

    def lru_victims(self, n: int, pinned=()) -> np.ndarray:
        """The ``n`` least-recently-used occupied slots, never a pinned
        one (pinned = slots the caller is about to use in this cohort)."""
        pinned = set(int(s) for s in pinned)
        cand = [s for s in range(self.n_slots)
                if self.replica_of[s] >= 0 and s not in pinned]
        # stable sort on the clock: ties (e.g. never-touched) break by
        # slot id, deterministically
        cand.sort(key=lambda s: (self.last_use[s], s))
        if n > len(cand):
            raise RuntimeError(
                f"need {n} eviction victims but only {len(cand)} "
                f"unpinned occupied slots exist"
            )
        return np.asarray(cand[:n], dtype=np.int64)

    def free_slots(self) -> np.ndarray:
        return np.nonzero(self.replica_of < 0)[0].astype(np.int64)

    def assign(self, rids, slots) -> None:
        rids = np.asarray(rids, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        self.slot_of[rids] = slots
        self.replica_of[slots] = rids
        self.activations += len(rids)
        self.touch(slots)

    def release(self, slots) -> np.ndarray:
        """Unassign the given slots; returns the replica ids they held."""
        slots = np.asarray(slots, dtype=np.int64)
        rids = self.replica_of[slots].copy()
        self.slot_of[rids] = -1
        self.replica_of[slots] = -1
        self.evictions += len(slots)
        return rids

    # -- slot-count autotuning (ServiceConfig(resident="auto")) -------------

    def note_active(self, n: int) -> None:
        """Feed one drain round's active-set size into the EWMA. The
        first observation seeds the average (no warm-up bias)."""
        n = float(n)
        if np.isnan(self.ewma_active):
            self.ewma_active = n
        else:
            self.ewma_active = (EWMA_ALPHA * n
                                + (1.0 - EWMA_ALPHA) * self.ewma_active)

    def autotune_target(self, *, headroom: float = AUTO_HEADROOM,
                        granule: int = 1) -> int:
        """The slot count the plane SHOULD have, given the EWMA — or the
        current count when inside the hysteresis band.

        Grow when the estimated active set no longer fits the plane
        (``ceil(ewma) > n_slots``: rounds are being cohorted), to
        ``ceil(ewma * headroom)``. Shrink when even with headroom the
        demand uses less than half the plane (``ewma * headroom <
        n_slots / 2``), to the same target. The half-plane gap between
        the grow and shrink conditions is the hysteresis band — a fleet
        oscillating around a working-set size never thrashes
        re-partitions. Targets clamp to [1, n_replicas] and round up to
        ``granule`` (the mesh device count, so sharding stays even),
        capped at the fleet size.
        """
        if np.isnan(self.ewma_active):
            return self.n_slots
        want = self.ewma_active * headroom
        grow = int(np.ceil(self.ewma_active)) > self.n_slots
        shrink = want < self.n_slots / 2
        if not (grow or shrink):
            return self.n_slots
        target = max(1, int(np.ceil(want)))
        granule = max(1, int(granule))
        target = -(-target // granule) * granule
        return min(self.n_replicas, target)
