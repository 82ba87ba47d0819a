"""Traffic-realistic serving harness on torch: concurrent producers, SLO
metrics.

The twin of ``repro.serve.traffic``, driving the port's ``TMService``.

The paper's deliverable is a managed online-learning *system* (Fig. 3:
offer -> cyclic buffer -> interleaved train/infer loop), and the ROADMAP
asks for it to be measured like one: not component microbenchmarks but
sustained offers/s and serve-latency percentiles under concurrent
producers replaying the paper's use cases as *load*. This module is that
harness, in three deterministic pieces (DESIGN.md §14):

* :class:`Scenario` + :func:`make_scripts` — a seeded traffic generator
  that compiles a scenario schedule (bursty arrivals, label delay, §5.2
  class introduction, label drift, §5.3 stuck-at faults) into per-producer
  :class:`ProducerScript` event streams. Scripts are pure functions of
  ``(scenario, dataset, producer, seed)`` — every run offers the same
  rows in the same per-producer order.
* :func:`run_threaded` — N producer threads (one per replica, so each
  replica's FIFO stream has a single well-defined order) submit labelled
  traffic and issue serve probes against a live :class:`TMService` while
  the consumer loop ticks; records per-offer submit/serve latencies, the
  per-tick consumption log, and which offers were accepted.
* :func:`replay_single_caller` — replays a recorded run through a FRESH
  service from ONE thread: same accepted rows per replica in the same
  order, same per-tick consumption, same fault-injection tick. The
  replayed TA banks / RNG keys / step counters must match the threaded
  run bit for bit (:func:`fingerprint`) — the whole-system equivalent of
  the kernel parity oracles, and the test that threading changed *when*
  work happened but never *what* was computed.

Scripts are numpy and bitwise the reference's for the same seed; a
recorded run replays through either package's service to the same
:func:`fingerprint` (RNG keys as uint32 through ``rng_keys``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core import faults as faults_mod


# ---------------------------------------------------------------------------
# Scenario schedules — the paper's use cases expressed as load.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One deterministic traffic schedule (the §14 schedule format).

    Each producer offers ``points`` labelled datapoints drawn (seeded)
    from a dataset; the knobs below reshape that stream:

    * ``burst``/``burst_gap_s`` — arrivals come in back-to-back bursts of
      ``burst`` offers separated by idle gaps (0 = steady arrivals).
    * ``label_delay`` — use case "delayed ground truth": a point's serve
      probe fires when the point *arrives*, but its labelled submission
      trails ``label_delay`` offer slots behind (the stream's tail labels
      arrive after the last probe).
    * ``introduce_class``/``introduce_at`` — §5.2 class introduction: the
      named class is absent from the first ``introduce_at`` fraction of
      every producer's stream, then appears.
    * ``drift_at``/``drift_shift`` — label drift: from that fraction of
      the stream on, labels are relabelled ``(y + shift) % n_classes``
      (the adversarial relabeling of examples/serve_fleet.py, §5.3.2's
      trigger).
    * ``fault_at``/``fault_fraction``/``fault_stuck`` — §5.3 stuck-at
      faults: once the consumer has drained ``fault_at`` datapoints
      (fleet-wide), it injects an even-spread stuck-at mask set into the
      runtime (``core.faults.stuck_at_runtime`` — deterministic, so the
      replay can reproduce it exactly at the recorded tick).
    * ``probe_every`` — issue a serve probe every n-th offer (0 = never);
      probes ride the producer threads, so serve latency is measured
      under real lock contention with the consumer's tick loop.
    """

    name: str
    points: int = 256
    burst: int = 0
    burst_gap_s: float = 0.0
    label_delay: int = 0
    introduce_class: Optional[int] = None
    introduce_at: float = 0.5
    drift_at: Optional[float] = None
    drift_shift: int = 1
    fault_at: Optional[int] = None
    fault_fraction: float = 0.1
    fault_stuck: int = 1
    probe_every: int = 1


#: The three standard schedules of the reference's traffic benchmark: a
#: clean steady-state baseline, the paper's "world changed" composite (bursty
#: arrivals + late labels + a class appearing mid-stream + label drift),
#: and hardware degradation mid-run (§5.3 stuck-at-1 faults).
SCENARIOS = {
    "steady": Scenario(name="steady"),
    "bursty_drift": Scenario(
        name="bursty_drift", burst=32, burst_gap_s=0.002, label_delay=8,
        introduce_class=2, introduce_at=0.25, drift_at=0.75,
    ),
    "fault_injected": Scenario(
        name="fault_injected", fault_at=192, fault_fraction=0.1,
        fault_stuck=1,
    ),
}


@dataclasses.dataclass
class ProducerScript:
    """One producer's compiled event stream (offer order = array order)."""

    x: np.ndarray         # [n, f] bool — feature rows
    y: np.ndarray         # [n] i32 — labels as submitted (drift applied)
    gap_s: np.ndarray     # [n] f32 — arrival gap before each offer slot
    label_delay: int      # submissions trail probes by this many slots
    probe_every: int      # serve probe cadence (0 = never)

    def __len__(self) -> int:
        return len(self.y)


def make_script(sc: Scenario, xs, ys, n_classes: int, producer: int,
                seed: int = 0) -> ProducerScript:
    """Compile ``sc`` into one producer's deterministic event stream.

    Rows are drawn with replacement from ``(xs, ys)`` by an RNG keyed
    ``SeedSequence([seed, producer])`` — the stream is a pure function of
    its arguments (process-independent, like data/mnist.py).
    """
    xs = np.asarray(xs, dtype=bool)
    ys = np.asarray(ys, dtype=np.int32)
    rng = np.random.default_rng(np.random.SeedSequence([seed, producer]))
    n = sc.points
    intro_end = (int(n * sc.introduce_at)
                 if sc.introduce_class is not None else 0)
    pick = np.empty(n, dtype=np.int64)

    def _fill(lo: int, hi: int, exclude: Optional[int]) -> None:
        # Rejection-sample the slot range [lo, hi): draws of the withheld
        # class are discarded wholesale so surviving picks keep their
        # draw order (filtering then compacting per-slot would let
        # late-drawn withheld rows slide into early slots).
        have = lo
        while have < hi:
            draw = rng.integers(0, len(xs), size=hi - lo)
            if exclude is not None:
                draw = draw[ys[draw] != exclude]
            take = min(len(draw), hi - have)
            pick[have:have + take] = draw[:take]
            have += take

    _fill(0, intro_end, sc.introduce_class)
    _fill(intro_end, n, None)
    y = ys[pick].copy()
    if sc.drift_at is not None:
        drifted = np.arange(n) >= int(n * sc.drift_at)
        y[drifted] = (y[drifted] + sc.drift_shift) % n_classes
    gaps = np.zeros(n, dtype=np.float32)
    if sc.burst > 0 and sc.burst_gap_s > 0:
        slots = np.arange(n)
        gaps[(slots > 0) & (slots % sc.burst == 0)] = sc.burst_gap_s
    return ProducerScript(
        x=xs[pick], y=y, gap_s=gaps,
        label_delay=sc.label_delay, probe_every=sc.probe_every,
    )


def make_scripts(sc: Scenario, xs, ys, n_classes: int, n_producers: int,
                 seed: int = 0) -> list[ProducerScript]:
    return [make_script(sc, xs, ys, n_classes, p, seed)
            for p in range(n_producers)]


# ---------------------------------------------------------------------------
# The threaded run.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrafficResult:
    """Everything a threaded run observed — and everything a bitwise
    single-caller replay needs (accepted offers per producer in order,
    the per-tick consumption log, the fault-injection tick)."""

    scenario: str
    n_producers: int
    offers: int                      # labelled submissions attempted
    probes: int                      # serve probes issued
    accepted: np.ndarray             # [K] i64 — offers accepted per replica
    dropped: np.ndarray              # [K] i64 — backpressure drops
    trained: np.ndarray              # [K] i64 — datapoints consumed
    wall_s: float                    # barrier-to-drained wall time
    tick_trained: np.ndarray         # [T, K] i64 — per-tick consumption log
    fault_tick: Optional[int]        # tick index of §5.3 injection (or None)
    analyses: int                    # cadence analyses that fired
    rollbacks: np.ndarray            # [K] i64 — §5.3.2 rollbacks fired
    submit_lat_s: np.ndarray         # [offers] f64 — per-submit wall times
    serve_lat_s: np.ndarray          # [probes] f64 — per-probe wall times
    accepted_mask: list              # per producer: [n] bool, offer order
    tick_budget: Optional[np.ndarray] = None  # [T] f64 — tuner budget after
    # each tick (None unless the service carries a §16 TuneController)

    @property
    def ticks(self) -> int:
        return len(self.tick_trained)

    @property
    def offers_per_s(self) -> float:
        return self.offers / self.wall_s if self.wall_s > 0 else float("inf")

    def conserved(self) -> bool:
        """offers == accepted + dropped and accepted == trained, per
        replica (the run drains its buffers before returning)."""
        per_replica_offers = np.asarray(
            [int(m.size) for m in self.accepted_mask], dtype=np.int64
        )
        return (
            bool(np.array_equal(self.accepted + self.dropped,
                                per_replica_offers))
            and bool(np.array_equal(self.accepted, self.trained))
        )


def _percentile(samples: np.ndarray, q: float) -> float:
    return float(np.percentile(samples, q)) if samples.size else 0.0


def run_threaded(
    svc,
    scripts: list[ProducerScript],
    *,
    scenario: Scenario,
    pace: float = 1.0,
    seed: int = 0,
) -> TrafficResult:
    """Drive ``svc`` with one producer thread per replica plus the consumer
    tick loop on the calling thread; returns the full observation record.

    ``len(scripts)`` must equal ``svc.n_replicas`` — producer ``p`` owns
    replica ``p``'s stream, which is what makes per-replica FIFO order
    (and therefore the bitwise replay) well defined. ``pace`` scales the
    scripts' arrival gaps (0 = closed-loop, as fast as the host allows).
    """
    K = svc.n_replicas
    if len(scripts) != K:
        raise ValueError(
            f"{len(scripts)} producer scripts for {K} replicas — the "
            "harness runs one producer per replica (per-replica FIFO "
            "order, and the replay contract, depend on it)"
        )
    barrier = threading.Barrier(K + 1)
    submit_lat = [[] for _ in range(K)]
    serve_lat = [[] for _ in range(K)]
    accepted_mask = [np.zeros(len(s), dtype=bool) for s in scripts]
    errors: list[BaseException] = []

    def producer(p: int) -> None:
        s = scripts[p]
        n = len(s)
        try:
            barrier.wait()
            for slot in range(n + s.label_delay):
                if slot < n:
                    if pace and s.gap_s[slot]:
                        time.sleep(float(s.gap_s[slot]) * pace)
                    if s.probe_every and slot % s.probe_every == 0:
                        t0 = time.perf_counter()
                        svc.serve(s.x[slot][None])
                        serve_lat[p].append(time.perf_counter() - t0)
                j = slot - s.label_delay
                if j >= 0:
                    t0 = time.perf_counter()
                    ok = svc.submit(p, s.x[j], int(s.y[j]))
                    submit_lat[p].append(time.perf_counter() - t0)
                    accepted_mask[p][j] = ok
        except BaseException as e:  # surfaced to the caller after join
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,), daemon=True)
               for p in range(K)]
    for t in threads:
        t.start()

    tick_trained: list[np.ndarray] = []
    tick_budget: list[float] = []
    fault_tick: Optional[int] = None
    analyses = 0
    consumed = 0
    barrier.wait()
    t_begin = time.perf_counter()
    while True:
        alive = any(t.is_alive() for t in threads)
        if (scenario.fault_at is not None and fault_tick is None
                and consumed >= scenario.fault_at):
            # §5.3 injection — consumer-owned runtime swap, recorded by
            # tick index so the replay lands it at the same point.
            svc.rt = faults_mod.stuck_at_runtime(
                svc.cfg, svc.rt, scenario.fault_fraction, scenario.fault_stuck
            )
            fault_tick = len(tick_trained)
        rep = svc.tick()
        tick_trained.append(np.asarray(rep.trained, dtype=np.int64))
        if getattr(svc, "tuner", None) is not None:
            tick_budget.append(float(svc.tuner.budget))
        consumed += int(tick_trained[-1].sum())
        if rep.accuracy is not None:
            analyses += 1
        if not alive and not svc.buffered.any():
            break
    wall = time.perf_counter() - t_begin
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    return TrafficResult(
        scenario=scenario.name,
        n_producers=K,
        offers=sum(len(s) for s in scripts),
        probes=sum(len(ls) for ls in serve_lat),
        accepted=np.asarray([int(m.sum()) for m in accepted_mask],
                            dtype=np.int64),
        dropped=svc.dropped,
        trained=svc.steps.astype(np.int64),
        wall_s=wall,
        tick_trained=(np.stack(tick_trained) if tick_trained
                      else np.zeros((0, K), dtype=np.int64)),
        fault_tick=fault_tick,
        analyses=analyses,
        rollbacks=svc.rollbacks.copy(),
        submit_lat_s=np.asarray(sorted(v for ls in submit_lat for v in ls)),
        serve_lat_s=np.asarray(sorted(v for ls in serve_lat for v in ls)),
        tick_budget=(np.asarray(tick_budget, dtype=np.float64)
                     if tick_budget else None),
        accepted_mask=accepted_mask,
    )


def slo_summary(result: TrafficResult) -> dict:
    """The SLO numbers of one scenario run: offers/s, latency percentiles
    and the conservation check."""
    return {
        "scenario": result.scenario,
        "n_producers": result.n_producers,
        "offers": result.offers,
        "probes": result.probes,
        "accepted": int(result.accepted.sum()),
        "dropped": int(result.dropped.sum()),
        "trained": int(result.trained.sum()),
        "ticks": result.ticks,
        "analyses": result.analyses,
        "rollbacks": int(result.rollbacks.sum()),
        "fault_tick": result.fault_tick,
        "wall_s": result.wall_s,
        "offers_per_s": result.offers_per_s,
        "submit_p50_s": _percentile(result.submit_lat_s, 50),
        "submit_p99_s": _percentile(result.submit_lat_s, 99),
        "serve_p50_s": _percentile(result.serve_lat_s, 50),
        "serve_p99_s": _percentile(result.serve_lat_s, 99),
        "conserved": result.conserved(),
    }


# ---------------------------------------------------------------------------
# The single-caller replay (bitwise consistency oracle).
# ---------------------------------------------------------------------------


def replay_single_caller(svc, scripts: list[ProducerScript],
                         result: TrafficResult,
                         *, scenario: Scenario) -> None:
    """Replay a recorded threaded run through ``svc`` from ONE thread.

    ``svc`` must be a FRESH service constructed exactly like the threaded
    run's (same config/state/seed/eval set). Per tick of the record: the
    rows that tick consumed are submitted (each replica's accepted rows,
    in producer order — the per-replica FIFO), the §5.3 fault lands at
    its recorded tick, and ``tick`` runs with the recorded per-replica
    consumption as its budget (``max(n, 1)`` so idle replicas still
    advance their per-tick RNG split, exactly as a chunk-budget tick
    does). After the loop ``fingerprint(svc)`` must equal the threaded
    run's — same TA banks, RNG keys, steps, policy state, bit for bit.
    """
    K = svc.n_replicas
    rows = [(s.x[m], s.y[m]) for s, m in zip(scripts, result.accepted_mask)]
    cursor = np.zeros(K, dtype=np.int64)
    for t, trained_t in enumerate(result.tick_trained):
        if result.fault_tick is not None and t == result.fault_tick:
            svc.rt = faults_mod.stuck_at_runtime(
                svc.cfg, svc.rt, scenario.fault_fraction, scenario.fault_stuck
            )
        for r in range(K):
            lo, hi = int(cursor[r]), int(cursor[r]) + int(trained_t[r])
            for j in range(lo, hi):
                if not svc.submit(r, rows[r][0][j], int(rows[r][1][j])):
                    raise AssertionError(
                        f"replay row rejected (replica {r}, row {j}) — "
                        "the recorded run accepted it"
                    )
            cursor[r] = hi
        svc.tick(np.maximum(trained_t, 1))


def fingerprint(svc) -> dict:
    """The consumer-side trajectory state compared bitwise between a
    threaded run and its replay."""
    ss = svc.ss
    return {
        "ta_state": ss.tm.ta_state.cpu().numpy(),
        "steps": svc.steps.copy(),
        "keys": svc.rng_keys,
        "since_analysis": svc.since_analysis.copy(),
        "rollbacks": svc.rollbacks.copy(),
        "best": svc._ps.best.copy(),
    }


def fingerprints_equal(a: dict, b: dict) -> bool:
    return all(
        np.array_equal(a[k], b[k], equal_nan=True)
        if a[k].dtype.kind == "f" else np.array_equal(a[k], b[k])
        for k in a
    )
