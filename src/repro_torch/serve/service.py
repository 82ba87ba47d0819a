"""TMService on torch: the serving surface of the paper's system, K >= 1.

The twin of ``repro.serve.service.TMService``: K concurrent Fig-3
machines (offer -> cyclic buffer -> interleaved train/infer, with the
§5.3.2 mitigation policy) behind one control surface:

* ``submit`` / ``submit_rows`` -- labelled traffic, staged on the host by
  a :class:`~repro_torch.serve.router.BatchRouter` and flushed in
  ``[K, B_ingress]`` blocks.
* ``serve`` -- fleet inference, one replica-first clause plane (K4, or K6
  on packed rows; K = 1 with scalar ports: K2 or K5).
* ``tick`` -- one consumer cycle: flush ingress, drain every replica's
  budget through online training, advance the analysis cadence and apply
  :class:`AdaptPolicy` per replica.
* ``offline_train`` / ``analyze`` / ``observe_rows`` -- the offline phase,
  the accuracy block and the legacy managers' per-point FSM step.

Device layout is the replicated kernel contract: state, rings, step
counters and RNG keys all lead with K, and per-replica ``s``/``T`` ride
the runtime's ports as [K] vectors. Each drain chunk advances the whole
fleet through ``online._consume_many_replicated`` (K3 + K9 a step); K = 1
with scalar ports keeps the single-machine body ``online._consume_many``
(K1 + K8), as the reference does. ``packed=True`` switches ingress, the
rings, the eval set, serving and monitoring to packed words
(:mod:`repro_torch.kernels.packing`): ceil(f/32) words a row, bit for bit
the unpacked results.

The seed and key schedule are the reference's: keys
``fold_in(PRNGKey(seed), r)`` (or ``PRNGKey(seed[r])`` for a sequence of
seeds), one split per drained chunk for every active replica, and
``PRNGKey(seed=1)`` for ``offline_train``. So a run here is bitwise the
reference's. Residency, meshes, tunable serving and ``save``/``restore``
are later slices of the port and raise ``NotImplementedError``.

Threading: ``submit``/``submit_rows`` are safe from any number of
producer threads (they touch only the router's staging state and the
outstanding-rows mirror, both under ``router.lock``). Everything else is
serialized by one re-entrant device lock. Lock order: device -> router.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core import online as online_mod
from repro_torch.core import tm as tm_mod
from repro_torch.core.online import ChunkAux, SessionState
from repro_torch.core.tm import TMConfig, TMRuntime, TMState, init_runtime
from repro_torch.data import buffer as buf_mod
from repro_torch.kernels import packing
from repro_torch.serve import router as router_mod


def _advance_keys(keys: torch.Tensor, active: np.ndarray
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split every active replica's key; the others keep theirs. Returns
    (new persistent keys [K, 2], chunk keys [K, 2]). A replica's key
    splits once per chunk it takes part in, as a lone session's does."""
    k2 = rnd.split(keys)                                     # [K, 2, 2]
    if active.all():
        return k2[:, 0], k2[:, 1]
    act = torch.from_numpy(active).to(keys.device)
    return torch.where(act[:, None], k2[:, 0], keys), k2[:, 1]


def _select_replicas(mask: np.ndarray, new: TMState, old: TMState) -> TMState:
    """Per-replica select: replica r takes ``new`` where mask[r]."""
    m = torch.from_numpy(np.asarray(mask, dtype=bool)).to(
        new.ta_state.device)
    return TMState(online_mod.replica_gate(m)(new.ta_state, old.ta_state))


def _squeeze(ss: SessionState) -> SessionState:
    """The K = 1 plane as one machine's state (views)."""
    return SessionState(tm=TMState(ss.tm.ta_state[0]),
                        buf=buf_mod.RingBuffer(*(a[0] for a in ss.buf)),
                        step=ss.step[0])


def _unsqueeze(ss: SessionState) -> SessionState:
    """One machine's state as a K = 1 plane (views)."""
    return SessionState(tm=TMState(ss.tm.ta_state[None]),
                        buf=buf_mod.RingBuffer(*(a[None] for a in ss.buf)),
                        step=ss.step[None])


# ---------------------------------------------------------------------------
# The Fig-3 FSM (§5.3.2 mitigation policy) on [K] arrays.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PolicyState:
    """Host-side FSM state of :class:`AdaptPolicy`, all per replica."""

    since: np.ndarray          # [K] i64: points consumed since last analysis
    best: np.ndarray           # [K] f64: best known accuracy (nan = none yet)
    rollbacks: np.ndarray      # [K] i64: §5.3.2 rollbacks fired
    lost: np.ndarray           # [K] i64: datapoints lost even after retry
    best_state: Optional[TMState] = None   # known-good [K, ...] banks


@dataclasses.dataclass
class AdaptPolicy:
    """The §5.3.2 mitigation policy: periodic analysis + rollback, per
    replica.

    A member that consumed ``analyze_every`` points since its last
    analysis is *due*: its eval accuracy is measured again, and it rolls
    back to its own known-good TA bank on a drop past
    ``rollback_threshold``, or snapshots a new best. Members that are not
    due are never touched.
    """

    analyze_every: int = 32
    rollback_threshold: float = 0.1

    def init(self, n_replicas: int) -> _PolicyState:
        K = n_replicas
        return _PolicyState(
            since=np.zeros(K, dtype=np.int64),
            best=np.full(K, np.nan),
            rollbacks=np.zeros(K, dtype=np.int64),
            lost=np.zeros(K, dtype=np.int64),
        )

    def due(self, ps: _PolicyState) -> np.ndarray:
        return ps.since >= self.analyze_every

    def apply(self, ps: _PolicyState, due: np.ndarray, acc: np.ndarray,
              tm: TMState) -> tuple[TMState, np.ndarray]:
        """One policy transition for the due members. Returns
        (new TA banks, rolled-back mask [K])."""
        ps.since[due] = 0
        have_best = ~np.isnan(ps.best)
        collapse = due & have_best & (acc < ps.best - self.rollback_threshold)
        improve = due & (~have_best | (acc > ps.best))
        if collapse.any():
            tm = _select_replicas(collapse, ps.best_state, tm)
            ps.rollbacks += collapse
        if improve.any():
            ps.best = np.where(improve, acc, ps.best)
            # The first improve snapshots unconditionally: there is no
            # known-good bank before the first analysis or offline_train,
            # and the replicas not improving keep best = nan, so their rows
            # of the snapshot are unreachable until their own first improve.
            ps.best_state = (tm if ps.best_state is None
                             else _select_replicas(improve, tm,
                                                   ps.best_state))
        return tm, collapse

    def snapshot(self, ps: _PolicyState, acc: np.ndarray, tm: TMState):
        """Unconditional known-good snapshot (the offline-train baseline)."""
        ps.best = np.asarray(acc, dtype=np.float64).copy()
        ps.best_state = tm


class TickReport(NamedTuple):
    """What one :meth:`TMService.tick` did, per replica."""

    trained: np.ndarray                 # [K] i64: points consumed
    accuracy: Optional[np.ndarray]      # [K] f32: eval accs, None if not due
    rolled_back: np.ndarray             # [K] bool: §5.3.2 rollbacks fired


@dataclasses.dataclass
class ServiceConfig:
    """Construction-time knobs of a :class:`TMService`.

    ``s``/``T`` set the runtime's hyperparameter ports: scalars give a
    homogeneous fleet, length-K sequences give every member its own.
    ``ingress_block`` is the router's staged rows per replica per flush.
    ``packed`` switches the boolean datapath to packed words (ingress,
    rings, eval set, serving, monitoring), bit for bit the unpacked one.
    ``history_limit`` keeps only the most recent N analysis entries (None
    keeps all). ``resident``, ``mesh`` and ``tunable`` keep the
    reference's names; values other than their defaults belong to later
    slices of the port and raise.
    """

    replicas: int = 1
    buffer_capacity: int = 64
    chunk: int = 16                   # datapoints drained per chunk
    ingress_block: int = 32           # staged rows per replica per flush
    packed: bool = False
    history_limit: Optional[int] = None
    resident: Union[int, None, str] = None
    s: Union[float, Sequence[float], None] = None
    T: Union[int, Sequence[int], None] = None
    policy: AdaptPolicy = dataclasses.field(default_factory=AdaptPolicy)
    seed: Union[int, Sequence[int]] = 0
    mesh: object = None
    tunable: object = None

    def runtime(self, cfg: TMConfig, device=None) -> TMRuntime:
        """A fault-free runtime with this config's s/T ports (0-dim, or
        [K] CPU tensors for length-K sequences)."""
        rt = init_runtime(cfg, device=device)
        for name, port, dtype in (("s", self.s, torch.float32),
                                  ("T", self.T, torch.int32)):
            if port is None:
                continue
            if np.ndim(port) != 0 and len(port) != self.replicas:
                raise ValueError(
                    f"per-replica {name} carries {len(port)} entries, "
                    f"expected {self.replicas}")
            rt = rt._replace(**{name: torch.tensor(np.asarray(port),
                                                   dtype=dtype)})
        return rt


def _not_yet(sc: ServiceConfig) -> Optional[str]:
    """The first knob of ``sc`` that a later slice of the port serves."""
    if sc.resident is not None:
        return f"resident={sc.resident!r} (the residency slice)"
    if sc.mesh is not None:
        return "mesh (multi-GPU replica sharding, not ported)"
    if sc.tunable is not None:
        return "tunable (the tunable-serving slice)"
    return None


class TMService:
    """K concurrent Fig-3 machines behind one control surface (K >= 1).

    ``state`` is a single machine's :class:`TMState` (copied to K
    identical banks) or one with a leading replica axis of K. ``rt``
    overrides the runtime built from ``sc.s``/``sc.T``. ``eval_x``/
    ``eval_y`` are the accuracy-analysis set; without them ``tick`` drains
    but never analyzes. ``device`` defaults to the card.
    """

    def __init__(self, cfg: TMConfig, state: TMState,
                 sc: Optional[ServiceConfig] = None, *,
                 rt: Optional[TMRuntime] = None, eval_x=None, eval_y=None,
                 device=None):
        sc = sc or ServiceConfig()
        why = _not_yet(sc)
        if why is not None:
            raise NotImplementedError(f"TMService: {why} is not ported yet")
        if sc.history_limit is not None and sc.history_limit < 1:
            raise ValueError("history_limit must be >= 1 (or None)")
        K = sc.replicas
        ta = state.ta_state
        if ta.ndim == 4 and ta.shape[0] != K:
            raise ValueError(
                f"state carries {ta.shape[0]} replicas, expected {K}")
        dev = tm_mod.resolve_device(device)

        self.cfg = cfg
        self.sc = sc
        self.device = dev
        self.rt = rt if rt is not None else sc.runtime(cfg, dev)
        self.n_replicas = K
        self.chunk = max(1, min(sc.chunk, sc.buffer_capacity))
        self.policy = sc.policy
        # Packed services hold the eval set as words, so every analysis
        # rides the packed kernels.
        self.eval_x = None if eval_x is None else self._ingest(eval_x)
        self.eval_y = None if eval_y is None else self._labels(eval_y)
        # K = 1 with scalar ports keeps the single-machine bodies.
        self._k1 = (K == 1 and torch.as_tensor(self.rt.s).ndim == 0
                    and torch.as_tensor(self.rt.T).ndim == 0)

        seed = sc.seed
        if isinstance(seed, (int, np.integer)):
            base = rnd.PRNGKey(int(seed), dev)
            self._keys = torch.stack([rnd.fold_in(base, r)
                                      for r in range(K)])
        else:
            if len(seed) != K:
                raise ValueError(f"need {K} seeds, got {len(seed)}")
            self._keys = torch.stack([rnd.PRNGKey(int(s), dev)
                                      for s in seed])

        ta = ta.to(dev)
        bank = ta if ta.ndim == 4 else ta.expand((K,) + ta.shape)
        self._ss = SessionState(
            tm=TMState(ta_state=bank.contiguous()),
            buf=buf_mod.stack(buf_mod.make(sc.buffer_capacity,
                                           cfg.n_features, dev,
                                           packed=sc.packed), K),
            step=torch.zeros((K,), dtype=torch.int32, device=dev),
        )
        self.router = router_mod.BatchRouter(
            K, cfg.n_features, sc.buffer_capacity, sc.ingress_block,
            packed=sc.packed)
        # Outstanding-rows mirror: ring occupancy + rows in flight to the
        # device. Guarded by router.lock.
        self._dev_size = np.zeros(K, dtype=np.int64)
        self._device_lock = threading.RLock()
        self._full_mask = np.ones(K, dtype=bool)
        self._ps = sc.policy.init(K)
        self.history: list = []            # (steps [K], accuracies [K])

    def _ingest(self, xs) -> torch.Tensor:
        """Rows -> the service's wire representation on its device: bool
        features, or packed words when ``sc.packed``. Packed services pack
        numpy rows on the host and tensors on their device; np.uint32 rows
        and the port's int32 word tensors pass through as words."""
        if torch.is_tensor(xs):
            if not self.sc.packed:
                return xs.to(self.device).to(torch.bool)
            if tm_mod.is_packed(xs):
                return packing.as_words(xs).to(self.device)
            return packing.pack_bits(xs.to(self.device))
        xs = np.asarray(xs)
        if not self.sc.packed:
            return torch.from_numpy(xs.astype(bool)).to(self.device)
        if xs.dtype != np.uint32:
            xs = packing.pack_bits_np(xs)
        return packing.words_from_numpy(xs).to(self.device)

    def _labels(self, ys) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ys), dtype=torch.int32).to(
            self.device)

    # -- device state ---------------------------------------------------------

    @property
    def ss(self) -> SessionState:
        """Device state ([K, ...] leaves), staged ingress flushed first."""
        with self._device_lock:
            self.flush()
            return self._ss

    @ss.setter
    def ss(self, value: SessionState):
        """Replace the device state wholesale; the occupancy mirror follows
        its rings."""
        with self._device_lock:
            self._ss = value
            with self.router.lock:
                self._dev_size = value.buf.size.cpu().numpy().astype(
                    np.int64).reshape(self.n_replicas).copy()

    def session_state(self) -> SessionState:
        """The K = 1 machine's state without the replica axis, staged
        ingress flushed first."""
        if self.n_replicas != 1:
            raise ValueError("session_state is the K = 1 view")
        return _squeeze(self.ss)

    # -- ingress (producer side) ----------------------------------------------

    def submit_rows(self, xs, ys, mask=None) -> np.ndarray:
        """One labelled datapoint into every (masked) replica's stream;
        returns accepted [K] bool (False = backpressure, counted in
        ``dropped``). A full staging lane flushes at once."""
        pending = (self._full_mask if mask is None
                   else np.asarray(mask, dtype=bool))
        accepted = np.zeros(self.n_replicas, dtype=bool)
        while True:
            ok, blocked = self.router.stage_rows(
                xs, ys, pending, self._dev_size)
            accepted |= ok
            if self.router.lane_full():
                self.flush()
            if not blocked.any():
                return accepted
            pending = blocked

    def submit(self, r: int, x, y) -> bool:
        """One labelled datapoint into replica ``r``'s stream."""
        mask = np.zeros(self.n_replicas, dtype=bool)
        mask[r] = True
        return bool(self.submit_rows(x, y, mask)[r])

    def flush(self) -> np.ndarray:
        """Push every staged row into the rings, one vectorised enqueue per
        staged block. Returns [K] rows landed; rows a ring rejects despite
        the mirror count as dropped."""
        landed = np.zeros(self.n_replicas, dtype=np.int64)
        with self._device_lock:
            while True:
                with self.router.lock:
                    block = self.router.take_block()
                    if block is not None:
                        self._dev_size += block[2]
                if block is None:
                    return landed
                xs, ys, counts = block
                buf, accepted = router_mod._enqueue_rows(
                    self._ss.buf, xs, ys, counts)
                self._ss = self._ss._replace(buf=buf)
                acc = accepted.cpu().numpy().astype(np.int64)
                with self.router.lock:
                    self._dev_size -= counts - acc
                    self.router.dropped += counts - acc
                landed += acc

    @property
    def buffered(self) -> np.ndarray:
        """Datapoints awaiting consumption per replica (ring + in flight +
        staged)."""
        with self.router.lock:
            return self._dev_size + self.router.staged

    @property
    def dropped(self) -> np.ndarray:
        """Backpressure events per replica. [K] i64 (a copy)."""
        with self.router.lock:
            return self.router.dropped.copy()

    # -- consumer side ----------------------------------------------------------

    def drain(self, max_points,
              on_chunk: Optional[Callable[[ChunkAux], None]] = None
              ) -> np.ndarray:
        """Consume up to ``max_points`` buffered rows per replica; [K]
        trained.

        Flushes staged ingress, then drains chunk by chunk, the whole
        fleet per chunk. ``on_chunk`` receives each chunk's
        :class:`ChunkAux` with a leading replica axis ``[K, chunk]``;
        without it the monitoring pass does not run.
        """
        budget = np.broadcast_to(np.asarray(max_points, dtype=np.int64),
                                 (self.n_replicas,)).copy()
        with self._device_lock:
            self.flush()
            if self._k1:
                return self._drain_k1(budget, on_chunk)
            return self._drain_replicated(budget, on_chunk)

    def _drain_replicated(self, budget: np.ndarray, on_chunk) -> np.ndarray:
        K = len(budget)
        trained = np.zeros(K, dtype=np.int64)
        active = trained < budget
        monitor = on_chunk is not None
        while active.any():
            want = np.where(active, np.minimum(self.chunk, budget - trained),
                            0)
            self._keys, chunk_keys = _advance_keys(self._keys, active)
            self._ss, n, aux = online_mod._consume_many_replicated(
                self.cfg, self.chunk, self._ss, self.rt, want, chunk_keys,
                monitor=monitor)
            trained += n
            # commit the mirror before the callback, so a callback that
            # raises cannot desync it from the device
            with self.router.lock:
                self._debit_mirror(n)
            if monitor and n.any():
                on_chunk(aux)
            active &= (n == want) & (trained < budget)
        return trained

    def _debit_mirror(self, n: np.ndarray) -> None:
        """Rows consumed per replica off the mirror. Callers hold the
        router lock."""
        self._dev_size -= n

    def _drain_k1(self, budget: np.ndarray, on_chunk) -> np.ndarray:
        """The single-machine drain body on the K = 1 slice."""
        trained, budget1 = 0, int(budget[0])
        monitor = on_chunk is not None
        while trained < budget1:
            want = min(self.chunk, budget1 - trained)
            self._keys, chunk_keys = _advance_keys(self._keys,
                                                   self._full_mask)
            ss1, n, aux = online_mod._consume_many(
                self.cfg, self.chunk, _squeeze(self._ss), self.rt, want,
                chunk_keys[0], monitor=monitor)
            trained += n
            self._ss = _unsqueeze(ss1)
            with self.router.lock:
                self._debit_mirror(np.asarray([n], dtype=np.int64))
            if monitor and n:
                on_chunk(ChunkAux(*(a[None] for a in aux)))
            if n < want:  # the ring ran dry before the budget
                break
        return np.asarray([trained], dtype=np.int64)

    # -- inference ----------------------------------------------------------------

    def serve(self, xs) -> np.ndarray:
        """Fleet inference [K, B] i32: ``xs`` is [B, f] (one batch for
        every member, stored once: D = 1) or [K, B, f] (one per member).
        Packed services serve packed words through K5/K6."""
        xs = self._ingest(xs)
        with self._device_lock:
            tm = self._ss.tm
            if xs.ndim == 2 and self._k1:
                preds = tm_mod.predict_batch(
                    self.cfg, TMState(tm.ta_state[0]), self.rt, xs)
                return preds.cpu().numpy()[None]
            if xs.ndim == 2:
                xs = xs[None]
            return tm_mod.predict_batch_replicated(
                self.cfg, tm, self.rt, xs).cpu().numpy()

    # -- analysis + the Fig-3 policy loop -----------------------------------------

    def analyze(self) -> np.ndarray:
        """Eval accuracy of every member in one clause plane. [K] f32;
        appends to ``history``."""
        if self.eval_x is None:
            raise ValueError("TMService built without an eval set")
        with self._device_lock:
            acc = self._measure()
            self.history.append((self.steps, acc))
            if self.sc.history_limit is not None:
                del self.history[:-self.sc.history_limit]
            return acc

    def _measure(self) -> np.ndarray:
        tm = self._ss.tm
        if self._k1:
            return np.asarray([float(acc_mod.analyze(
                self.cfg, TMState(tm.ta_state[0]), self.rt, self.eval_x,
                self.eval_y))], dtype=np.float32)
        return acc_mod.analyze_replicated(
            self.cfg, tm, self.rt, self.eval_x[None], self.eval_y[None]
        ).cpu().numpy()

    def offline_train(self, xs, ys, n_epochs: int = 10,
                      seed: int = 1) -> np.ndarray:
        """Offline phase for the whole fleet on bool rows, keyed by
        ``PRNGKey(seed)``; the result becomes every member's known-good
        baseline. Returns the eval accuracy [K]."""
        xs = torch.from_numpy(np.asarray(xs, dtype=bool)) \
            if not torch.is_tensor(xs) else xs.to(torch.bool)
        xs = xs.to(self.device)
        ys = self._labels(ys)
        key = rnd.PRNGKey(seed, self.device)
        with self._device_lock:
            tm = self._ss.tm
            if self._k1:
                st = fb_mod.train_epochs(
                    self.cfg, TMState(tm.ta_state[0]), self.rt, xs, ys, key,
                    n_epochs)
                st = TMState(st.ta_state[None])
            else:
                st = fb_mod.train_epochs_replicated(
                    self.cfg, tm, self.rt, xs[None], ys[None], key[None],
                    n_epochs)
            self._ss = self._ss._replace(tm=st)
            acc = self.analyze()
            self.policy.snapshot(self._ps, acc, st)
            return acc

    def _maybe_analyze(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Analysis + the §5.3.2 policy when a member is due. Returns
        (accuracies [K], rolled-back mask [K]) or None."""
        if self.eval_x is None:
            return None
        due = self.policy.due(self._ps)
        if not due.any():
            return None
        acc = self.analyze()
        tm, rolled = self.policy.apply(self._ps, due, acc, self._ss.tm)
        self._ss = self._ss._replace(tm=tm)
        return acc, rolled

    def tick(self, max_points=None,
             on_chunk: Optional[Callable[[ChunkAux], None]] = None
             ) -> TickReport:
        """One Fig-3 consumer cycle: flush ingress, drain up to
        ``max_points`` (default: one chunk) per replica, advance the
        analysis cadence, and apply the mitigation policy to due
        members."""
        budget = self.chunk if max_points is None else max_points
        with self._device_lock:
            trained = self.drain(budget, on_chunk)
            self._ps.since += trained
            out = self._maybe_analyze()
        if out is None:
            return TickReport(trained, None,
                              np.zeros(self.n_replicas, dtype=bool))
        return TickReport(trained, out[0], out[1])

    def observe_rows(self, xs, ys, mask=None) -> Optional[np.ndarray]:
        """The legacy managers' per-point FSM step: one labelled datapoint
        per (masked) replica, a drain-and-retry on backpressure, one
        chunk-budget drain, then cadence, analysis and rollback. Returns
        [K] eval accuracies when a member hit its cadence, else None.
        Drained points advance each member's own cadence counter."""
        K = self.n_replicas
        mask = (np.ones(K, dtype=bool) if mask is None
                else np.asarray(mask, dtype=bool))
        with self._device_lock:
            accepted = self.submit_rows(xs, ys, mask)
            retry = mask & ~accepted
            if retry.any():
                self._ps.since += self.drain(self.chunk)
                accepted = self.submit_rows(xs, ys, retry)
                self._ps.lost += retry & ~accepted
            self._ps.since += self.drain(self.chunk)
            out = self._maybe_analyze()
        return None if out is None else out[0]

    # -- durable state ---------------------------------------------------------

    def save(self, *args, **kwargs):
        raise NotImplementedError(
            "TMService.save writes the residency manifest and belongs to "
            "the residency slice, which is not ported yet")

    def load(self, *args, **kwargs):
        raise NotImplementedError(
            "TMService.load belongs to the residency slice, which is not "
            "ported yet")

    @classmethod
    def restore(cls, *args, **kwargs):
        raise NotImplementedError(
            "TMService.restore belongs to the residency slice, which is "
            "not ported yet")

    # -- observability ------------------------------------------------------------

    @property
    def steps(self) -> np.ndarray:
        """Online datapoints consumed, [K] i32."""
        return self._ss.step.cpu().numpy()

    @property
    def rng_keys(self) -> np.ndarray:
        """RNG keys as the reference's raw uint32 key data, [K, 2]."""
        return self._keys.cpu().numpy().astype(np.uint32)

    @property
    def rollbacks(self) -> np.ndarray:
        return self._ps.rollbacks

    @property
    def lost(self) -> np.ndarray:
        return self._ps.lost

    @property
    def since_analysis(self) -> np.ndarray:
        return self._ps.since
