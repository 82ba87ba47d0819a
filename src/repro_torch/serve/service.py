"""TMService on torch: the serving surface of the paper's system, K >= 1.

The twin of ``repro.serve.service.TMService``: K concurrent Fig-3
machines (offer -> cyclic buffer -> interleaved train/infer, with the
§5.3.2 mitigation policy) behind one control surface:

* ``submit`` / ``submit_rows`` -- labelled traffic, staged on the host by
  a :class:`~repro_torch.serve.router.BatchRouter` and flushed in
  ``[K, B_ingress]`` blocks.
* ``serve`` / ``serve_replicas`` -- fleet inference, one replica-first
  clause plane (K4, or K6 on packed rows; K = 1 with scalar ports: K2 or
  K5); with ``ServiceConfig(tunable=...)`` and a ``budget`` (or an active
  tuner) the runtime-tunable path instead: only the top-ranked clauses of
  each class, through the pruned entries (K7), with optional vote weights
  and early exit (``calibrate`` ranks the clauses first).
* ``tick`` -- one consumer cycle: flush ingress, drain every replica's
  budget through online training, advance the analysis cadence and apply
  :class:`AdaptPolicy` per replica.
* ``offline_train`` / ``analyze`` / ``observe_rows`` -- the offline phase,
  the accuracy block and the legacy managers' per-point FSM step.
* ``save`` / ``load`` / ``restore`` -- durable state in the reference's
  checkpoint layout (:mod:`repro_torch.train.checkpoint`): a checkpoint
  either package writes restores in the other and continues bit for bit.

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
reference's. Residency and meshes are later slices of the port and raise
``NotImplementedError``.

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

from repro_torch import convert
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
from repro_torch.serve import tunable as tun_mod
from repro_torch.train import checkpoint as ckpt_mod

# Backend names as they cross checkpoints: the port's hand-written kernels
# take the reference's kernel backend's name, so either package's
# TMConfig accepts the other's manifest.
_BACKEND_OUT = {"cuda": "pallas"}
_BACKEND_IN = {"pallas": "cuda"}


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
    keeps all). ``tunable`` (a :class:`~repro_torch.serve.tunable.
    TunableConfig`) arms runtime-tunable serving. ``resident`` and
    ``mesh`` keep the reference's names; values other than their defaults
    belong to later slices of the port and raise.
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
        self.tuner = (None if sc.tunable is None else
                      tun_mod.TuneController(sc.tunable, K, cfg.max_clauses))

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

    def serve(self, xs, *, budget=None, return_aux: bool = False):
        """Fleet inference [K, B] i32: ``xs`` is [B, f] (one batch for
        every member, stored once: D = 1) or [K, B, f] (one per member).
        Packed services serve packed words through K5/K6.

        ``budget`` (fraction of clauses, (0, 1]) routes the request through
        the runtime-tunable path: only the top-m ranked clauses per class
        are contracted (K7), with the configured weights and early exit.
        It needs ``ServiceConfig(tunable=...)`` and a prior
        :meth:`calibrate`. Without a budget, a tunable service serves at
        the controller's live budget (the plain path when that is 1.0 with
        unit weights and no early exit). ``return_aux`` also returns the
        :class:`~repro_torch.serve.tunable.ServeAux` (tunable path only).
        """
        xs = self._ingest(xs)
        with self._device_lock:
            if not self._tunable(budget):
                if return_aux:
                    raise ValueError(
                        "return_aux reports the budgeted path's compute: "
                        "pass a budget (or configure an active tunable)")
                tm = self._ss.tm
                if xs.ndim == 2 and self._k1:
                    preds = tm_mod.predict_batch(
                        self.cfg, TMState(tm.ta_state[0]), self.rt, xs)
                    return preds.cpu().numpy()[None]
                if xs.ndim == 2:
                    xs = xs[None]
                return tm_mod.predict_batch_replicated(
                    self.cfg, tm, self.rt, xs).cpu().numpy()
            tuner = self._require_tuner()
            preds, aux = self._serve_tunable(
                self._ss.tm, xs, tuner.order, tuner.weights, budget)
            return (preds, aux) if return_aux else preds

    def _tunable(self, budget) -> bool:
        """Does this request take the budgeted path?"""
        return budget is not None or (self.tuner is not None
                                      and self.tuner.active)

    def _require_tuner(self) -> tun_mod.TuneController:
        if self.tuner is None:
            raise ValueError(
                "budgeted serving needs ServiceConfig(tunable=TunableConfig"
                "(...)): this service was built without it")
        if not self.tuner.calibrated:
            raise ValueError(
                "budgeted serving needs clause ranks: call calibrate() "
                "(after training) before serving with a budget")
        return self.tuner

    def _serve_tunable(self, tm_plane: TMState, xs: torch.Tensor,
                       order: np.ndarray, weights: Optional[np.ndarray],
                       budget) -> tuple[np.ndarray, tun_mod.ServeAux]:
        """The budgeted serve body on a device plane whose rows align with
        ``order``/``weights``."""
        tc = self.sc.tunable
        b = self.tuner.budget if budget is None else float(budget)
        m = tun_mod.m_for_budget(b, self.cfg.max_clauses)
        if xs.ndim == 2:
            xs = xs[None]     # D = 1: one shared stream
        preds, evaluated = tun_mod.predict_pruned_replicated_host(
            self.cfg, tm_plane, self.rt, xs, order, weights, m,
            group=tc.group if tc.early_exit else None)
        aux = tun_mod.ServeAux(budget=b, m=m, sel=order[:, :, :m].copy(),
                               evaluated=evaluated)
        return preds, aux

    def serve_replicas(self, replicas, xs, *, budget=None,
                       return_aux: bool = False):
        """Inference for the named replicas only: [n, B] i32. ``xs`` is
        [B, f] (one batch for all named members) or [n, B, f] (one each).
        The named members' banks are gathered into one plane and served in
        one contraction; each serves from its own calibrated ranking on
        the budgeted path. ``budget``/``return_aux`` as in :meth:`serve`.
        """
        xs = self._ingest(xs)
        rids = np.asarray(replicas, dtype=np.int64).reshape(-1)
        if rids.size == 0 or rids.min() < 0 or rids.max() >= self.n_replicas:
            raise ValueError(f"replica ids must name members of "
                             f"[0, {self.n_replicas}), got {rids.tolist()}")
        tunable = self._tunable(budget)
        if return_aux and not tunable:
            raise ValueError(
                "return_aux reports the budgeted path's compute: pass a "
                "budget (or configure an active tunable)")
        tuner = self._require_tuner() if tunable else None
        with self._device_lock:
            idx = torch.from_numpy(rids).to(self.device)
            tm_c = TMState(self._ss.tm.ta_state[idx])
            xs_c = xs[None] if xs.ndim == 2 else xs
            if not tunable:
                return tm_mod.predict_batch_replicated(
                    self.cfg, tm_c, self.rt, xs_c).cpu().numpy()
            w_c = None if tuner.weights is None else tuner.weights[rids]
            preds, aux = self._serve_tunable(tm_c, xs_c, tuner.order[rids],
                                             w_c, budget)
        return (preds, aux) if return_aux else preds

    def calibrate(self, xs=None, ys=None) -> np.ndarray:
        """Rank every replica's clauses on a calibration set (default: the
        eval set), polarity-balanced, and derive integer vote weights when
        the tunable config asks for them. Returns the [K, C, J] i32 score
        plane. Calibrate again when the banks have drifted; serving in
        between uses the older ranks."""
        if self.tuner is None:
            raise ValueError(
                "calibrate needs ServiceConfig(tunable=TunableConfig(...))")
        xs = self.eval_x if xs is None else self._ingest(xs)
        ys = self.eval_y if ys is None else self._labels(ys)
        if xs is None or ys is None:
            raise ValueError(
                "calibrate needs a labelled set: pass (xs, ys) or build the "
                "service with eval_x/eval_y")
        with self._device_lock:
            tm = self._ss.tm
            if self._k1:
                scores = tun_mod.clause_scores(
                    self.cfg, TMState(tm.ta_state[0]), self.rt, xs, ys)[None]
            else:
                scores = tun_mod.clause_scores_replicated(
                    self.cfg, tm, self.rt, xs[None], ys[None])
            scores = scores.cpu().numpy()
            self.tuner.set_ranking(
                tun_mod.rank_from_scores(
                    scores, tm_mod.clause_polarity(self.cfg).numpy()),
                tun_mod.weights_from_scores(scores,
                                            self.sc.tunable.weight_bits),
                score=scores)
        return scores

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
            if self.tuner is not None and self.sc.tunable.adapt:
                # The queue depth after the drain is the observed backlog:
                # deep queues shed serve compute, light ones restore it.
                self.tuner.update(self.buffered)
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

    # -- durable state -------------------------------------------------------

    def save(self, directory: str, *, step: Optional[int] = None,
             keep: int = 3) -> str:
        """Write the full consumer-side state as one atomic checkpoint in
        the reference's layout: TA banks, rings, step counters, RNG keys
        (uint32), the runtime, the §5.3.2 policy with its known-good
        banks, the analysis history, the router's loss counters and a
        calibrated tuner. Staged ingress flushes first, so every accepted
        row is in a saved ring or already consumed: save -> restore ->
        continue equals never stopping, bit for bit. Returns the path."""
        with self._device_lock:
            self.flush()
            ps = self._ps
            K = self.n_replicas
            if self.history:
                hsteps = np.stack([np.asarray(h[0]) for h in self.history])
                haccs = np.stack([np.asarray(h[1]) for h in self.history])
            else:
                hsteps = np.zeros((0, K), dtype=np.int32)
                haccs = np.zeros((0, K), dtype=np.float32)
            with self.router.lock:
                router_state = {"dropped": self.router.dropped.copy(),
                                "flushes": np.int64(self.router.flushes)}
            tree = {
                "ss": convert.session_state_to_numpy(self._ss),
                "keys": self.rng_keys,
                "rt": convert.to_numpy(self.rt),
                "policy": {
                    "since": ps.since, "best": ps.best,
                    "rollbacks": ps.rollbacks, "lost": ps.lost,
                    "best_state": convert.to_numpy(ps.best_state),
                },
                "router": router_state,
                "history": {"steps": hsteps, "acc": haccs},
            }
            has_tun = self.tuner is not None and self.tuner.calibrated
            if has_tun:
                tree["tunable"] = {"order": self.tuner.order,
                                   "score": self.tuner.score,
                                   "weights": self.tuner.weights}
            extra = {
                "service": self._service_manifest(),
                "has_best_state": ps.best_state is not None,
                "has_tunable": has_tun,
                "tunable_weighted": has_tun and self.tuner.weights is not None,
                "tunable_scored": has_tun and self.tuner.score is not None,
                "tunable_budget": (float(self.tuner.budget)
                                   if self.tuner is not None else None),
            }
            if step is None:
                step = int(self.steps.max(initial=0))
            return ckpt_mod.save(directory, int(step), tree, keep=keep,
                                 extra=extra)

    def _service_manifest(self) -> dict:
        """JSON-able construction knobs, key for key the reference's, so
        :meth:`restore` (of either package) rebuilds the service."""
        sc = self.sc

        def plain(v):
            if v is None or isinstance(v, (bool, int, float, str)):
                return v
            return np.asarray(v).tolist()

        cfg = dataclasses.asdict(self.cfg)
        cfg["backend"] = _BACKEND_OUT.get(cfg["backend"], cfg["backend"])
        return {
            "cfg": cfg,
            "replicas": sc.replicas,
            "buffer_capacity": sc.buffer_capacity,
            "chunk": sc.chunk,
            "ingress_block": sc.ingress_block,
            "packed": sc.packed,
            "history_limit": sc.history_limit,
            "s": plain(sc.s),
            "T": plain(sc.T),
            "seed": plain(sc.seed),
            "resident": sc.resident,
            "policy": {
                "analyze_every": self.policy.analyze_every,
                "rollback_threshold": self.policy.rollback_threshold,
            },
            "tunable": (None if sc.tunable is None
                        else dataclasses.asdict(sc.tunable)),
        }

    def load(self, directory: str, *, step: Optional[int] = None) -> None:
        """Restore a :meth:`save` checkpoint (of either package) into this
        service. The service must match the writer structurally (TMConfig
        shapes, replicas, capacity, packing; :meth:`restore` guarantees
        it). Anything staged or held now is discarded: the checkpoint
        defines the complete state."""
        with self._device_lock:
            while self.router.take_block() is not None:
                pass  # drop staged rows (traffic from before the restore)
            man = ckpt_mod.read_manifest(directory, step=step)
            meta = man["extra"]["service"]
            if meta["replicas"] != self.n_replicas:
                raise ValueError(
                    f"checkpoint carries {meta['replicas']} replicas, "
                    f"this service has {self.n_replicas}")
            if bool(meta["packed"]) != bool(self.sc.packed):
                raise ValueError(
                    "checkpoint and service disagree on the packed "
                    "datapath: ring rows are not interchangeable")
            has_best = bool(man["extra"].get("has_best_state"))
            has_tun = bool(man["extra"].get("has_tunable"))
            template = {
                "ss": SessionState(tm=TMState(0),
                                   buf=buf_mod.RingBuffer(0, 0, 0, 0),
                                   step=0),
                "keys": 0,
                "rt": TMRuntime(0, 0, 0, 0, 0, 0),
                "policy": {"since": 0, "best": 0, "rollbacks": 0, "lost": 0,
                           "best_state": TMState(0) if has_best else None},
                "router": {"dropped": 0, "flushes": 0},
                "history": {"steps": 0, "acc": 0},
            }
            if has_tun:
                template["tunable"] = {
                    "order": 0,
                    "score": 0 if man["extra"].get("tunable_scored") else None,
                    "weights": (0 if man["extra"].get("tunable_weighted")
                                else None),
                }
            tree, man = ckpt_mod.restore(directory, template, step=step)
            self._check_shapes(tree)
            dev = self.device
            self.rt = convert.runtime_from_numpy(tree["rt"], dev)
            pol = tree["policy"]
            self._ps = _PolicyState(
                since=np.asarray(pol["since"], dtype=np.int64),
                best=np.asarray(pol["best"], dtype=np.float64),
                rollbacks=np.asarray(pol["rollbacks"], dtype=np.int64),
                lost=np.asarray(pol["lost"], dtype=np.int64),
                best_state=(convert.state_from_numpy(pol["best_state"], dev)
                            if has_best else None))
            hsteps, haccs = tree["history"]["steps"], tree["history"]["acc"]
            self.history = [(np.asarray(hsteps[i]), np.asarray(haccs[i]))
                            for i in range(len(hsteps))]
            if self.tuner is not None:
                # A calibrated checkpoint restores the ranks; an
                # uncalibrated one resets the controller.
                if has_tun:
                    tun = tree["tunable"]
                    self.tuner.set_ranking(
                        tun["order"], tun["weights"],
                        score=(None if tun["score"] is None else
                               np.asarray(tun["score"], dtype=np.int32)))
                else:
                    self.tuner.order = None
                    self.tuner.weights = None
                    self.tuner.score = None
                saved_b = man["extra"].get("tunable_budget")
                if saved_b is not None:
                    self.tuner.budget = float(saved_b)
            self._ss = convert.session_state_from_numpy(tree["ss"], dev)
            self._keys = convert.key_from_numpy(tree["keys"], dev)
            with self.router.lock:
                self.router.dropped[:] = np.asarray(tree["router"]["dropped"])
                self.router.flushes = int(tree["router"]["flushes"])
                self._dev_size = np.asarray(
                    tree["ss"].buf.size, dtype=np.int64).reshape(
                        self.n_replicas).copy()

    def _check_shapes(self, tree) -> None:
        """A checkpoint whose device state would not fit this service's
        (another TMConfig width, capacity or packing) is rejected."""
        saved = ckpt_mod._flatten_with_paths({"ss": tree["ss"],
                                              "keys": tree["keys"]})
        mine = ckpt_mod._flatten_with_paths({"ss": self._ss,
                                             "keys": self._keys})
        for k, v in saved.items():
            if tuple(v.shape) != tuple(mine[k].shape):
                raise ValueError(
                    f"checkpoint leaf {k} has shape {tuple(v.shape)}, this "
                    f"service holds {tuple(mine[k].shape)}")

    @classmethod
    def restore(cls, directory: str, *, step: Optional[int] = None,
                mesh=None, eval_x=None, eval_y=None,
                resident: Union[int, None, str] = "saved",
                device=None) -> "TMService":
        """Rebuild a service from a :meth:`save` checkpoint of either
        package: construction knobs from the manifest, arrays from the
        npz. The eval set is a runtime resource and is passed fresh.
        ``resident`` defaults to the saved budget; a checkpoint is
        residency-agnostic, so ``resident=None`` migrates a residency
        service's checkpoint onto a wholly device-resident one. Residency
        budgets are the residency slice of the port and raise."""
        man = ckpt_mod.read_manifest(directory, step=step)
        meta = man["extra"]["service"]
        res = meta["resident"] if resident == "saved" else resident
        if res is not None:
            raise NotImplementedError(
                f"TMService.restore(resident={res!r}): residency belongs to "
                "the residency slice, which is not ported yet; pass "
                "resident=None to restore the whole fleet on the device")
        cfgd = dict(meta["cfg"])
        cfgd["backend"] = _BACKEND_IN.get(cfgd["backend"], cfgd["backend"])
        cfg = TMConfig(**cfgd)
        sc = ServiceConfig(
            replicas=meta["replicas"],
            buffer_capacity=meta["buffer_capacity"],
            chunk=meta["chunk"],
            ingress_block=meta["ingress_block"],
            packed=meta["packed"],
            history_limit=meta["history_limit"],
            s=meta["s"],
            T=meta["T"],
            policy=AdaptPolicy(**meta["policy"]),
            seed=meta["seed"],
            mesh=mesh,
            tunable=(None if meta.get("tunable") is None
                     else tun_mod.TunableConfig(**meta["tunable"])),
        )
        svc = cls(cfg, tm_mod.init_state(cfg, device=device), sc,
                  eval_x=eval_x, eval_y=eval_y, device=device)
        svc.load(directory, step=step)
        return svc

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
