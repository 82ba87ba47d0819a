"""TMService on torch: the K = 1 serving surface of the paper's system.

The twin of ``repro.serve.service.TMService`` for one machine, Fig. 3's
offer -> cyclic buffer -> interleaved train/infer loop with the §5.3.2
mitigation policy:

* ``submit`` / ``submit_rows`` -- labelled traffic, staged on the host by
  a :class:`~repro_torch.serve.router.BatchRouter` and flushed in blocks.
* ``serve`` -- batch inference, one clause plane (K2).
* ``tick`` -- one consumer cycle: flush ingress, drain the budget through
  online training (K1 + K8 per point), advance the analysis cadence and
  apply :class:`AdaptPolicy`.
* ``offline_train`` / ``analyze`` -- the offline phase and the accuracy
  block.

The seed and key schedule are the reference's: keys
``fold_in(PRNGKey(seed), r)`` (or ``PRNGKey(seed[r])`` for a sequence of
seeds), one ``split`` per drained chunk, and ``PRNGKey(seed=1)`` for
``offline_train``. So a run here is bitwise the reference's. The views
the reference exposes per replica (``steps``, ``rng_keys``, ``buffered``,
``dropped``, reports, ``ss``) keep their leading K = 1 axis.

Fleets (``replicas > 1``), the bit-packed datapath, residency, meshes and
tunable serving are later slices of the port and raise
``NotImplementedError`` here.

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
from repro_torch.serve import router as router_mod


def _select(mask: np.ndarray, new: TMState, old: TMState) -> TMState:
    """Per-replica select at K = 1: ``new`` where mask[0], else ``old``."""
    return new if bool(mask[0]) else old


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
    best_state: Optional[TMState] = None   # known-good TA bank


@dataclasses.dataclass
class AdaptPolicy:
    """The §5.3.2 mitigation policy: periodic analysis + rollback.

    A member that consumed ``analyze_every`` points since its last
    analysis is *due*: its eval accuracy is measured again, and it rolls
    back to its known-good TA bank on a drop past ``rollback_threshold``,
    or snapshots a new best.
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
        (new TA bank, rolled-back mask [K])."""
        ps.since[due] = 0
        have_best = ~np.isnan(ps.best)
        collapse = due & have_best & (acc < ps.best - self.rollback_threshold)
        improve = due & (~have_best | (acc > ps.best))
        if collapse.any():
            tm = _select(collapse, ps.best_state, tm)
            ps.rollbacks += collapse
        if improve.any():
            ps.best = np.where(improve, acc, ps.best)
            # The first improve snapshots unconditionally: there is no
            # known-good bank before the first analysis or offline_train.
            ps.best_state = (tm if ps.best_state is None
                             else _select(improve, tm, ps.best_state))
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

    ``s``/``T`` set the runtime's hyperparameter ports (scalars).
    ``ingress_block`` is the router's staged rows per replica per flush.
    ``history_limit`` keeps only the most recent N analysis entries (None
    keeps all). ``replicas``, ``packed``, ``resident``, ``mesh`` and
    ``tunable`` keep the reference's names; values other than the K = 1
    defaults belong to later slices of the port and raise.
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
        """A fault-free runtime with this config's s/T ports."""
        rt = init_runtime(cfg, device=device)
        if self.s is not None:
            rt = rt._replace(s=torch.tensor(self.s, dtype=torch.float32))
        if self.T is not None:
            rt = rt._replace(T=torch.tensor(self.T, dtype=torch.int32))
        return rt


def _not_yet(sc: ServiceConfig) -> Optional[str]:
    """The first knob of ``sc`` that a later slice of the port serves."""
    if sc.replicas != 1:
        return f"replicas={sc.replicas} (the fleet slice)"
    if sc.packed:
        return "packed=True (the bit-packed slice)"
    if sc.resident is not None:
        return f"resident={sc.resident!r} (the residency slice)"
    if sc.mesh is not None:
        return "mesh (the fleet slice)"
    if sc.tunable is not None:
        return "tunable (the tunable-serving slice)"
    for name in ("s", "T"):
        if np.ndim(getattr(sc, name)) != 0:
            return f"per-replica {name} (the fleet slice)"
    return None


class TMService:
    """One Fig-3 machine behind the reference's control surface (K = 1).

    ``state`` is a single machine's :class:`TMState` (or one with a
    leading replica axis of 1). ``rt`` overrides the runtime built from
    ``sc.s``/``sc.T``. ``eval_x``/``eval_y`` are the accuracy-analysis
    set; without them ``tick`` drains but never analyzes. ``device``
    defaults to the card.
    """

    def __init__(self, cfg: TMConfig, state: TMState,
                 sc: Optional[ServiceConfig] = None, *,
                 rt: Optional[TMRuntime] = None, eval_x=None, eval_y=None,
                 device=None):
        sc = sc or ServiceConfig()
        why = _not_yet(sc)
        if why is not None:
            raise NotImplementedError(
                f"TMService: {why} is not ported yet; the port serves K = 1"
            )
        if sc.history_limit is not None and sc.history_limit < 1:
            raise ValueError("history_limit must be >= 1 (or None)")
        dev = tm_mod.resolve_device(device)
        ta = state.ta_state
        if ta.ndim == 4:
            if ta.shape[0] != 1:
                raise ValueError(
                    f"state carries {ta.shape[0]} replicas, expected 1")
            ta = ta[0]

        self.cfg = cfg
        self.sc = sc
        self.device = dev
        self.rt = rt if rt is not None else sc.runtime(cfg, dev)
        self.n_replicas = 1
        self.chunk = max(1, min(sc.chunk, sc.buffer_capacity))
        self.policy = sc.policy
        self.eval_x = None if eval_x is None else self._ingest(eval_x)
        self.eval_y = (None if eval_y is None else
                       torch.as_tensor(np.asarray(eval_y), dtype=torch.int32)
                       .to(dev))

        seed = sc.seed
        if isinstance(seed, (int, np.integer)):
            self._key = rnd.fold_in(rnd.PRNGKey(int(seed), dev), 0)
        else:
            if len(seed) != 1:
                raise ValueError(f"need 1 seed, got {len(seed)}")
            self._key = rnd.PRNGKey(int(seed[0]), dev)

        self._ss = SessionState(
            tm=TMState(ta_state=ta.to(dev)),
            buf=buf_mod.make(sc.buffer_capacity, cfg.n_features, dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )
        self.router = router_mod.BatchRouter(
            1, cfg.n_features, sc.buffer_capacity, sc.ingress_block)
        # Outstanding-rows mirror: ring occupancy + rows in flight to the
        # device. Guarded by router.lock.
        self._dev_size = np.zeros(1, dtype=np.int64)
        self._device_lock = threading.RLock()
        self._full_mask = np.ones(1, dtype=bool)
        self._ps = sc.policy.init(1)
        self.history: list = []            # (steps [K], accuracies [K])

    def _ingest(self, xs) -> torch.Tensor:
        """Rows -> bool features on the service's device."""
        xs = torch.as_tensor(np.asarray(xs)) if not torch.is_tensor(xs) else xs
        if xs.dtype == torch.uint32:
            raise NotImplementedError(
                "uint32 rows are bit-packed; the packed slice has not landed")
        return xs.to(self.device).to(torch.bool)

    # -- device state ---------------------------------------------------------

    def session_state(self) -> SessionState:
        """The single-machine device state, staged ingress flushed first."""
        with self._device_lock:
            self.flush()
            return self._ss

    @property
    def ss(self) -> SessionState:
        """Device state with the reference's leading K = 1 axis, staged
        ingress flushed first."""
        ss = self.session_state()
        return SessionState(
            tm=TMState(ss.tm.ta_state[None]),
            buf=buf_mod.RingBuffer(*(a[None] for a in ss.buf)),
            step=ss.step[None],
        )

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
        """Push every staged row into the ring. Returns [K] rows landed;
        rows the ring rejects despite the mirror count as dropped."""
        landed = np.zeros(1, dtype=np.int64)
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
                    self._ss.buf, xs[0], ys[0], int(counts[0]))
                self._ss = self._ss._replace(buf=buf)
                acc = np.asarray([int(accepted)], dtype=np.int64)
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
        """Consume up to ``max_points`` buffered rows; [K] trained.

        Flushes staged ingress, then drains chunk by chunk, splitting the
        key once per chunk. ``on_chunk`` receives each chunk's
        :class:`ChunkAux` with a leading replica axis ``[1, chunk]``;
        without it the monitoring pass does not run.
        """
        budget = int(np.broadcast_to(np.asarray(max_points), (1,))[0])
        monitor = on_chunk is not None
        trained = 0
        with self._device_lock:
            self.flush()
            while trained < budget:
                want = min(self.chunk, budget - trained)
                k2 = rnd.split(self._key)
                self._key, chunk_key = k2[0], k2[1]
                ss, n, aux = online_mod._consume_many(
                    self.cfg, self.chunk, self._ss, self.rt, want, chunk_key,
                    monitor=monitor)
                trained += n
                # commit state + mirror before the callback
                self._ss = ss
                with self.router.lock:
                    self._dev_size[0] -= n
                if monitor and n:
                    on_chunk(ChunkAux(*(a[None] for a in aux)))
                if n < want:  # the ring ran dry before the budget
                    break
        return np.asarray([trained], dtype=np.int64)

    # -- inference ----------------------------------------------------------------

    def serve(self, xs) -> np.ndarray:
        """Batch inference [K, B] i32 of rows ``xs`` [B, f] (or [1, B, f])."""
        xs = self._ingest(xs)
        if xs.ndim == 3:
            if xs.shape[0] != 1:
                raise ValueError(f"{xs.shape[0]} batches for 1 replica")
            xs = xs[0]
        with self._device_lock:
            preds = tm_mod.predict_batch(self.cfg, self._ss.tm, self.rt, xs)
            return preds.cpu().numpy()[None]

    # -- analysis + the Fig-3 policy loop -----------------------------------------

    def analyze(self) -> np.ndarray:
        """Eval accuracy, one clause plane (K2). [K] f32; appends to
        ``history``."""
        if self.eval_x is None:
            raise ValueError("TMService built without an eval set")
        with self._device_lock:
            acc = np.asarray([float(acc_mod.analyze(
                self.cfg, self._ss.tm, self.rt, self.eval_x, self.eval_y
            ))], dtype=np.float32)
            self.history.append((self.steps, acc))
            if self.sc.history_limit is not None:
                del self.history[:-self.sc.history_limit]
            return acc

    def offline_train(self, xs, ys, n_epochs: int = 10,
                      seed: int = 1) -> np.ndarray:
        """Offline phase: ``n_epochs`` passes keyed by ``PRNGKey(seed)``;
        the result becomes the known-good baseline. Returns the eval
        accuracy [K]."""
        xs = self._ingest(xs)
        ys = torch.as_tensor(np.asarray(ys), dtype=torch.int32).to(
            self.device)
        with self._device_lock:
            st = fb_mod.train_epochs(
                self.cfg, self._ss.tm, self.rt, xs, ys,
                rnd.PRNGKey(seed, self.device), n_epochs)
            self._ss = self._ss._replace(tm=st)
            acc = self.analyze()
            self.policy.snapshot(self._ps, acc, st)
            return acc

    def _maybe_analyze(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Analysis + the §5.3.2 policy when due. Returns (accuracies [K],
        rolled-back mask [K]) or None."""
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
        ``max_points`` (default: one chunk), advance the analysis cadence,
        and apply the mitigation policy when due."""
        budget = self.chunk if max_points is None else max_points
        with self._device_lock:
            trained = self.drain(budget, on_chunk)
            self._ps.since += trained
            out = self._maybe_analyze()
        if out is None:
            return TickReport(trained, None, np.zeros(1, dtype=bool))
        return TickReport(trained, out[0], out[1])

    # -- observability ------------------------------------------------------------

    @property
    def steps(self) -> np.ndarray:
        """Online datapoints consumed, [K] i32."""
        return self._ss.step.cpu().numpy().reshape(1)

    @property
    def rng_keys(self) -> np.ndarray:
        """RNG keys as the reference's raw uint32 key data, [K, 2]."""
        return self._key.cpu().numpy().astype(np.uint32)[None]

    @property
    def rollbacks(self) -> np.ndarray:
        return self._ps.rollbacks

    @property
    def lost(self) -> np.ndarray:
        return self._ps.lost

    @property
    def since_analysis(self) -> np.ndarray:
        return self._ps.since
