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
reference's.

Residency (``ServiceConfig(resident=R)`` or ``"auto"``): the device plane
holds R slots and the other K - R machines live as host snapshots in an
LRU store (:mod:`repro_torch.serve.residency`), activated when traffic,
serving or analysis reaches them. Snapshots leave the card through an
index gather into pinned host memory, awaited by event only where the
snapshot is read (``batched_moves=True``), or through blocking copies
(``batched_moves=False``, the oracle); either way a replica's trajectory
is bitwise its always-resident twin's.

A mesh (``ServiceConfig(mesh=...)``, a :class:`repro_torch.launch.mesh.
Mesh`) shards the plane's replica axis as the reference does
(:func:`repro_torch.distributed.sharding.replica_shardings`): contiguous
slabs of rows, one per mesh device, each with its banks, rings, step
counters and keys on its own device. Every per-plane body (enqueue,
drain, serve, analysis, calibration, the policy's selects, the residency
moves) runs once per slab on that slab's device; nothing crosses devices
inside a step, and results are gathered on the host (or on the service's
device) before anything reduces across replicas, so a sharded service is
bitwise its unsharded twin. Under residency slot s lives on the device of
slab ``s // (R / N)``, and ``"auto"`` plane widths round up to the mesh's
device count. A plane whose length the mesh does not divide is one slab
on the mesh's first device (the reference replicates it). Checkpoints are
the full-K layout either way. (The LM half of the mesh, FSDP / TP over
``torch.distributed`` ranks, is :mod:`repro_torch.distributed.sharding`'s
other half; the service does not use it.)

Threading: ``submit``/``submit_rows`` are safe from any number of
producer threads (they touch only the router's staging state and the
outstanding-rows mirror, both under ``router.lock``). Everything else is
serialized by one re-entrant device lock, the residency map included.
Lock order: device -> router.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch import random as rnd
from repro_torch import tree as T
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core import online as online_mod
from repro_torch.core import tm as tm_mod
from repro_torch.core.online import ChunkAux, SessionState
from repro_torch.core.tm import TMConfig, TMRuntime, TMState, init_runtime
from repro_torch.data import buffer as buf_mod
from repro_torch.distributed import sharding as shard_mod
from repro_torch.kernels import packing
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import residency as res_mod
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


def _activate_enqueue_rows(ss: SessionState, keys: torch.Tensor, act_mask,
                           act_ss, act_keys, xs, ys, counts):
    """A residency cohort's activation, then its block enqueue, in that
    order on the device's one stream: the mask-select lands the slot-
    indexed snapshots (``act_ss``/``act_keys`` from
    ``TMService._prepare_slots``), then the staged rows push into the
    freshly activated rings. Returns (state, keys, accepted [R])."""
    ss, keys = online_mod.activate_replicas((ss, keys), (act_ss, act_keys),
                                            act_mask)
    buf, accepted = router_mod._enqueue_rows(ss.buf, xs, ys, counts)
    return ss._replace(buf=buf), keys, accepted


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _Slab:
    """Plane rows [lo, hi) on one device: their state and RNG keys, and
    what their kernels read there: the runtime (its rows of [K] s/T
    ports) and the eval set."""

    __slots__ = ("dev", "lo", "hi", "ss", "keys", "rt", "eval_x", "eval_y")

    def __init__(self, dev: torch.device, lo: int, hi: int,
                 ss: SessionState, keys: torch.Tensor):
        self.dev, self.lo, self.hi = dev, lo, hi
        self.ss, self.keys = ss, keys
        self.rt = self.eval_x = self.eval_y = None


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
        collapse, improve = self.transition(ps, due, acc)
        if collapse.any():
            tm = _select_replicas(collapse, ps.best_state, tm)
        if improve.any():
            # The first improve snapshots unconditionally: there is no
            # known-good bank before the first analysis or offline_train,
            # and the replicas not improving keep best = nan, so their rows
            # of the snapshot are unreachable until their own first improve.
            ps.best_state = (tm if ps.best_state is None
                             else _select_replicas(improve, tm,
                                                   ps.best_state))
        return tm, collapse

    def transition(self, ps: _PolicyState, due: np.ndarray,
                   acc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The transition's rule on the [K] arrays, whatever holds the
        banks: the due members' counts reset, and of the measured ones
        (accuracy not nan) those that fell past the threshold below their
        best *collapse* (counted in ``rollbacks``) and those that beat it,
        or have none, *improve* (``best`` takes their accuracy). Returns
        (collapse, improve) [K] bool; the caller rolls the collapsed banks
        back from its known-good store, then copies the improved ones in."""
        ps.since[due] = 0
        measured = due & ~np.isnan(acc)
        have_best = ~np.isnan(ps.best)
        collapse = measured & have_best & (
            acc < ps.best - self.rollback_threshold)
        improve = measured & (~have_best | (acc > ps.best))
        if collapse.any():
            ps.rollbacks += collapse
        if improve.any():
            ps.best = np.where(improve, acc, ps.best)
        return collapse, improve

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
    TunableConfig`) arms runtime-tunable serving.

    ``resident`` caps how many replicas hold device state at once: the
    plane shrinks to ``resident`` slots and the other machines live as
    host snapshots, activated when traffic, serving or analysis reaches
    them. None keeps every replica resident; ``"auto"`` sizes the plane
    from an EWMA of the per-round active set and re-partitions in
    ``tick`` when it crosses the grow/shrink bands (trajectories do not
    change). Residency needs scalar ``s``/``T``. ``batched_moves`` (with
    residency) defers spills (an index gather into pinned host memory,
    awaited by event where the snapshot is read) and lands activations by
    a mask-select before the enqueue; False takes the synchronous
    gather/scatter moves, bitwise the same. ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`) shards the replica axis in
    slabs over its ``data`` axis; anything else raises a ``TypeError``.
    """

    replicas: int = 1
    buffer_capacity: int = 64
    chunk: int = 16                   # datapoints drained per chunk
    ingress_block: int = 32           # staged rows per replica per flush
    packed: bool = False
    history_limit: Optional[int] = None
    resident: Union[int, None, str] = None
    batched_moves: bool = True
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


class TMService:
    """K concurrent Fig-3 machines behind one control surface (K >= 1).

    ``state`` is a single machine's :class:`TMState` (copied to K
    identical banks) or one with a leading replica axis of K. ``rt``
    overrides the runtime built from ``sc.s``/``sc.T``. ``eval_x``/
    ``eval_y`` are the accuracy-analysis set; without them ``tick`` drains
    but never analyzes. ``device`` defaults to the card (under a mesh,
    to its first slab's device); host-facing reads gather there.
    """

    def __init__(self, cfg: TMConfig, state: TMState,
                 sc: Optional[ServiceConfig] = None, *,
                 rt: Optional[TMRuntime] = None, eval_x=None, eval_y=None,
                 device=None):
        sc = sc or ServiceConfig()
        if sc.mesh is not None and not isinstance(sc.mesh, Mesh):
            raise TypeError(f"ServiceConfig.mesh must be a repro_torch Mesh, "
                            f"got {type(sc.mesh).__name__}")
        if sc.history_limit is not None and sc.history_limit < 1:
            raise ValueError("history_limit must be >= 1 (or None)")
        K = sc.replicas
        ta = state.ta_state
        if ta.ndim == 4 and ta.shape[0] != K:
            raise ValueError(
                f"state carries {ta.shape[0]} replicas, expected {K}")
        auto = sc.resident == "auto"
        if isinstance(sc.resident, str) and not auto:
            raise ValueError(f"resident must be an int, None or 'auto', "
                             f"got {sc.resident!r}")
        if not auto and sc.resident is not None and sc.resident < 1:
            raise ValueError("resident must be >= 1 (or None, or 'auto')")
        # auto plane widths round up to the mesh's device count, so the
        # plane shards evenly
        granule = 1 if sc.mesh is None else int(sc.mesh.devices.size)
        if auto:
            # a quarter of the fleet: small enough that sparse traffic
            # shrinks within one band, big enough that dense traffic grows
            # without thrashing first
            P, residency = max(1, -(-K // 4)), True
            P = min(K, -(-P // granule) * granule)
        else:
            residency = sc.resident is not None and sc.resident < K
            # P: the device plane's length, R slots under residency, else K
            P = int(sc.resident) if residency else K
        if device is None and sc.mesh is not None:
            device = shard_mod.slab_devices(sc.mesh)[0]
        dev = tm_mod.resolve_device(device)

        self.cfg = cfg
        self.sc = sc
        self.device = dev
        self.mesh = sc.mesh
        self._granule = granule
        self._slabs: list = []
        self._eval: tuple = (None, None)
        self.rt = rt if rt is not None else sc.runtime(cfg, dev)
        self.n_replicas = K
        self.n_resident = P
        self.chunk = max(1, min(sc.chunk, sc.buffer_capacity))
        self.policy = sc.policy
        scalar_ports = (torch.as_tensor(self.rt.s).ndim == 0
                        and torch.as_tensor(self.rt.T).ndim == 0)
        if residency and not scalar_ports:
            raise ValueError(
                "residency (resident < replicas) requires scalar s/T "
                "runtime ports: a slot's hyperparameters must not change "
                "with the replica occupying it")
        # Packed services hold the eval set as words, so every analysis
        # rides the packed kernels.
        self.eval_x = None if eval_x is None else self._ingest(eval_x)
        self.eval_y = None if eval_y is None else self._labels(eval_y)
        # K = 1 with scalar ports keeps the single-machine bodies; under a
        # mesh the replicated body runs, as in the reference.
        self._k1 = K == 1 and scalar_ports and self.mesh is None

        seed = sc.seed
        if isinstance(seed, (int, np.integer)):
            keys = rnd.fold_in(rnd.PRNGKey(int(seed), dev), np.arange(K))
        else:
            if len(seed) != K:
                raise ValueError(f"need {K} seeds, got {len(seed)}")
            keys = torch.stack([rnd.PRNGKey(int(s), dev) for s in seed])

        ta = ta.to(dev)
        bank = ta[:P] if ta.ndim == 4 else ta.expand((P,) + ta.shape)
        buf1 = buf_mod.make(sc.buffer_capacity, cfg.n_features, dev,
                            packed=sc.packed)
        self._place_plane(SessionState(
            tm=TMState(ta_state=bank.contiguous()),
            buf=buf_mod.stack(buf1, P),
            step=torch.zeros((P,), dtype=torch.int32, device=dev),
        ), keys[:P])
        # Residency: replicas 0..P-1 start in the slots; the rest are host
        # snapshots sharing the initial bank and empty ring (snapshots are
        # never written in place, so sharing is safe).
        self._res: Optional[res_mod.ResidencyMap] = None
        self._best_host: Optional[np.ndarray] = None   # [K, C, J, L] banks
        self._auto = auto
        self._batched = residency and sc.batched_moves
        self.repartitions = 0
        # Deferred spills: (issued gather, rids) pairs whose host copies
        # are not yet awaited. Settled before any full-plane read, store
        # access or activation of a pending replica.
        self._pending_spills: list = []
        self._pending_rids: set = set()
        if residency:
            self._res = res_mod.ResidencyMap(K, P)
            self._res.assign(np.arange(P), np.arange(P))
            keys_host = _host(keys)
            buf_host = T.map(_host, buf1)
            banks_host = _host(ta)
            for rid in range(P, K):
                self._res.store[rid] = (
                    SessionState(
                        tm=TMState(banks_host[rid] if ta.ndim == 4
                                   else banks_host),
                        buf=buf_host, step=np.int32(0)),
                    keys_host[rid])
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
        # Clause rankings live on the host per replica ([K, ...]), so
        # eviction never touches them.
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

    # -- the plane's slabs ------------------------------------------------------

    def _place_plane(self, ss: SessionState, keys: torch.Tensor) -> None:
        """Lay a plane ([P, ...] leaves, on any device) out as slabs: the
        mesh's (:func:`~repro_torch.distributed.sharding.
        replica_shardings` over P), or one slab on the service's device."""
        P = keys.shape[0]
        self._slabs = [
            _Slab(sl.device, sl.lo, sl.hi, *sl.tree)
            for sl in shard_mod.put_slabs((ss, keys), self.mesh, P,
                                          self.device)]
        self._slab_rt()
        self._slab_eval()

    @property
    def rt(self) -> TMRuntime:
        """The runtime ([K] or scalar s/T ports); setting it re-derives
        every slab's."""
        return self._rt

    @rt.setter
    def rt(self, value: TMRuntime) -> None:
        self._rt = value
        self._slab_rt()

    def _slab_rt(self) -> None:
        for sl in self._slabs:
            sl.rt = (self._rt if self.mesh is None else
                     online_mod.slab_runtime(self._rt, sl.lo, sl.hi, sl.dev))

    @property
    def eval_x(self) -> Optional[torch.Tensor]:
        """The analysis rows (words on a packed service); setting them or
        ``eval_y`` puts a copy on every slab's device."""
        return self._eval[0]

    @eval_x.setter
    def eval_x(self, value) -> None:
        self._eval = (value, self._eval[1])
        self._slab_eval()

    @property
    def eval_y(self) -> Optional[torch.Tensor]:
        return self._eval[1]

    @eval_y.setter
    def eval_y(self, value) -> None:
        self._eval = (self._eval[0], value)
        self._slab_eval()

    def _slab_eval(self) -> None:
        for sl in self._slabs:
            sl.eval_x, sl.eval_y = (None if t is None else t.to(sl.dev)
                                    for t in self._eval)

    def _split(self, value, field: str) -> None:
        if len(self._slabs) == 1:
            sl = self._slabs[0]
            setattr(sl, field, T.map(lambda a: a.to(sl.dev), value))
            return
        for sl in self._slabs:
            setattr(sl, field, T.map(
                lambda a, _s=sl: a[_s.lo:_s.hi].to(_s.dev), value))

    def _joined(self, field: str):
        if len(self._slabs) == 1:
            return getattr(self._slabs[0], field)
        return T.map(lambda *xs: torch.cat([x.to(self.device) for x in xs]),
                     *[getattr(sl, field) for sl in self._slabs])

    @property
    def _ss(self) -> SessionState:
        """The whole plane's state: the slab's own tensors without a mesh,
        a copy gathered on the service's device under one. Writing it
        splits the value into the slabs."""
        return self._joined("ss")

    @_ss.setter
    def _ss(self, value: SessionState) -> None:
        self._split(value, "ss")

    @property
    def _keys(self) -> torch.Tensor:
        """The whole plane's RNG keys [P, 2] (gathered under a mesh)."""
        return self._joined("keys")

    @_keys.setter
    def _keys(self, value: torch.Tensor) -> None:
        self._split(value, "keys")

    def _plane_host(self):
        """(state, keys) of the whole plane as host numpy, slab by slab."""
        parts = [T.map(_host, (sl.ss, sl.keys)) for sl in self._slabs]
        if len(parts) == 1:
            return parts[0]
        return T.map(lambda *xs: np.concatenate(xs), *parts)

    def _slot_groups(self, slots) -> list:
        """(slab, positions in ``slots``, rows local to the slab) for every
        slab that holds some of the given plane rows, in slab order."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        out = []
        for sl in self._slabs:
            pos = np.nonzero((slots >= sl.lo) & (slots < sl.hi))[0]
            if len(pos):
                out.append((sl, pos, slots[pos] - sl.lo))
        return out

    def _enqueue_plane(self, xs, ys, counts) -> np.ndarray:
        """Push a plane-indexed [P, B] staging block into the rings, slab
        by slab; [P] accepted rows on the host, read once every slab's
        enqueue is queued."""
        acc = []
        for sl in self._slabs:
            lo, hi = sl.lo, sl.hi
            buf, a = router_mod._enqueue_rows(sl.ss.buf, xs[lo:hi],
                                              ys[lo:hi], counts[lo:hi])
            sl.ss = sl.ss._replace(buf=buf)
            acc.append(a)
        return np.concatenate([_host(a) for a in acc]).astype(np.int64)

    # -- device state ---------------------------------------------------------

    @property
    def ss(self) -> SessionState:
        """Device state ([K, ...] leaves), staged ingress flushed first.
        Under residency, the assembled full-K logical fleet (slots in
        replica order, spilled snapshots filled in) on the device: a
        read-only copy; save/restore or evict/activate move state. Under a
        mesh, the slabs gathered on the service's device (a copy)."""
        with self._device_lock:
            self.flush()
            if self._res is None:
                return self._ss
            ss_K, _ = self._assemble_plane()
            return T.map(
                lambda a: torch.from_numpy(a).to(self.device), ss_K)

    @ss.setter
    def ss(self, value: SessionState):
        """Replace the device state wholesale; the occupancy mirror follows
        its rings."""
        with self._device_lock:
            if self._res is not None:
                raise ValueError(
                    "a residency service's device plane cannot be swapped "
                    "wholesale; use restore() for bulk state")
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

    def _assemble_plane(self) -> tuple[SessionState, np.ndarray]:
        """The full-K logical (state, keys) as host numpy in the port's
        dtypes: slots gathered into replica order, spilled snapshots
        filled in."""
        self._settle_spills()
        host = self._plane_host()
        if self._res is None:
            return host
        K = self.n_replicas
        m = self._res.replica_of >= 0
        rids = self._res.replica_of[m]

        def fill(leaf):
            out = np.zeros((K,) + leaf.shape[1:], leaf.dtype)
            out[rids] = leaf[m]
            return out

        outs = T.map(fill, host)
        flat = T.leaves(outs)
        for rid, snap in self._res.store.items():
            for o, leaf in zip(flat, T.leaves(snap)):
                o[rid] = leaf
        return outs

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
        staged block (per cohort of at most ``resident`` hot lanes under
        residency). Returns [K] rows landed; rows a ring rejects despite
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
                landed += (self._flush_block(*block) if self._res is None
                           else self._flush_block_residency(*block))

    def _flush_block(self, xs, ys, counts) -> np.ndarray:
        """One taken [K, B] staging block -> one enqueue a slab."""
        acc = self._enqueue_plane(xs, ys, counts)
        with self.router.lock:
            self._dev_size -= counts - acc
            self.router.dropped += counts - acc
        return acc

    def _flush_block_residency(self, xs, ys, counts) -> np.ndarray:
        """One taken [K, B] block under residency: the hot lanes land
        cohort by cohort through :meth:`_enqueue_lanes`."""
        lanes = np.nonzero(np.asarray(counts) > 0)[0]
        return self._enqueue_lanes(lanes, xs[lanes], ys[lanes],
                                   counts[lanes])

    def _enqueue_lanes(self, lanes, xs_l, ys_l, cnt_l) -> np.ndarray:
        """Land the given lanes' staged rows (lane-indexed [n, B, ...]) in
        their replicas' rings, in cohorts of at most ``resident``. Returns
        [K] rows landed (mirror and drop accounting per cohort)."""
        K, R = self.n_replicas, self.n_resident
        landed = np.zeros(K, dtype=np.int64)
        enqueue = (self._enqueue_cohort_batched if self._batched
                   else self._enqueue_cohort_sync)
        for i in range(0, len(lanes), R):
            sl = slice(i, i + R)
            cohort = lanes[sl]
            acc = enqueue(cohort, xs_l[sl], ys_l[sl], cnt_l[sl])
            rej = np.asarray(cnt_l[sl], dtype=np.int64) - acc
            with self.router.lock:
                self._dev_size[cohort] -= rej
                self.router.dropped[cohort] += rej
            landed[cohort] += acc
        return landed

    def _slot_block(self, slots, xs_c, ys_c, cnt_c):
        """A cohort's lane rows scattered to a slot-indexed [R, B] block."""
        R = self.n_resident
        xs_p = np.zeros((R,) + xs_c.shape[1:], dtype=xs_c.dtype)
        ys_p = np.zeros((R,) + ys_c.shape[1:], dtype=ys_c.dtype)
        cnt_p = np.zeros((R,), dtype=cnt_c.dtype)
        xs_p[slots] = xs_c
        ys_p[slots] = ys_c
        cnt_p[slots] = cnt_c
        return xs_p, ys_p, cnt_p

    def _enqueue_cohort_sync(self, cohort, xs_c, ys_c, cnt_c) -> np.ndarray:
        """The synchronous cohort: blocking activation (gather, scatter),
        then a separate enqueue. The oracle the batched path is held to."""
        slots = self._ensure_resident(cohort)
        return self._enqueue_plane(
            *self._slot_block(slots, xs_c, ys_c, cnt_c))[slots]

    def _enqueue_cohort_batched(self, cohort, xs_c, ys_c,
                                cnt_c) -> np.ndarray:
        """The batched cohort: prepare the slots (victims' gathers issued,
        not awaited; the activation snapshots in one slot-indexed pinned
        plane), then the activation and the enqueue on one stream. The
        pending spills settle once both are queued."""
        slots, act = self._prepare_slots(cohort)
        xs_p, ys_p, cnt_p = self._slot_block(slots, xs_c, ys_c, cnt_c)
        if act is None:
            accepted = self._enqueue_plane(xs_p, ys_p, cnt_p)
        else:
            act_mask, (act_ss, act_keys) = act
            acc = []
            for sl in self._slabs:
                r = slice(sl.lo, sl.hi)
                sl.ss, sl.keys, a = _activate_enqueue_rows(
                    sl.ss, sl.keys, act_mask[r], T.map(lambda x: x[r],
                                                       act_ss),
                    act_keys[r], xs_p[r], ys_p[r], cnt_p[r])
                acc.append(a)
            accepted = np.concatenate([_host(a) for a in acc])
        self._settle_spills()
        return accepted.astype(np.int64)[slots]

    # -- residency ----------------------------------------------------------

    @property
    def resident(self) -> np.ndarray:
        """[K] bool: replicas holding device state now (all True without a
        residency layer)."""
        if self._res is None:
            return np.ones(self.n_replicas, dtype=bool)
        return self._res.resident_mask.copy()

    def _check_cohort(self, rids) -> np.ndarray:
        rids = np.asarray(rids, dtype=np.int64).reshape(-1)
        if len(rids) > self.n_resident:
            raise ValueError(
                f"cohort of {len(rids)} replicas exceeds the "
                f"{self.n_resident} device slots")
        if len(np.unique(rids)) != len(rids):
            raise ValueError("duplicate replicas in a residency cohort")
        return rids

    def _ensure_resident(self, rids) -> np.ndarray:
        """Device slots for the named replicas, activating evicted ones
        (spilling the least recently used residents to make room).
        Callers hold the device lock; a cohort is at most ``n_resident``
        distinct replicas."""
        if not self._batched:
            return self._ensure_resident_sync(rids)
        slots, act = self._prepare_slots(rids)
        if act is not None:
            act_mask, act_plane = act
            for sl in self._slabs:
                r = slice(sl.lo, sl.hi)
                if act_mask[r].any():
                    sl.ss, sl.keys = online_mod.activate_replicas(
                        (sl.ss, sl.keys), T.map(lambda x: x[r], act_plane),
                        act_mask[r])
        return slots

    def _ensure_resident_sync(self, rids) -> np.ndarray:
        """The synchronous residency body (``batched_moves=False``):
        blocking gather on spill, index scatter on activate."""
        res = self._res
        rids = self._check_cohort(rids)
        need = rids[res.slot_of[rids] < 0]
        if len(need):
            take = list(res.free_slots()[:len(need)])
            short = len(need) - len(take)
            if short > 0:
                pinned = res.slot_of[rids]
                victims = res.lru_victims(short, pinned[pinned >= 0])
                self._spill(victims)
                take += list(victims)
            self._activate(need, np.asarray(take[:len(need)],
                                            dtype=np.int64))
        slots = res.slot_of[rids]
        res.touch(slots)
        return slots

    def _prepare_slots(self, rids):
        """Slots for the named cohort, with the activation built but not
        landed: the victims' gathers issued (not awaited), and the evicted
        members' snapshots written into one slot-indexed [R, ...] host
        plane (pinned on a card; rows outside the mask unwritten) with an
        activation mask. Returns (slots [n], None | (act_mask [R],
        (act_ss_plane, act_keys_plane)))."""
        res = self._res
        R = self.n_resident
        rids = self._check_cohort(rids)
        need = rids[res.slot_of[rids] < 0]
        if len(need) == 0:
            slots = res.slot_of[rids]
            res.touch(slots)
            return slots, None
        take = list(res.free_slots()[:len(need)])
        short = len(need) - len(take)
        if short > 0:
            pinned = res.slot_of[rids]
            victims = res.lru_victims(short, pinned[pinned >= 0])
            self._spill_issue(victims)
            take += list(victims)
        take = np.asarray(take[:len(need)], dtype=np.int64)
        # A replica whose spill is still in flight has its bits only in
        # the pending host copies until a settle writes the store.
        if self._pending_rids.intersection(int(r) for r in need):
            self._settle_spills()
        snaps = [res.store.pop(int(r)) for r in need]
        pin = self.device.type == "cuda"

        def to_plane(*leaves):
            first = np.asarray(leaves[0])
            out = torch.empty((R,) + first.shape,
                              dtype=torch.from_numpy(first[None]).dtype,
                              pin_memory=pin)
            view = out.numpy()
            for slot, leaf in zip(take, leaves):
                view[slot] = leaf
            return out

        act_plane = T.map(to_plane, *snaps)
        act_mask = np.zeros(R, dtype=bool)
        act_mask[take] = True
        res.assign(need, take)
        slots = res.slot_of[rids]
        res.touch(slots)
        return slots, (act_mask, act_plane)

    def _spill_issue(self, slots) -> None:
        """Issue the device -> host gather of the replicas in the given
        slots without awaiting it: the gathered rows are new device
        tensors copying into pinned host memory, settled at the next
        settle point."""
        for sl, pos, local in self._slot_groups(slots):
            pending = online_mod.gather_replicas_issue((sl.ss, sl.keys),
                                                       local)
            rids = self._res.release(np.asarray(slots)[pos])
            self._pending_spills.append((pending, rids))
            self._pending_rids.update(int(r) for r in rids)

    def _settle_spills(self) -> None:
        """Await every pending spill (its event) and write the snapshots
        into the host store. A no-op when nothing is pending; every
        full-plane read, store access and activation of a pending replica
        settles first. Each snapshot is copied out of the cohort's pinned
        batch into pageable memory, so the store pins nothing: page-locked
        host memory stays bounded by the moves in flight, not by the
        store's size."""
        if not self._pending_spills:
            return
        pending, self._pending_spills = self._pending_spills, []
        self._pending_rids.clear()
        for gather, rids in pending:
            host = online_mod.gather_replicas_await(gather)
            for j, rid in enumerate(rids):
                self._res.store[int(rid)] = T.map(
                    lambda a, _j=j: a[_j].copy(), host)

    def _spill(self, slots) -> None:
        """Evict the replicas in the given slots: a blocking gather, whole
        per-machine snapshots into the store."""
        for sl, pos, local in self._slot_groups(slots):
            vals = online_mod.gather_replicas((sl.ss, sl.keys), local)
            rids = self._res.release(np.asarray(slots)[pos])
            for j, rid in enumerate(rids):
                self._res.store[int(rid)] = T.map(
                    lambda a, _j=j: a[_j].copy(), vals)

    def _activate(self, rids, slots) -> None:
        """Load the named (evicted) replicas' snapshots into free slots:
        one host -> device scatter a cohort."""
        snaps = [self._res.store.pop(int(r)) for r in rids]
        vals = T.map(lambda *xs: np.stack(xs), *snaps)
        for sl, pos, local in self._slot_groups(slots):
            sl.ss, sl.keys = online_mod.scatter_replicas(
                (sl.ss, sl.keys), local, T.map(lambda a: a[pos], vals))
        self._res.assign(np.asarray(rids, dtype=np.int64), slots)

    def evict(self, replicas) -> None:
        """Spill the named replicas to the host store. Their staged
        ingress lands first, scoped to their lanes
        (:meth:`BatchRouter.take_lanes`): other lanes' staged rows stay
        staged. A later submit, serve or analysis reaching an evicted
        member activates it again."""
        with self._device_lock:
            if self._res is None:
                raise ValueError(
                    "service has no residency layer (resident is None)")
            rids = np.unique(np.asarray(replicas, dtype=np.int64).reshape(-1))
            with self.router.lock:
                taken = self.router.take_lanes(rids)
                if taken is not None:
                    # taken rows are in flight: credit the mirror at the
                    # take, debit rejects after the enqueue
                    self._dev_size[rids] += taken[2]
            if taken is not None:
                xs_l, ys_l, cnt_l = taken
                hot = np.nonzero(cnt_l > 0)[0]
                self._enqueue_lanes(rids[hot], xs_l[hot], ys_l[hot],
                                    cnt_l[hot])
            slots = self._res.slot_of[rids]
            slots = np.unique(slots[slots >= 0])
            if self._batched:
                # an explicit evict wants the snapshots in the store now
                self._spill_issue(slots)
                self._settle_spills()
            else:
                self._spill(slots)

    def activate(self, replicas) -> np.ndarray:
        """Make the named replicas device-resident (at most ``resident``
        of them); returns their slots."""
        with self._device_lock:
            if self._res is None:
                raise ValueError(
                    "service has no residency layer (resident is None)")
            return self._ensure_resident(replicas)

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
        plane per chunk. ``on_chunk`` receives each chunk's
        :class:`ChunkAux` with a leading plane axis ``[P, chunk]``;
        without it the monitoring pass does not run.

        Under residency the drain sweeps every replica that holds rows and
        budget, in cohorts of at most ``resident``. A replica with budget
        but no rows is skipped and its key does not split, so an
        always-resident twin is driven with budgets masked by
        ``buffered > 0``.
        """
        K = self.n_replicas
        budget = np.broadcast_to(np.asarray(max_points, dtype=np.int64),
                                 (K,)).copy()
        with self._device_lock:
            self.flush()
            if self._res is None:
                return (self._drain_k1(budget, on_chunk) if self._k1
                        else self._drain_replicated(budget, on_chunk))
            trained = np.zeros(K, dtype=np.int64)
            with self.router.lock:
                has_rows = self._dev_size > 0
            todo = np.nonzero(has_rows & (budget > 0))[0]
            # the active set's size is the autotune signal
            self._res.note_active(len(todo))
            R = self.n_resident
            for i in range(0, len(todo), R):
                cohort = todo[i:i + R]
                slots = self._ensure_resident(cohort)
                budget_p = np.zeros(R, dtype=np.int64)
                budget_p[slots] = budget[cohort]
                trained_p = self._drain_replicated(budget_p, on_chunk)
                trained[cohort] = trained_p[slots]
            self._settle_spills()
            return trained

    def _drain_replicated(self, budget: np.ndarray, on_chunk) -> np.ndarray:
        """Chunk by chunk, every slab of the plane per chunk: the ring
        sizes of all slabs are read with one wait, then each slab's chunk
        is queued on its device (a slab loops to its own largest count;
        the masked steps past a replica's count leave it untouched)."""
        P = len(budget)   # the plane's length (slots, not the fleet's K)
        trained = np.zeros(P, dtype=np.int64)
        active = trained < budget
        monitor = on_chunk is not None
        while active.any():
            want = np.where(active, np.minimum(self.chunk, budget - trained),
                            0)
            size = (None if len(self._slabs) == 1 else
                    online_mod.read_sizes([sl.ss.buf for sl in self._slabs]))
            n, auxes = np.zeros(P, dtype=np.int64), []
            for sl in self._slabs:
                r = slice(sl.lo, sl.hi)
                with shard_mod.on(sl.dev):
                    sl.keys, chunk_keys = _advance_keys(sl.keys, active[r])
                    sl.ss, n[r], aux = online_mod._consume_many_replicated(
                        self.cfg, self.chunk, sl.ss, sl.rt, want[r],
                        chunk_keys, monitor=monitor,
                        size=None if size is None else size[r])
                auxes.append(aux)
            aux = self._join_aux(auxes) if monitor else None
            trained += n
            # commit the mirror before the callback, so a callback that
            # raises cannot desync it from the device
            with self.router.lock:
                self._debit_mirror(n)
            if monitor and n.any():
                on_chunk(aux)
            active &= (n == want) & (trained < budget)
        return trained

    def _join_aux(self, auxes: list) -> ChunkAux:
        """The slabs' chunk aux as one [P, k] plane (on the service's
        device under a mesh)."""
        if len(auxes) == 1:
            return auxes[0]
        return ChunkAux(*(torch.cat([a.to(self.device) for a in leaves])
                          for leaves in zip(*auxes)))

    def _debit_mirror(self, n_plane: np.ndarray) -> None:
        """Rows consumed per plane row off the [K] mirror (slots map to
        their replicas under residency). Callers hold the router lock."""
        if self._res is None:
            self._dev_size -= n_plane
        else:
            m = self._res.replica_of >= 0
            np.subtract.at(self._dev_size, self._res.replica_of[m],
                           n_plane[m])

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

        A residency service holds only ``resident`` machines on the
        device: :meth:`serve_replicas` names the members a request
        targets.
        """
        xs = self._ingest(xs)
        with self._device_lock:
            if self._res is not None:
                raise ValueError(
                    "TMService.serve needs the whole fleet device-resident, "
                    f"but ServiceConfig(resident={self.sc.resident}) < "
                    f"replicas={self.n_replicas} spills part of it: use "
                    "serve_replicas(replicas, xs) to serve named members "
                    "(activated on demand), or raise the 'resident' knob to "
                    "cover the fleet")
            if not self._tunable(budget):
                if return_aux:
                    raise ValueError(
                        "return_aux reports the budgeted path's compute: "
                        "pass a budget (or configure an active tunable)")
                if xs.ndim == 2 and self._k1:
                    preds = tm_mod.predict_batch(
                        self.cfg, TMState(self._ss.tm.ta_state[0]), self.rt,
                        xs)
                    return preds.cpu().numpy()[None]
                if xs.ndim == 2:
                    xs = xs[None]
                outs = []
                for sl in self._slabs:
                    x = xs if xs.shape[0] == 1 else xs[sl.lo:sl.hi]
                    with shard_mod.on(sl.dev):
                        outs.append(tm_mod.predict_batch_replicated(
                            self.cfg, sl.ss.tm, sl.rt, x.to(sl.dev)))
                return np.concatenate([_host(o) for o in outs])
            tuner = self._require_tuner()
            w = tuner.weights
            preds, aux = self._serve_tunable([
                (sl, sl.ss.tm,
                 xs if xs.ndim == 2 else xs[sl.lo:sl.hi],
                 tuner.order[sl.lo:sl.hi],
                 None if w is None else w[sl.lo:sl.hi])
                for sl in self._slabs], budget)
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

    def _serve_tunable(self, parts: list, budget
                       ) -> tuple[np.ndarray, tun_mod.ServeAux]:
        """The budgeted serve body, once per part: ``parts`` holds (slab,
        bank plane on the slab's device, xs, order, weights) with the
        plane's rows aligned with ``order``/``weights``. Returns the
        parts' predictions and aux concatenated in order."""
        tc = self.sc.tunable
        b = self.tuner.budget if budget is None else float(budget)
        m = tun_mod.m_for_budget(b, self.cfg.max_clauses)
        preds, evaluated, sel = [], [], []
        for sl, tm_plane, xs, order, weights in parts:
            if xs.ndim == 2:
                xs = xs[None]     # D = 1: one shared stream
            with shard_mod.on(sl.dev):
                p, e = tun_mod.predict_pruned_replicated_host(
                    self.cfg, tm_plane, sl.rt, xs.to(sl.dev), order,
                    weights, m, group=tc.group if tc.early_exit else None)
            preds.append(p)
            evaluated.append(e)
            sel.append(order[:, :, :m])
        aux = tun_mod.ServeAux(budget=b, m=m, sel=np.concatenate(sel),
                               evaluated=np.concatenate(evaluated))
        return np.concatenate(preds), aux

    @staticmethod
    def _rows(sl: _Slab, local) -> TMState:
        """The banks in the given rows of one slab, gathered into one
        plane on its device."""
        idx = torch.from_numpy(np.asarray(local, dtype=np.int64))
        return TMState(sl.ss.tm.ta_state[idx.to(sl.dev)])

    def serve_replicas(self, replicas, xs, *, budget=None,
                       return_aux: bool = False):
        """Inference for the named replicas only: [n, B] i32. ``xs`` is
        [B, f] (one batch for all named members) or [n, B, f] (one each).
        The named members' banks are gathered into one plane a cohort of
        at most ``resident`` (evicted members activate, spilling the least
        recently used) and served in one contraction, bit for bit an
        always-resident fleet's; each serves from its own calibrated
        ranking on the budgeted path. ``budget``/``return_aux`` as in
        :meth:`serve`.
        """
        xs = self._ingest(xs)
        rids = np.asarray(replicas, dtype=np.int64).reshape(-1)
        if rids.size == 0 or rids.min() < 0 or rids.max() >= self.n_replicas:
            raise ValueError(f"replica ids must name members of "
                             f"[0, {self.n_replicas}), got {rids.tolist()}")
        shared = xs.ndim == 2
        cap = self.n_resident
        tunable = self._tunable(budget)
        if return_aux and not tunable:
            raise ValueError(
                "return_aux reports the budgeted path's compute: pass a "
                "budget (or configure an active tunable)")
        tuner = self._require_tuner() if tunable else None
        outs, auxes = [], []
        with self._device_lock:
            for i in range(0, len(rids), cap):
                cohort = rids[i:i + cap]
                slots = (cohort if self._res is None
                         else self._ensure_resident(cohort))
                groups = self._slot_groups(slots)
                xs_c = xs[None] if shared else xs[i:i + cap]
                # the cohort's rows in slab order; put back in cohort order
                back = np.argsort(np.concatenate([g[1] for g in groups]))
                if not tunable:
                    preds = []
                    for sl, pos, local in groups:
                        x = (xs_c if shared or len(groups) == 1
                             else xs_c[torch.from_numpy(pos)])
                        with shard_mod.on(sl.dev):
                            preds.append(tm_mod.predict_batch_replicated(
                                self.cfg, self._rows(sl, local),
                                sl.rt, x.to(sl.dev)))
                    outs.append(np.concatenate(
                        [_host(p) for p in preds])[back])
                    continue
                w = tuner.weights
                preds, aux = self._serve_tunable([
                    (sl, self._rows(sl, local),
                     (xs_c if shared or len(groups) == 1
                      else xs_c[torch.from_numpy(pos)]),
                     tuner.order[cohort[pos]],
                     None if w is None else w[cohort[pos]])
                    for sl, pos, local in groups], budget)
                outs.append(preds[back])
                auxes.append(aux._replace(sel=aux.sel[back],
                                          evaluated=aux.evaluated[back]))
        preds = np.concatenate(outs, axis=0)
        if not return_aux:
            return preds
        aux = tun_mod.ServeAux(
            budget=auxes[0].budget, m=auxes[0].m,
            sel=np.concatenate([a.sel for a in auxes], axis=0),
            evaluated=np.concatenate([a.evaluated for a in auxes], axis=0))
        return preds, aux

    def calibrate(self, xs=None, ys=None) -> np.ndarray:
        """Rank every replica's clauses on a calibration set (default: the
        eval set), polarity-balanced, and derive integer vote weights when
        the tunable config asks for them. Returns the [K, C, J] i32 score
        plane. Under residency the fleet calibrates in cohorts of at most
        ``resident`` (evicted members activate); ranks land on the host per
        replica either way. Calibrate again when the banks have drifted;
        serving in between uses the older ranks."""
        if self.tuner is None:
            raise ValueError(
                "calibrate needs ServiceConfig(tunable=TunableConfig(...))")
        xs = self.eval_x if xs is None else self._ingest(xs)
        ys = self.eval_y if ys is None else self._labels(ys)
        if xs is None or ys is None:
            raise ValueError(
                "calibrate needs a labelled set: pass (xs, ys) or build the "
                "service with eval_x/eval_y")
        K = self.n_replicas

        def plane_scores(sl, tm):
            with shard_mod.on(sl.dev):
                return tun_mod.clause_scores_replicated(
                    self.cfg, tm, sl.rt, xs[None].to(sl.dev),
                    ys[None].to(sl.dev))

        with self._device_lock:
            if self._res is not None:
                scores = np.zeros((K, self.cfg.max_classes,
                                   self.cfg.max_clauses), dtype=np.int32)
                for i in range(0, K, self.n_resident):
                    cohort = np.arange(i, min(i + self.n_resident, K))
                    slots = self._ensure_resident(cohort)
                    for sl, pos, local in self._slot_groups(slots):
                        scores[cohort[pos]] = _host(
                            plane_scores(sl, self._rows(sl, local)))
            elif self._k1:
                scores = _host(tun_mod.clause_scores(
                    self.cfg, TMState(self._ss.tm.ta_state[0]), self.rt, xs,
                    ys)[None])
            else:
                parts = [plane_scores(sl, sl.ss.tm) for sl in self._slabs]
                scores = np.concatenate([_host(p) for p in parts])
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
        appends to ``history``. Under residency only resident members
        measure; evicted ones read nan (``activate`` them first; the
        policy loop does that for its due members)."""
        if self.eval_x is None:
            raise ValueError("TMService built without an eval set")
        with self._device_lock:
            acc = self._measure()
            self._record(acc)
            return acc

    def _record(self, acc: np.ndarray) -> None:
        self.history.append((self.steps, acc))
        if self.sc.history_limit is not None:
            del self.history[:-self.sc.history_limit]

    def _measure(self) -> np.ndarray:
        """One eval contraction over the device plane; [K] f32 (nan for
        evicted replicas). No history side effects."""
        if self._k1:
            return np.asarray([float(acc_mod.analyze(
                self.cfg, TMState(self._ss.tm.ta_state[0]), self.rt,
                self.eval_x, self.eval_y))], dtype=np.float32)
        parts = []
        for sl in self._slabs:
            with shard_mod.on(sl.dev):
                parts.append(acc_mod.analyze_replicated(
                    self.cfg, sl.ss.tm, sl.rt,
                    sl.eval_x[None],
                    sl.eval_y[None]))
        acc_p = np.concatenate([_host(a) for a in parts])
        if self._res is None:
            return acc_p
        acc = np.full(self.n_replicas, np.nan, dtype=np.float32)
        m = self._res.replica_of >= 0
        acc[self._res.replica_of[m]] = acc_p[m]
        return acc

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
            if self._res is not None:
                raise ValueError(
                    "offline_train needs the full fleet device-resident; "
                    "train a full-resident service (or a single machine) "
                    "first, then construct the residency service from its "
                    "state")
            if self._k1:
                st = fb_mod.train_epochs(
                    self.cfg, TMState(self._ss.tm.ta_state[0]), self.rt, xs,
                    ys, key, n_epochs)
                self._ss = self._ss._replace(tm=TMState(st.ta_state[None]))
            else:
                for sl in self._slabs:
                    with shard_mod.on(sl.dev):
                        st = fb_mod.train_epochs_replicated(
                            self.cfg, sl.ss.tm, sl.rt,
                            xs[None].to(sl.dev), ys[None].to(sl.dev),
                            key[None].to(sl.dev), n_epochs)
                    sl.ss = sl.ss._replace(tm=st)
            acc = self.analyze()
            self.policy.snapshot(self._ps, acc, self._plane_tm())
            return acc

    def _plane_tm(self):
        """The plane's banks as the policy holds them: one TMState, or one
        per slab under a mesh."""
        if len(self._slabs) == 1:
            return self._slabs[0].ss.tm
        return [sl.ss.tm for sl in self._slabs]

    def _maybe_analyze(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Analysis + the §5.3.2 policy when a member is due. Returns
        (accuracies [K], rolled-back mask [K]) or None."""
        if self.eval_x is None:
            return None
        due = self.policy.due(self._ps)
        if not due.any():
            return None
        if self._res is not None:
            return self._analyze_residency(due)
        acc = self.analyze()
        if len(self._slabs) > 1:
            return acc, self._policy_apply_slabs(due, acc)
        sl = self._slabs[0]
        tm, rolled = self.policy.apply(self._ps, due, acc, sl.ss.tm)
        sl.ss = sl.ss._replace(tm=tm)
        return acc, rolled

    def _policy_apply_slabs(self, due, acc) -> np.ndarray:
        """:meth:`AdaptPolicy.apply` on a sharded plane: the transition on
        the [K] arrays, then each slab's selects on its own device, with
        the known-good banks held per slab."""
        collapse, improve = self.policy.transition(self._ps, due, acc)
        best = self._ps.best_state
        if improve.any() and best is None:
            best = [None] * len(self._slabs)
        for j, sl in enumerate(self._slabs):
            r = slice(sl.lo, sl.hi)
            tm = sl.ss.tm
            if collapse[r].any():
                tm = _select_replicas(collapse[r], best[j], tm)
            if improve.any():
                best[j] = (tm if best[j] is None
                           else _select_replicas(improve[r], tm, best[j]))
            sl.ss = sl.ss._replace(tm=tm)
        self._ps.best_state = best
        return collapse

    def _analyze_residency(self, due) -> tuple[np.ndarray, np.ndarray]:
        """The §5.3.2 transition under residency: measure the due members
        (activating evicted ones a cohort at a time), append one history
        entry, then run the policy with the known-good banks on the host
        (``_best_host``, one [K, ...] array)."""
        acc = self._measure()
        missing = due & np.isnan(acc)
        while missing.any():
            self._ensure_resident(np.nonzero(missing)[0][:self.n_resident])
            fresh = self._measure()
            acc = np.where(np.isnan(acc), fresh, acc).astype(np.float32)
            missing = due & np.isnan(acc)
        self._record(acc)
        return acc, self._policy_apply_residency(due, acc)

    def _policy_apply_residency(self, due, acc) -> np.ndarray:
        """:meth:`AdaptPolicy.transition` on host-side known-good banks: a
        collapse writes the member's bank (its slot or its snapshot), an
        improve copies it into ``_best_host``."""
        collapse, improve = self.policy.transition(self._ps, due, acc)
        for rid in np.nonzero(collapse)[0]:
            self._write_bank(int(rid), self._best_host[rid])
        if improve.any():
            if self._best_host is None:
                ta = self._slabs[0].ss.tm.ta_state
                self._best_host = np.zeros(
                    (self.n_replicas,) + tuple(ta.shape[1:]),
                    dtype=torch.empty(0, dtype=ta.dtype).numpy().dtype)
            for rid in np.nonzero(improve)[0]:
                self._best_host[rid] = self._read_bank(int(rid))
        return collapse

    def _read_bank(self, rid: int) -> np.ndarray:
        self._settle_spills()
        slot = int(self._res.slot_of[rid])
        if slot >= 0:
            (sl, _, local), = self._slot_groups([slot])
            return _host(sl.ss.tm.ta_state[int(local[0])])
        return np.asarray(self._res.store[rid][0].tm.ta_state)

    def _write_bank(self, rid: int, bank) -> None:
        self._settle_spills()
        slot = int(self._res.slot_of[rid])
        if slot >= 0:
            (sl, _, local), = self._slot_groups([slot])
            ta = sl.ss.tm.ta_state
            idx = torch.tensor([int(local[0])], device=ta.device)
            src = torch.from_numpy(np.array(bank)[None]).to(ta.device,
                                                            ta.dtype)
            sl.ss = sl.ss._replace(tm=TMState(ta.index_copy(0, idx, src)))
        else:
            ss_s, key_s = self._res.store[rid]
            self._res.store[rid] = (ss_s._replace(tm=TMState(np.array(bank))),
                                    key_s)

    def tick(self, max_points=None,
             on_chunk: Optional[Callable[[ChunkAux], None]] = None
             ) -> TickReport:
        """One Fig-3 consumer cycle: flush ingress, drain up to
        ``max_points`` (default: one chunk) per replica, advance the
        analysis cadence, re-partition an ``"auto"`` plane when its
        estimate left the bands, and apply the mitigation policy to due
        members."""
        budget = self.chunk if max_points is None else max_points
        with self._device_lock:
            trained = self.drain(budget, on_chunk)
            self._ps.since += trained
            if self._auto:
                target = self._res.autotune_target(granule=self._granule)
                if target != self.n_resident:
                    self._repartition(target)
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
        continue equals never stopping, bit for bit. A residency service
        saves the assembled full-K fleet, so the checkpoint restores under
        any ``resident`` budget. Returns the path."""
        with self._device_lock:
            self.flush()
            ss_K, keys_K = convert.host_plane_to_reference(
                *self._assemble_plane())
            ps = self._ps
            K = self.n_replicas
            if self._res is not None:
                best = (None if self._best_host is None
                        else TMState(self._best_host))
            elif isinstance(ps.best_state, list):
                best = TMState(np.concatenate(
                    [_host(b.ta_state) for b in ps.best_state]))
            else:
                best = convert.to_numpy(ps.best_state)
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
                "ss": ss_K,
                "keys": keys_K,
                "rt": convert.to_numpy(self.rt),
                "policy": {
                    "since": ps.since, "best": ps.best,
                    "rollbacks": ps.rollbacks, "lost": ps.lost,
                    "best_state": best,
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
                "has_best_state": best is not None,
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
        it); the ``resident`` budget may differ. Anything staged or held
        now is discarded: the checkpoint defines the complete state."""
        with self._device_lock:
            # pending spills settle before the install clears the store,
            # so no stale snapshot lands in the fresh one
            self._settle_spills()
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
                lost=np.asarray(pol["lost"], dtype=np.int64))
            self._best_host = None
            if has_best:
                if self._res is not None:
                    self._best_host = np.asarray(pol["best_state"].ta_state)
                else:
                    bs = convert.state_from_numpy(pol["best_state"], dev)
                    self._ps.best_state = (bs if len(self._slabs) == 1 else [
                        TMState(bs.ta_state[sl.lo:sl.hi].to(sl.dev))
                        for sl in self._slabs])
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
            with self.router.lock:
                self.router.dropped[:] = np.asarray(tree["router"]["dropped"])
                self.router.flushes = int(tree["router"]["flushes"])
                self._dev_size = np.asarray(
                    tree["ss"].buf.size, dtype=np.int64).reshape(
                        self.n_replicas).copy()
            self._install_plane(*convert.host_plane_from_reference(
                tree["ss"], tree["keys"]))

    def _check_shapes(self, tree) -> None:
        """A checkpoint whose device state would not fit this service's
        (another TMConfig width, capacity or packing) is rejected. Leaves
        lead with K in the checkpoint and with the plane's length here."""
        saved = ckpt_mod._flatten_with_paths({"ss": tree["ss"],
                                              "keys": tree["keys"]})
        sl = self._slabs[0]
        mine = ckpt_mod._flatten_with_paths({"ss": sl.ss, "keys": sl.keys})
        for k, v in saved.items():
            if tuple(v.shape[1:]) != tuple(mine[k].shape[1:]):
                raise ValueError(
                    f"checkpoint leaf {k} has shape {tuple(v.shape)}, this "
                    f"service holds {tuple(mine[k].shape)}")

    def _install_plane(self, ss_K: SessionState, keys_K: np.ndarray) -> None:
        """Install a full-K logical (state, keys) host tree in the port's
        dtypes. Under residency the fleet partitions afresh: replicas
        0..resident-1 take the slots, the rest are snapshots, which no
        trajectory can see."""
        R = self.n_resident
        host = (ss_K, keys_K)
        self._place_plane(*T.map(
            lambda a: torch.from_numpy(np.array(a[:R])).to(self.device),
            host))
        if self._res is None:
            return
        res = self._res
        res.store.clear()
        res.slot_of[:] = -1
        res.replica_of[:] = -1
        res.last_use[:] = 0
        res.assign(np.arange(R), np.arange(R))
        for rid in range(R, self.n_replicas):
            res.store[rid] = T.map(lambda a, _r=rid: a[_r], host)

    def _repartition(self, new_r: int) -> None:
        """Resize the device plane to ``new_r`` slots (``"auto"``): the
        full-K fleet assembles on the host, a fresh residency map takes
        over at the new width and :meth:`_install_plane` lands it (the
        machinery that migrates checkpoints across budgets), so
        trajectories are bitwise unchanged across re-partitions."""
        ss_K, keys_K = self._assemble_plane()    # settles pending spills
        old = self._res
        self.n_resident = int(new_r)
        res = res_mod.ResidencyMap(self.n_replicas, self.n_resident)
        # lifetime counters and the EWMA survive the resize; the LRU clock
        # and the assignment restart deterministically
        res.activations = old.activations
        res.evictions = old.evictions
        res.ewma_active = old.ewma_active
        self._res = res
        self.repartitions += 1
        self._install_plane(ss_K, keys_K)

    @classmethod
    def restore(cls, directory: str, *, step: Optional[int] = None,
                mesh=None, eval_x=None, eval_y=None,
                resident: Union[int, None, str] = "saved",
                device=None) -> "TMService":
        """Rebuild a service from a :meth:`save` checkpoint of either
        package: construction knobs from the manifest, arrays from the
        npz. The eval set is a runtime resource and is passed fresh.
        ``resident`` defaults to the saved budget and may be overridden
        (to None, an int or "auto"): a checkpoint is residency-agnostic,
        so this migrates a fleet across device budgets. ``mesh`` shards the
        restored plane (``device`` then defaults to its first slab's); a
        checkpoint holds the full-K layout with or without one."""
        if device is None and mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch Mesh, got "
                                f"{type(mesh).__name__}")
            device = shard_mod.slab_devices(mesh)[0]
        man = ckpt_mod.read_manifest(directory, step=step)
        meta = man["extra"]["service"]
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
            resident=meta["resident"] if resident == "saved" else resident,
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
        plane = np.concatenate([_host(sl.ss.step) for sl in self._slabs])
        if self._res is None:
            return plane
        self._settle_spills()
        out = np.zeros(self.n_replicas, dtype=np.int32)
        m = self._res.replica_of >= 0
        out[self._res.replica_of[m]] = plane[m]
        for rid, snap in self._res.store.items():
            out[rid] = snap[0].step
        return out

    @property
    def rng_keys(self) -> np.ndarray:
        """RNG keys as the reference's raw uint32 key data, [K, 2]."""
        if self._res is None:
            return np.concatenate([_host(sl.keys) for sl in self._slabs]
                                  ).astype(np.uint32)
        return self._assemble_plane()[1].astype(np.uint32)

    @property
    def rollbacks(self) -> np.ndarray:
        return self._ps.rollbacks

    @property
    def lost(self) -> np.ndarray:
        return self._ps.lost

    @property
    def since_analysis(self) -> np.ndarray:
        return self._ps.since
