"""Online drain and interleaved learning session (paper §3.5, §4), on torch.

The FPGA's online path: datapoints arrive, pass through the cyclic buffer,
and are consumed by the manager, which interleaves training with
inference. :func:`_consume_many` drains one chunk for one machine: a
serial loop of ``train_update`` (K1 + K8 per point) and, when monitored,
one batch-first inference pass (K2, or K5 for packed rows) over the chunk
under the post-chunk state. :func:`_consume_many_replicated` is the fleet
form: every step advances all R machines in one replica-first plane
(K3 + K9, D = R), and the monitoring is one K4 (or K6) pass.

Packed rings hold ceil(f/32) int32 words a row: each popped row unpacks
once for the elementwise feedback, and the monitoring pass reads the
packed rows as they are. ``OnlineSession`` is the K = 1 shim over
:class:`repro_torch.serve.service.TMService`.

The residency layer moves machines between the device plane and host
snapshots with :func:`gather_replicas_issue` / :func:`gather_replicas_await`
(an index gather, a ``non_blocking`` copy into pinned host memory and an
event, awaited only where the snapshot is read), :func:`gather_replicas`
and :func:`scatter_replicas` (the synchronous pair) and
:func:`activate_replicas` (a per-slot mask-select).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree as T
from repro_torch.core import feedback as fb_mod
from repro_torch.core import tm as tm_mod
from repro_torch.core.tm import TMConfig, TMRuntime, TMState
from repro_torch.data import buffer as buf_mod
from repro_torch.data.memory import DataSource
from repro_torch.kernels import packing


class SessionState(NamedTuple):
    """Device-side state of one machine, or of a fleet: under
    :func:`_consume_many_replicated` every leaf carries a leading K."""

    tm: TMState
    buf: buf_mod.RingBuffer
    step: torch.Tensor  # 0-dim int32: online datapoints consumed


class ChunkAux(NamedTuple):
    """Per-chunk observability from the drain (chunk size k); the fleet
    drain gives the same fields with a leading replica axis [R, k]."""

    predicted: torch.Tensor  # [k] i32: inference under the post-chunk state
    correct: torch.Tensor    # [k] bool: predicted == label, invalid rows False
    valid: torch.Tensor      # [k] bool: rows actually consumed
    activity: torch.Tensor   # [k] f32: per-step TA-update activity


def replica_gate(valid: torch.Tensor):
    """Per-leaf ``where(valid, new, old)`` with valid [R] broadcast over
    each leaf's trailing axes: the replica-masked state update of the
    fleet drain and of the per-replica rollback."""
    def apply(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        v = valid.reshape(valid.shape + (1,) * (new.ndim - valid.ndim))
        return torch.where(v, new, old)
    return apply


# ---------------------------------------------------------------------------
# Replica moves between the device plane and the host (the residency layer)
# ---------------------------------------------------------------------------


def _to_device(v: np.ndarray, device) -> torch.Tensor:
    """A small host array onto ``device`` without waiting for the stream:
    on a card it goes through pinned memory (a pageable copy would first
    synchronise the stream, so an issued move would wait for all the work
    queued before it); the caching host allocator keeps the pinned block
    until the copy's event."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _index(idx, device) -> torch.Tensor:
    return _to_device(np.asarray(idx, dtype=np.int64), device)


def _take_rows(tree, idx: torch.Tensor):
    """Rows ``idx`` of every replica-leading leaf as NEW device tensors
    (an index gather, never a view: the rows cannot change when the plane
    is later written)."""
    return T.map(lambda a: a.index_select(0, idx), tree)


class PendingGather(NamedTuple):
    """An issued device -> host gather: host copies (pinned, on a card)
    and the event that completes them (None on the CPU)."""

    host: Any
    event: Optional[Any]


def gather_replicas_issue(tree, idx) -> PendingGather:
    """The first half of :func:`gather_replicas`: gather the named rows of
    every replica-leading leaf on the device, start their copies into fresh
    pinned host tensors (``non_blocking``, so the host goes on) and record
    an event after them. The gather makes new device tensors, so a later
    write to the plane (in place or not) cannot reach the snapshot; the
    host tensors are read only after :func:`gather_replicas_await`. On CPU
    tensors both halves are plain copies."""
    leaves = T.leaves(tree)
    dev = leaves[0].device
    rows = _take_rows(tree, _index(idx, dev))
    if dev.type != "cuda":
        return PendingGather(rows, None)

    def to_pinned(a):
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        return h

    host = T.map(to_pinned, rows)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return PendingGather(host, event)


def gather_replicas_await(pending: PendingGather):
    """The second half: wait for an issued gather's event, then its rows as
    host numpy (views of the pinned copies)."""
    if pending.event is not None:
        pending.event.synchronize()
    return T.map(lambda a: a.numpy(), pending.host)


def gather_replicas(tree, idx):
    """Rows ``idx`` of every replica-leading leaf as host numpy, a
    blocking copy per leaf: the synchronous spill (``batched_moves=
    False``), kept as the oracle the batched path is held against."""
    leaves = T.leaves(tree)
    i = _index(idx, leaves[0].device)
    return T.map(lambda a: a[i].cpu().numpy(), tree)


def _host_to(v, like: torch.Tensor) -> torch.Tensor:
    """A host leaf (numpy, or a CPU tensor, pinned or not) onto ``like``'s
    device with ``like``'s dtype: bit patterns kept (np.uint32 words land
    as the port's int32 words); pinned tensors copy without blocking."""
    if not torch.is_tensor(v):
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(like.device, non_blocking=v.is_pinned()).to(like.dtype)


def scatter_replicas(tree, idx, values):
    """Write stacked host ``values`` (leading ``len(idx)``) into rows
    ``idx`` of every replica-leading leaf, out of place: the synchronous
    activation. Dtypes are the destination's (int8 banks, packed words and
    bool rows keep their bits)."""
    leaves = T.leaves(tree)
    i = _index(idx, leaves[0].device)
    return T.map(lambda a, v: a.index_copy(0, i, _host_to(v, a)), tree,
                 values)


def activate_replicas(plane, act_plane, mask):
    """Per-slot mask-select activation: slot r takes ``act_plane`` where
    ``mask[r]``, else keeps ``plane``; out of place, one select per leaf.
    ``act_plane`` is SLOT-INDEXED (``[R, ...]`` a leaf; its rows outside
    the mask never reach the result), so there is no index scatter. Host leaves cross
    to the device first (pinned ones without blocking); dtypes are the
    destination's."""
    leaves = T.leaves(plane)
    m = _to_device(np.asarray(mask, dtype=bool), leaves[0].device)
    gate = replica_gate(m)
    return T.map(lambda new, old: gate(_host_to(new, old), old),
                 act_plane, plane)


# ---------------------------------------------------------------------------
# Slabs of a sharded plane (a mesh: rows [lo, hi) of the replica axis on one
# device each; see repro_torch.distributed.sharding)
# ---------------------------------------------------------------------------


def slab_runtime(rt: TMRuntime, lo: int, hi: int, device) -> TMRuntime:
    """``rt`` for the plane rows [lo, hi) on ``device``: [R] s/T ports
    sliced to the slab, 0-dim ports kept, the slices and the shared masks
    on the slab's device (no copy where they are there already)."""
    def port(p):
        p = torch.as_tensor(p)
        return p[lo:hi].to(device) if p.ndim == 1 else p

    return rt._replace(
        s=port(rt.s), T=port(rt.T),
        clause_mask=rt.clause_mask.to(device),
        class_mask=rt.class_mask.to(device),
        ta_and_mask=rt.ta_and_mask.to(device),
        ta_or_mask=rt.ta_or_mask.to(device))


def read_sizes(bufs) -> np.ndarray:
    """The ring sizes of several slabs' buffers as one host int64 array,
    with one wait per device rather than one per slab: on a card each
    slab's sizes copy into pinned memory without blocking, then one event
    per device is recorded after its copies and awaited."""
    sizes = [b.size for b in bufs]
    host = []
    for a in sizes:
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=a.is_cuda)
        h.copy_(a, non_blocking=True)
        host.append(h)
    events = []
    for d in dict.fromkeys(a.device for a in sizes if a.is_cuda):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    for ev in events:
        ev.synchronize()
    return np.concatenate([h.numpy() for h in host]).astype(np.int64)


def _feedback_rows(cfg: TMConfig, x: torch.Tensor) -> torch.Tensor:
    """Popped rows as bool features: packed rows unpack once here."""
    return packing.unpack_bits(x, cfg.n_features) if tm_mod.is_packed(x) \
        else x


def _consume_many(cfg: TMConfig, k: int, ss: SessionState, rt: TMRuntime,
                  limit: int, key: torch.Tensor, *, monitor: bool = True
                  ) -> tuple[SessionState, int, Optional[ChunkAux]]:
    """Drain up to ``min(k, limit, buffered)`` datapoints in row order.

    The reference runs a fixed-length scan of k steps and masks the steps
    past the budget; here the loop stops at the budget, which leaves the
    same state, and the chunk's k step keys come from one ``split(key, k)``
    as there. Reading the ring's size costs one host round trip a chunk.

    With ``monitor`` the chunk's rows go through one batch-first inference
    pass under the post-chunk state. The reference's masked steps pop the
    row at the (unmoved) head, so those columns carry that row here too
    and ``predicted`` agrees for every column.
    """
    keys = rnd.split(key, k)
    n = max(0, min(k, int(limit), int(ss.buf.size)))
    buf, tm = ss.buf, ss.tm
    xs, ys, acts = [], [], []
    for i in range(n):
        buf, x, y, _ = buf_mod.pop(buf)
        tm, _, activity = fb_mod.train_update(cfg, tm, rt,
                                              _feedback_rows(cfg, x), y,
                                              keys[i])
        xs.append(x)
        ys.append(y)
        acts.append(activity)
    out = SessionState(tm=tm, buf=buf, step=ss.step + n)
    if not monitor:
        return out, n, None
    _, x_head, y_head, _ = buf_mod.pop(buf)
    xs += [x_head] * (k - n)
    ys += [y_head] * (k - n)
    dev = x_head.device
    activity = torch.cat([torch.stack(acts) if acts else
                          torch.zeros(0, device=dev),
                          torch.zeros(k - n, device=dev)])
    valid = torch.arange(k, device=dev) < n
    ys = torch.stack(ys)
    preds = tm_mod.predict_batch(cfg, tm, rt, torch.stack(xs))
    aux = ChunkAux(predicted=preds, correct=(preds == ys) & valid,
                   valid=valid, activity=activity)
    return out, n, aux


def _consume_many_replicated(cfg: TMConfig, k: int, ss: SessionState,
                             rt: TMRuntime, limit: np.ndarray,
                             keys: torch.Tensor, *, monitor: bool = True,
                             size: Optional[np.ndarray] = None
                             ) -> tuple[SessionState, np.ndarray,
                                        Optional[ChunkAux]]:
    """Drain up to ``min(k, limit[r], buffered[r])`` rows from every
    replica: the fleet form of :func:`_consume_many`.

    ``ss`` leaves lead with R (R rings, banks and step counters), ``limit``
    is a host [R] budget, ``keys`` [R, 2] the chunk keys. Each step pops
    every ring in one gather, runs :func:`~repro_torch.core.feedback.
    train_update_replicated` with D = R (K3 + K9 for all R machines), and
    gates banks and rings by that step's valid mask. The chunk's step keys
    come from one ``split(keys, k)``, ``[R, k, 2]``, as the reference's
    vmapped split.

    The host reads the ring sizes once, so it knows every replica's row
    count n = min(k, limit, size) before the loop; the valid masks of all
    steps cross to the card in one copy, and the loop runs max(n) steps
    (the reference's later steps are all masked). A masked step leaves a
    replica's bank, ring and step counter as they were, so a slab of a
    sharded plane may loop to its own max(n); ``size`` passes ring sizes
    the caller already read (:func:`read_sizes`, one wait for all slabs).
    Replica r is bitwise :func:`_consume_many` on (ss[r], limit[r],
    keys[r]). Returns (state, n [R] host int64, aux [R, k] or None).
    """
    R = ss.step.shape[0]
    dev = ss.step.device
    step_keys = rnd.split(keys, k).transpose(0, 1)            # [k, R, 2]
    if size is None:
        size = ss.buf.size.cpu().numpy().astype(np.int64)
    n = np.minimum(np.minimum(k, np.asarray(limit, np.int64)),
                   np.maximum(size, 0))
    m = int(n.max(initial=0))
    valid = torch.from_numpy(np.arange(k)[:, None] < n[None, :]).to(dev)
    rt = tm_mod.replica_ports(rt, R, dev)                     # once a chunk
    buf, tm = ss.buf, ss.tm
    xs, ys, acts = [], [], []
    for i in range(m):
        new_buf, x, y, _ = buf_mod.pop_many(buf)
        new_tm, _, act = fb_mod.train_update_replicated(
            cfg, tm, rt, _feedback_rows(cfg, x), y, step_keys[i])
        gate = replica_gate(valid[i])
        tm = TMState(gate(new_tm.ta_state, tm.ta_state))
        buf = buf._replace(head=gate(new_buf.head, buf.head),
                           size=gate(new_buf.size, buf.size))
        xs.append(x)
        ys.append(y)
        acts.append(torch.where(valid[i], act, 0.0))
    out = SessionState(tm=tm, buf=buf,
                       step=ss.step + torch.from_numpy(n).to(dev, torch.int32))
    if not monitor:
        return out, n, None
    # Steps past every replica's count pop the row at each unmoved head,
    # as the reference's masked steps do.
    _, x_head, y_head, _ = buf_mod.pop_many(buf)
    xs += [x_head] * (k - m)
    ys += [y_head] * (k - m)
    acts += [torch.zeros(R, device=dev)] * (k - m)
    valid = valid.T                                           # [R, k]
    ys = torch.stack(ys, dim=1)                               # [R, k]
    preds = tm_mod.predict_batch_replicated_(cfg, tm, rt,
                                             torch.stack(xs, dim=1))
    aux = ChunkAux(predicted=preds, correct=(preds == ys) & valid,
                   valid=valid, activity=torch.stack(acts, dim=1))
    return out, n, aux


class OnlineSession:
    """Host-side front end for interleaved inference and online learning.

    * ``offer(x, y)``      -- producer side: stage into the cyclic buffer.
    * ``learn_available``  -- consumer side: drain up to ``max_points``.
    * ``infer(xs)``        -- batched inference at any time.

    A shim over the K = 1 :class:`~repro_torch.serve.service.TMService`,
    with the single-machine (no replica axis) views of the reference's
    ``OnlineSession``.
    """

    def __init__(self, cfg: TMConfig, state: TMState, rt: TMRuntime, *,
                 buffer_capacity: int = 64, chunk: int = 16, seed: int = 0,
                 device=None):
        from repro_torch.serve.service import ServiceConfig, TMService

        # seed as a 1-sequence: the service then keys on PRNGKey(seed)
        # with no fold_in, as the reference's session does.
        self._svc = TMService(cfg, state, ServiceConfig(
            replicas=1, buffer_capacity=buffer_capacity, chunk=chunk,
            seed=[int(seed)],
        ), rt=rt, device=device)

    @classmethod
    def _from_service(cls, svc) -> "OnlineSession":
        if svc.n_replicas != 1:
            raise ValueError("OnlineSession shims a K = 1 service only")
        sess = cls.__new__(cls)
        sess._svc = svc
        return sess

    @property
    def service(self):
        return self._svc

    @property
    def cfg(self) -> TMConfig:
        return self._svc.cfg

    @property
    def rt(self) -> TMRuntime:
        return self._svc.rt

    @property
    def chunk(self) -> int:
        return self._svc.chunk

    @property
    def ss(self) -> SessionState:
        """The single-machine state, staged ingress flushed first."""
        return self._svc.session_state()

    @property
    def dropped(self) -> int:
        return int(self._svc.dropped[0])

    @property
    def buffered(self) -> int:
        return int(self._svc.buffered[0])

    def offer(self, x, y) -> bool:
        return self._svc.submit(0, x, y)

    def fill_from(self, source: DataSource, n: int) -> int:
        """Pull ``n`` rows from a data source into the buffer; returns how
        many were accepted."""
        accepted = 0
        for _ in range(n):
            x, y = source.next_row()
            accepted += self.offer(x, int(y))
        return accepted

    def learn_available(
        self, max_points: int,
        on_chunk: Optional[Callable[[ChunkAux], None]] = None,
    ) -> int:
        """Consume up to ``max_points`` buffered datapoints; returns the
        number trained. ``on_chunk`` receives each chunk's
        :class:`ChunkAux` ([chunk], no replica axis); without it the
        monitoring pass does not run."""
        cb = None if on_chunk is None else (
            lambda aux: on_chunk(ChunkAux(*(a[0] for a in aux)))
        )
        return int(self._svc.drain(max_points, on_chunk=cb)[0])

    def infer(self, xs) -> np.ndarray:
        return self._svc.serve(xs)[0]
