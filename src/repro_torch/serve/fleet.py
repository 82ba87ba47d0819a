"""OnlineFleet: the replica-parallel face of :class:`TMService`, on torch.

The twin of ``repro.serve.fleet.OnlineFleet``: ``offer``/``offer_rows``
map to the router-staged ``submit``/``submit_rows`` ingress, ``drain`` and
``infer`` to ``TMService.drain``/``serve``, ``save``/``restore`` to the
service's. Replica r consumes exactly the
RNG stream of ``OnlineSession(seed=seed[r])`` when ``seed`` is a sequence,
so a fleet is bitwise K independent sessions. ``mesh`` (a
:class:`repro_torch.launch.mesh.Mesh`) shards the replica axis in slabs
over its devices, bitwise the unsharded fleet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core.online import ChunkAux, SessionState
from repro_torch.core.tm import TMConfig, TMRuntime, TMState
from repro_torch.serve.service import ServiceConfig, TMService


class OnlineFleet:
    """K concurrent online-learning sessions drained as one replicated
    plane.

    * ``offer(r, x, y)`` / ``offer_rows(xs, ys)`` -- stage into replica r's
      stream (rows into every replica's stream at once).
    * ``drain(max_points)`` -- every replica consumes up to its budget,
      chunk by chunk, the whole fleet per chunk.
    * ``infer(xs)`` -- fleet inference in one replica-first clause plane.

    ``state`` is one machine's :class:`TMState` (copied to K banks) or a
    replicated ``[K, ...]`` one; ``seed`` an int (streams by ``fold_in``)
    or a sequence of K ints. ``device`` defaults to the card; ``mesh``
    shards the replica axis (:class:`~repro_torch.serve.service.
    ServiceConfig`).
    """

    def __init__(self, cfg: TMConfig, state: TMState, rt: TMRuntime, *,
                 n_replicas: Optional[int] = None, buffer_capacity: int = 64,
                 chunk: int = 16, seed: Union[int, Sequence[int]] = 0,
                 mesh=None, device=None):
        if n_replicas is None:
            if state.ta_state.ndim != 4:
                raise ValueError(
                    "n_replicas is required when state is unreplicated")
            n_replicas = state.ta_state.shape[0]
        self._svc = TMService(cfg, state, ServiceConfig(
            replicas=n_replicas, buffer_capacity=buffer_capacity,
            chunk=chunk, seed=seed, mesh=mesh,
        ), rt=rt, device=device)

    @classmethod
    def _from_service(cls, svc: TMService) -> "OnlineFleet":
        fleet = cls.__new__(cls)
        fleet._svc = svc
        return fleet

    @property
    def service(self) -> TMService:
        return self._svc

    @property
    def cfg(self) -> TMConfig:
        return self._svc.cfg

    @property
    def mesh(self):
        return self._svc.mesh

    @property
    def rt(self) -> TMRuntime:
        return self._svc.rt

    @property
    def n_replicas(self) -> int:
        return self._svc.n_replicas

    @property
    def chunk(self) -> int:
        return self._svc.chunk

    @property
    def ss(self) -> SessionState:
        return self._svc.ss

    @ss.setter
    def ss(self, value: SessionState):
        self._svc.ss = value

    def offer_rows(self, xs, ys, mask=None) -> np.ndarray:
        """One datapoint into every (masked) replica's stream; [K]
        accepted."""
        return self._svc.submit_rows(xs, ys, mask)

    def offer(self, r: int, x, y) -> bool:
        """One datapoint into replica ``r``'s stream."""
        return self._svc.submit(r, x, y)

    def drain(self, max_points,
              on_chunk: Optional[Callable[[ChunkAux], None]] = None
              ) -> np.ndarray:
        """Consume up to ``max_points`` buffered rows per replica; [K]
        trained. See :meth:`TMService.drain`."""
        return self._svc.drain(max_points, on_chunk)

    # -- durable state ----------------------------------------------------

    def save(self, directory: str, *, step: Optional[int] = None,
             keep: int = 3) -> str:
        """Checkpoint the whole fleet (see :meth:`TMService.save`)."""
        return self._svc.save(directory, step=step, keep=keep)

    @classmethod
    def restore(cls, directory: str, *, step: Optional[int] = None,
                mesh=None, device=None) -> "OnlineFleet":
        """Rebuild a fleet from a :meth:`save` checkpoint (of either
        package); continuing equals never stopping, bit for bit."""
        return cls._from_service(TMService.restore(
            directory, step=step, mesh=mesh, device=device))

    def infer(self, xs) -> np.ndarray:
        """Fleet inference [K, B]: ``xs`` is [B, f] (one batch for all) or
        [K, B, f] (one per member)."""
        return self._svc.serve(xs)

    @property
    def buffered(self) -> np.ndarray:
        return self._svc.buffered

    @property
    def dropped(self) -> np.ndarray:
        return self._svc.dropped

    @property
    def steps(self) -> np.ndarray:
        return self._svc.steps
