"""The paper's Fig-3 online-learning FSM at the serving layer, on torch.

The FSM (offer -> buffer -> interleaved train/infer, periodic accuracy
analysis and the §5.3.2 rollback) lives in
:class:`repro_torch.serve.service.AdaptPolicy` driven by
:class:`~repro_torch.serve.service.TMService`. This module keeps the
reference's two TM faces as thin shims:

* :class:`TMOnlineAdaptManager` -- the paper's own machine: K = 1, scalar
  history and counters.
* :class:`TMFleetAdaptManager` -- the same FSM for a fleet: per-replica
  [K] counters, snapshots and rollbacks, per-replica ``s``/``T`` ports.

* :class:`OnlineAdaptManager` -- the FSM generalised to an LM of the dense
  families: offline training, online updates, periodic eval-loss analysis
  and the §5.3.2 rollback to the best checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.online import OnlineSession
from repro_torch.core.tm import TMConfig, TMRuntime, TMState, resolve_device
from repro_torch.models import transformer
from repro_torch.serve.fleet import OnlineFleet
from repro_torch.serve.service import AdaptPolicy, ServiceConfig, TMService
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import train_step as ts_mod


@dataclasses.dataclass
class TMOnlineAdaptConfig:
    analyze_every: int = 32           # online datapoints between analyses
    rollback_threshold: float = 0.1   # absolute accuracy drop -> rollback
    buffer_capacity: int = 64
    chunk: int = 16                   # datapoints drained per chunk

    def policy(self) -> AdaptPolicy:
        return AdaptPolicy(analyze_every=self.analyze_every,
                           rollback_threshold=self.rollback_threshold)


class _Manager:
    """What both faces share: the service and its read-only views."""

    _svc: TMService

    @property
    def service(self) -> TMService:
        return self._svc

    @property
    def cfg(self) -> TMConfig:
        return self._svc.cfg

    @property
    def rt(self) -> TMRuntime:
        return self._svc.rt

    @property
    def eval_x(self):
        return self._svc.eval_x

    @property
    def eval_y(self):
        return self._svc.eval_y


class TMOnlineAdaptManager(_Manager):
    """Fig-3 FSM serving one TM: the K = 1 face of ``TMService``.

    * ``serve(xs)`` -- batched inference.
    * ``observe(x, y)`` -- labelled traffic into the cyclic buffer; every
      ``analyze_every`` consumed points the eval set is analyzed again and
      the §5.3.2 policy rolls the TA bank back on a collapse.
    """

    def __init__(self, cfg: TMConfig, state: TMState, rt: TMRuntime,
                 eval_x, eval_y, oc: Optional[TMOnlineAdaptConfig] = None,
                 seed: int = 0, device=None):
        self.oc = oc or TMOnlineAdaptConfig()
        self._svc = TMService(cfg, state, ServiceConfig(
            replicas=1, buffer_capacity=self.oc.buffer_capacity,
            chunk=self.oc.chunk, policy=self.oc.policy(), seed=[int(seed)],
        ), rt=rt, eval_x=eval_x, eval_y=eval_y, device=device)
        self.session = OnlineSession._from_service(self._svc)

    @property
    def history(self) -> list:
        """(consumed_steps, eval_accuracy) pairs, scalar."""
        return [(int(s[0]), float(a[0])) for s, a in self._svc.history]

    @property
    def rollbacks(self) -> int:
        return int(self._svc.rollbacks[0])

    @property
    def lost(self) -> int:
        """Datapoints dropped even after the backpressure retry."""
        return int(self._svc.lost[0])

    def serve(self, xs) -> np.ndarray:
        return self._svc.serve(xs)[0]

    def analyze(self) -> float:
        return float(self._svc.analyze()[0])

    def offline_train(self, xs, ys, n_epochs: int = 10,
                      seed: int = 1) -> float:
        return float(self._svc.offline_train(xs, ys, n_epochs, seed)[0])

    def observe(self, x, y) -> Optional[float]:
        """One labelled online datapoint; the eval accuracy on analysis
        steps, else None."""
        acc = self._svc.observe_rows(x, y)
        return None if acc is None else float(acc[0])


class TMFleetAdaptManager(_Manager):
    """Fig-3 FSM for a fleet, with per-replica threshold state.

    Every member carries its own analysis cadence, best accuracy and
    known-good bank, and rolls back on its own collapse; ``rt`` may carry
    [K] ``s``/``T`` ports. The analysis is one replica-first plane over
    the shared eval set (D = 1).
    """

    def __init__(self, cfg: TMConfig, state: TMState, rt: TMRuntime,
                 eval_x, eval_y, *, n_replicas: int,
                 oc: Optional[TMOnlineAdaptConfig] = None,
                 seed: Union[int, Sequence[int]] = 0, mesh=None,
                 device=None):
        self.oc = oc or TMOnlineAdaptConfig()
        self._svc = TMService(cfg, state, ServiceConfig(
            replicas=n_replicas, buffer_capacity=self.oc.buffer_capacity,
            chunk=self.oc.chunk, policy=self.oc.policy(), seed=seed,
            mesh=mesh,
        ), rt=rt, eval_x=eval_x, eval_y=eval_y, device=device)
        self.fleet = OnlineFleet._from_service(self._svc)

    @property
    def history(self) -> list:
        """(steps [K], accuracies [K]) pairs."""
        return self._svc.history

    @property
    def rollbacks(self) -> np.ndarray:
        return self._svc.rollbacks

    @property
    def lost(self) -> np.ndarray:
        return self._svc.lost

    @property
    def _since(self) -> np.ndarray:
        return self._svc.since_analysis

    def serve(self, xs) -> np.ndarray:
        """Fleet predictions [K, B]."""
        return self._svc.serve(xs)

    def analyze(self) -> np.ndarray:
        """Eval accuracy of every member in one plane. [K] f32."""
        return self._svc.analyze()

    def offline_train(self, xs, ys, n_epochs: int = 10,
                      seed: int = 1) -> np.ndarray:
        return self._svc.offline_train(xs, ys, n_epochs, seed)

    def observe_rows(self, xs, ys, mask=None) -> Optional[np.ndarray]:
        """One labelled datapoint per (masked) replica; [K] eval
        accuracies when a member hits its cadence, else None."""
        return self._svc.observe_rows(xs, ys, mask)

    def observe(self, r: int, x, y) -> Optional[np.ndarray]:
        """One labelled datapoint into replica ``r`` only."""
        mask = np.zeros(self._svc.n_replicas, dtype=bool)
        mask[r] = True
        return self.observe_rows(x, y, mask)


@dataclasses.dataclass
class OnlineAdaptConfig:
    analyze_every: int = 8          # online updates between accuracy analyses
    rollback_threshold: float = 0.25  # relative eval-loss degradation
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_online_adapt"))


class OnlineAdaptManager:
    """The Fig-3 FSM for an LM, on the host; the device work is two
    functions, ``_update`` (one ``train_step``) and ``_eval`` (the eval
    batch's loss), kept as attributes so a caller can swap them.

    ``state`` (a ``train.train_step.TrainState``) is moved to ``device``,
    the card unless told otherwise."""

    def __init__(self, cfg: ModelConfig, tc: ts_mod.TrainConfig,
                 state: ts_mod.TrainState, oc: OnlineAdaptConfig, *,
                 device=None):
        dev = resolve_device(device)
        self.cfg, self.tc, self.oc = cfg, tc, oc
        self.state = _to(state, dev)
        self._update = lambda s, b: ts_mod.train_step(cfg, tc, s, b)
        self._eval = lambda p, b: _eval_loss(cfg, p, b, dev)
        self.history: list = []       # (step, eval_loss)
        self.rollbacks = 0
        self._steps = 0
        self._best: Optional[float] = None

    def analyze(self, eval_batch: dict) -> float:
        loss = float(self._eval(self.state.params, eval_batch))
        self.history.append((self._steps, loss))
        return loss

    def offline_train(self, batches, eval_batch: dict) -> float:
        for b in batches:
            self.state, _ = self._update(self.state, b)
            self._steps += 1
        loss = self.analyze(eval_batch)
        self._best = loss
        ckpt_mod.save(self.oc.checkpoint_dir, self._steps, self.state)
        return loss

    def online_step(self, batch: dict, eval_batch: dict) -> Optional[float]:
        """One labelled online update; periodic analysis + rollback policy."""
        self.state, _ = self._update(self.state, batch)
        self._steps += 1
        if self._steps % self.oc.analyze_every:
            return None
        loss = self.analyze(eval_batch)
        if self._best is not None and loss > self._best * (
                1.0 + self.oc.rollback_threshold):
            # §5.3.2: accuracy collapsed; restore the known-good state.
            self.state, _ = ckpt_mod.restore_tensors(
                self.oc.checkpoint_dir, self.state)
            self.rollbacks += 1
        elif self._best is None or loss < self._best:
            self._best = loss
            ckpt_mod.save(self.oc.checkpoint_dir, self._steps, self.state)
        return loss


def _eval_loss(cfg, params, batch: dict, dev) -> torch.Tensor:
    with torch.no_grad():
        return transformer.loss_fn(cfg, params, ts_mod.batch_on(batch, dev))[0]


def _to(state: ts_mod.TrainState, dev) -> ts_mod.TrainState:
    """``state`` with every tensor on ``dev``."""
    return T.map(lambda x: x.to(dev), state)
