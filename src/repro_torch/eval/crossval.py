"""Replica-first cross-validation engine (paper §3.6.1, §5), on torch.

The paper's "inbuilt cross-validation infrastructure" re-runs every
experiment over block orderings and sweeps (s, T). Here the whole sweep,
orderings x s-grid x T-grid, runs over one leading *replica* axis on one
card:

* the replica layout is grid-major / ordering-minor,
  ``r = (si*G + ti)*O + o``, so the ``D = O`` data streams (block
  orderings) are the fastest-varying factor and every per-data operand
  (rows, labels, RNG streams) is stored once per ordering and shared
  across the (s, T) grid: the kernel contract's ``r % D`` rule;
* training runs through
  :func:`repro_torch.core.feedback.train_epochs_replicated`, a loop over
  datapoints whose body advances all R TA banks in one K3 plane and one
  fused K9 update;
* analysis is one K4 launch for all replicas (and all three sets, in the
  system flow).

Results are bitwise the reference's ``repro.eval.crossval`` (and looping
:func:`repro_torch.core.hpsearch._one_cell` over cells). The same machinery
runs the paper's Fig-3 flow for all orderings at once:
:meth:`CrossValRun.system`, which ``manager.run_orderings`` calls.

``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) shards the replica axis
as the reference does, through
:func:`repro_torch.distributed.sharding.replica_shardings`: the full-R
leaves go in contiguous slabs, one per mesh device. The per-plane code
then runs once per slab, on that slab's device, and the results are
gathered before any reduction across replicas, so every number keeps its
bits. In the sweep only the per-replica ports (s, T) are slabbed; each
slab takes the rows of the whole per-ordering streams that it reads
(:func:`_slab_streams`): all of them where the ordering count divides the
slab, else one row per replica, ``(r0 + j) % O``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree as T
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core import manager as mgr
from repro_torch.core import tm as tm_mod
from repro_torch.core.online import slab_runtime
from repro_torch.core.tm import TMConfig, TMRuntime, TMState
from repro_torch.distributed import sharding as shard_mod
from repro_torch.launch.mesh import Mesh


class SweepResult(NamedTuple):
    """One (s x T x orderings) sweep's output (mirrors hpsearch.GridResult)."""

    s_grid: np.ndarray           # [S]
    T_grid: np.ndarray           # [G]
    val_accuracy: torch.Tensor   # [S, G, O] per-ordering validation accuracy
    mean_accuracy: torch.Tensor  # [S, G]
    replicas: int                # R = S * G * O
    wall_s: float                # wall clock of the sweep, to a device sync
    replicas_per_s: float


class SystemResult(NamedTuple):
    """All-orderings Fig-3 system run (mirrors manager.run_system outputs)."""

    state: TMState               # leaves [O, ...]
    accuracies: torch.Tensor     # [O, 1 + n_cycles, 3]
    activity: torch.Tensor       # [O, n_cycles]
    replicas: int
    wall_s: float


def replicate_state(cfg: TMConfig, n_replicas: int, device=None) -> TMState:
    """R copies of the deterministic boundary init (init_state without key)."""
    base = tm_mod.init_state(cfg, device=device).ta_state
    return TMState(ta_state=base.expand((n_replicas,) + base.shape)
                   .contiguous())


def grid_layout(s_values, T_values, n_orderings: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-replica (s [R] f32, T [R] i32) host ports for the grid-major /
    ordering-minor layout ``r = (si*G + ti)*O + o``."""
    s_grid = torch.as_tensor(np.atleast_1d(np.asarray(s_values, np.float32)))
    T_grid = torch.as_tensor(np.atleast_1d(np.asarray(T_values, np.int32)))
    G, O = T_grid.shape[0], n_orderings
    s_rep = s_grid.repeat_interleave(G * O)
    T_rep = T_grid.repeat_interleave(O).repeat(s_grid.shape[0])
    return s_rep, T_rep


def _on(x, dtype, dev) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(dev, dtype)


def _slab_streams(streams, lo: int, hi: int, D: int):
    """The per-stream leaves (leading D) that slab rows [lo, hi) read.
    Replica r reads stream r % D; where D divides both ``lo`` and the slab
    length, local row j's j % D is that stream already. Otherwise one row
    is gathered per replica, stream ``(lo + j) % D``, and the slab runs
    with a local D of ``hi - lo``."""
    if lo % D == 0 and (hi - lo) % D == 0:
        return streams

    def take(a):
        idx = torch.arange(lo, hi, device=a.device) % D
        return a.index_select(0, idx)

    return T.map(take, streams)


def sweep_slab(cfg: TMConfig, off, val, keys: torch.Tensor, s_slab, T_slab,
               lo: int, hi: int, *, n_epochs: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a sweep's replica axis (grid-major,
    ordering-minor), trained and validated on ``device``: off = (x [O, n,
    f], y [O, n], valid [O, n] or None) and val = (x [O, m, f], y [O, m])
    per-ordering sets, keys [O, 2] the per-ordering keys, s_slab / T_slab
    [hi - lo] the rows' hyper-parameters. Returns the rows' validation
    accuracies [hi - lo], bitwise those rows of the whole sweep."""
    O = keys.shape[0]
    off = (_on(off[0], torch.bool, device), _on(off[1], torch.int32, device),
           None if off[2] is None else _on(off[2], torch.bool, device))
    val = (_on(val[0], torch.bool, device), _on(val[1], torch.int32, device))
    off_j, val_j, keys_j = _slab_streams((off, val, keys.to(device)), lo, hi,
                                         O)
    rt = tm_mod.init_runtime(cfg, device=device)._replace(
        s=s_slab.to(device), T=T_slab.to(device))
    state = replicate_state(cfg, hi - lo, device)
    state = fb_mod.train_epochs_replicated(
        cfg, state, rt, off_j[0], off_j[1], keys_j, n_epochs,
        valid=off_j[2])
    return acc_mod.analyze_replicated(cfg, state, rt, *val_j)


def _analyze_all_replicated(cfg, state, ctl: mgr.CycleCtl) -> torch.Tensor:
    # One K4 launch for the whole three-set analysis block: the include
    # banks stream once per cycle.
    s = ctl.sets
    return acc_mod.analyze_sets_replicated(cfg, state, ctl.rt, [
        (s.offline_x, s.offline_y, s.offline_valid),
        (s.validation_x, s.validation_y, s.validation_valid),
        (s.online_x, s.online_y, s.online_valid),
    ])                                                 # [O, 3]


@dataclasses.dataclass(frozen=True)
class CrossValRun:
    """The cross-validation engine on one card (``device``, default the
    card; ``"cpu"`` runs the plain versions), or sharded over ``mesh``:
    the replica axis in slabs over the mesh's ``data`` axis, each slab run
    on its own device (``device`` then defaults to the first slab's, where
    the results are gathered)."""

    cfg: TMConfig
    device: object = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch Mesh, got "
                            f"{type(self.mesh).__name__}")

    @property
    def dev(self) -> torch.device:
        if self.device is None and self.mesh is not None:
            return shard_mod.slab_devices(self.mesh)[0]
        return tm_mod.resolve_device(self.device)

    def _put(self, tree, n_replicas: int) -> list:
        """``tree`` as slabs of the replica axis: the full-R leaves sharded
        over the mesh and the per-stream leaves replicated (one slab on
        the engine's device without a mesh)."""
        return shard_mod.put_slabs(tree, self.mesh, n_replicas, self.dev)

    def sweep(self, off_x, off_y, val_x, val_y, s_values, T_values, *,
              n_epochs: int = 10, seed: int = 0,
              offline_valid=None) -> SweepResult:
        """The full (s x T x orderings) sweep: off_x [O, n, f] / off_y
        [O, n] per-ordering offline sets, val_x [O, m, f] / val_y [O, m]
        validation sets, offline_valid [O, n] (masked rows skipped).

        Bitwise the reference's sweep, and looping ``hpsearch._one_cell``
        over every cell with the per-ordering keys
        ``split(PRNGKey(seed), O)``.
        """
        cfg, dev = self.cfg, self.dev
        O = off_x.shape[0]
        s_rep, T_rep = grid_layout(s_values, T_values, O)
        S = len(np.atleast_1d(s_values))
        G = len(np.atleast_1d(T_values))
        R = S * G * O
        off = (_on(off_x, torch.bool, dev), _on(off_y, torch.int32, dev),
               None if offline_valid is None
               else _on(offline_valid, torch.bool, dev))
        val = (_on(val_x, torch.bool, dev), _on(val_y, torch.int32, dev))

        devices = self._devices()
        shard_mod.sync(devices)
        t0 = time.perf_counter()
        keys = rnd.split(rnd.PRNGKey(seed, dev), O)
        accs = []
        for sl in self._put((s_rep, T_rep), n_replicas=R):
            accs.append(sweep_slab(cfg, off, val, keys, *sl.tree, sl.lo,
                                   sl.hi, n_epochs=n_epochs,
                                   device=sl.device))
        acc = torch.cat([a.to(dev) for a in accs])
        shard_mod.sync(devices)
        wall = time.perf_counter() - t0

        val_accuracy = acc.reshape(S, G, O)
        return SweepResult(
            s_grid=np.atleast_1d(np.asarray(s_values, dtype=np.float32)),
            T_grid=np.atleast_1d(np.asarray(T_values, dtype=np.int32)),
            val_accuracy=val_accuracy,
            mean_accuracy=tm_mod.mean_last(val_accuracy),
            replicas=R,
            wall_s=wall,
            replicas_per_s=R / max(wall, 1e-9),
        )

    def _devices(self) -> list:
        return ([self.dev] if self.mesh is None
                else [self.dev] + shard_mod.slab_devices(self.mesh))

    def system(self, sys_cfg: mgr.SystemConfig, states: TMState,
               rt: TMRuntime, sets: mgr.Sets, schedule: mgr.Schedule,
               keys: torch.Tensor) -> SystemResult:
        """All cross-validation orderings through the Fig-3 system flow:
        states / sets leaves [O, ...], rt shared (scalar s/T, masks), keys
        [O, 2]. Bitwise ``manager.run_system`` per ordering (activity
        within a float reduction's rounding). Under a mesh every leaf of
        states, sets and keys is full-R (R = O), so each slab runs its
        orderings' flow; the per-cycle accuracies and activities are
        gathered before the mean over datapoints."""
        cfg, dev = self.cfg, self.dev
        O = keys.shape[0]
        devices = self._devices()
        shard_mod.sync(devices)
        t0 = time.perf_counter()
        slabs = self._put((states, sets, keys), n_replicas=O)
        rts = [slab_runtime(rt, sl.lo, sl.hi, sl.device) for sl in slabs]
        state, accs = [], []

        # --- offline training phase (cycle index -1) ---
        k_onl = []
        for sl, rt_j in zip(slabs, rts):
            st_j, sets_j, keys_j = sl.tree
            ks = rnd.split(keys_j)                         # [O_j, 2, 2]
            k_onl.append(ks[:, 1])
            ctl0 = schedule(-1, rt_j, sets_j)
            st_j = fb_mod.train_epochs_replicated(
                cfg, st_j, ctl0.rt, ctl0.sets.offline_x,
                ctl0.sets.offline_y, ks[:, 0], sys_cfg.n_offline_epochs,
                valid=mgr.train_valid(ctl0.sets))
            state.append(st_j)
            accs.append([_analyze_all_replicated(cfg, st_j, ctl0)])

        # --- online cycles ---
        activity = []
        for cycle in range(sys_cfg.n_online_cycles):
            acts = []
            for j, (sl, rt_j) in enumerate(zip(slabs, rts)):
                ctl = schedule(cycle, rt_j, sl.tree[1])
                new_st, act = fb_mod.train_datapoints_replicated(
                    cfg, state[j], ctl.rt, ctl.sets.online_x,
                    ctl.sets.online_y, rnd.fold_in(k_onl[j], cycle),
                    valid=ctl.sets.online_valid)
                enabled = torch.tensor(ctl.online_enabled, device=sl.device)
                state[j] = TMState(torch.where(enabled, new_st.ta_state,
                                               state[j].ta_state))
                accs[j].append(_analyze_all_replicated(cfg, state[j], ctl))
                acts.append(act.to(dev))
            act = torch.cat(acts, dim=1)                   # [n, O]
            enabled = torch.tensor(ctl.online_enabled, device=dev)
            activity.append(torch.where(enabled, torch.mean(act, dim=0),
                                        0.0))
        accuracies = torch.cat([torch.stack(a, dim=1).to(dev)
                                for a in accs])            # [O, 1+cycles, 3]
        act = (torch.stack(activity, dim=1) if activity
               else torch.zeros((O, 0), dtype=torch.float32, device=dev))
        state = TMState(torch.cat([st.ta_state.to(dev) for st in state]))
        shard_mod.sync(devices)
        return SystemResult(state=state, accuracies=accuracies,
                            activity=act, replicas=O,
                            wall_s=time.perf_counter() - t0)
