"""System operation FSM (paper §4, Fig. 3), on torch.

Execution flow: offline training -> accuracy analysis (offline/validation/
online sets) -> [online training pass -> accuracy analysis] x n_cycles.

Runtime *schedules* express the paper's use-case events (class
introduction §5.2, fault injection §5.3, s/T changes) as functions of the
cycle index over the fixed-shape runtime. :func:`run_system` runs one
machine; :func:`run_orderings` runs every cross-validation ordering at once
through the replica-first engine (:class:`repro_torch.eval.crossval.
CrossValRun`), one fused plane per datapoint.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core.tm import TMConfig, TMRuntime, TMState


class Sets(NamedTuple):
    """The three data sets (§3.6.1) with validity masks (fixed shapes).

    ``offline_train_valid`` restricts TRAINING rows (§5.1 uses 20 of 30);
    ``offline_valid`` governs accuracy ANALYSIS of the offline set.

    Shapes are the single-machine form (:func:`run_system`): x [n, f] bool,
    y [n] int, valid [n] bool. Under the replica-first engine
    (:func:`run_orderings`) every leaf carries a leading ordering axis
    ``[O, ...]``.
    """

    offline_x: torch.Tensor
    offline_y: torch.Tensor
    offline_valid: torch.Tensor
    validation_x: torch.Tensor
    validation_y: torch.Tensor
    validation_valid: torch.Tensor
    online_x: torch.Tensor
    online_y: torch.Tensor
    online_valid: torch.Tensor
    offline_train_valid: Optional[torch.Tensor] = None


class CycleCtl(NamedTuple):
    """Per-cycle control word produced by a schedule (the runtime ports)."""

    rt: TMRuntime
    sets: Sets
    online_enabled: bool


# A schedule maps (cycle_index, base_runtime, base_sets) -> CycleCtl; the
# cycle index is a host int, -1 for the offline-training phase.
#
# CONTRACT: a schedule is broadcast-safe over a leading ordering axis. Under
# run_system it sees the single-machine Sets shapes; under the replica-first
# engine the SAME schedule is applied once to Sets whose leaves carry a
# leading [O] axis (and a shared runtime). Mask logic works on the LAST
# axes and never keys off ``shape[0]``; everything make_schedule produces
# obeys this.
Schedule = Callable[[int, TMRuntime, Sets], CycleCtl]


def default_schedule(cycle: int, rt: TMRuntime, sets: Sets) -> CycleCtl:
    return CycleCtl(rt=rt, sets=sets, online_enabled=True)


def make_schedule(
    *,
    online_enabled: bool = True,
    filtered_class: int | None = None,
    introduce_at_cycle: int | None = None,
    fault_masks=None,
    inject_at_cycle: int | None = None,
    online_s: float | None = None,
) -> Schedule:
    """Compose the paper's use-case events into one schedule.

    * ``filtered_class`` -- class removed from all sets (and the class mask)
      until ``introduce_at_cycle`` (None = filtered forever). §5.2.
    * ``fault_masks`` -- (and_mask, or_mask), numpy or tensors, written at
      ``inject_at_cycle``. §5.3.
    * ``online_s`` -- the runtime s-port value during online cycles. §5.1.
    """
    on_device: dict = {}

    def masks_on(dev):
        # The fault masks reach each device once, not once per cycle.
        if dev not in on_device:
            on_device[dev] = tuple(
                (m if torch.is_tensor(m)
                 else torch.from_numpy(np.asarray(m, dtype=bool)))
                .to(dev, torch.bool) for m in fault_masks)
        return on_device[dev]

    def schedule(cycle: int, rt: TMRuntime, sets: Sets) -> CycleCtl:
        cycle = int(cycle)
        if filtered_class is not None:
            filtering = (introduce_at_cycle is None
                         or cycle < introduce_at_cycle)
            if filtering:
                def filt(ys, valid):
                    return valid & (ys != filtered_class)

                sets = sets._replace(
                    offline_valid=filt(sets.offline_y, sets.offline_valid),
                    validation_valid=filt(sets.validation_y,
                                          sets.validation_valid),
                    online_valid=filt(sets.online_y, sets.online_valid),
                )
                # The class slot is enabled only once introduced.
                cls = torch.arange(rt.class_mask.shape[-1],
                                   device=rt.class_mask.device)
                rt = rt._replace(
                    class_mask=rt.class_mask & (cls != filtered_class))

        if (fault_masks is not None and inject_at_cycle is not None
                and cycle >= inject_at_cycle):
            and_m, or_m = masks_on(rt.ta_and_mask.device)
            rt = rt._replace(ta_and_mask=and_m, ta_or_mask=or_m)

        if online_s is not None and cycle >= 0:
            rt = rt._replace(s=torch.full_like(
                torch.as_tensor(rt.s, dtype=torch.float32), online_s))

        return CycleCtl(rt=rt, sets=sets, online_enabled=online_enabled)

    return schedule


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """High-level manager parameters (paper §5: 10 offline epochs, 16
    cycles)."""

    n_offline_epochs: int = 10
    n_online_cycles: int = 16


def train_valid(sets: Sets) -> torch.Tensor:
    """The offline training mask: ``offline_train_valid & offline_valid``
    (just ``offline_valid`` when no training mask is set)."""
    if sets.offline_train_valid is None:
        return sets.offline_valid
    return sets.offline_train_valid & sets.offline_valid


def _analyze_all(cfg, state, ctl: CycleCtl) -> torch.Tensor:
    s = ctl.sets
    return torch.stack([
        acc_mod.analyze(cfg, state, ctl.rt, s.offline_x, s.offline_y,
                        s.offline_valid),
        acc_mod.analyze(cfg, state, ctl.rt, s.validation_x, s.validation_y,
                        s.validation_valid),
        acc_mod.analyze(cfg, state, ctl.rt, s.online_x, s.online_y,
                        s.online_valid),
    ])


def run_system(cfg: TMConfig, sys_cfg: SystemConfig, state: TMState,
               rt: TMRuntime, sets: Sets, schedule: Schedule,
               key: torch.Tensor
               ) -> tuple[TMState, torch.Tensor, torch.Tensor]:
    """Run the full Fig-3 flow on one machine.

    Returns (final_state, accuracies [1 + n_cycles, 3] (offline/validation/
    online sets), activity [n_cycles] mean TA-update activity per online
    cycle).
    """
    k_off, k_onl = rnd.split(key)

    # --- offline training phase (cycle index -1) ---
    ctl0 = schedule(-1, rt, sets)
    state = fb_mod.train_epochs(
        cfg, state, ctl0.rt, ctl0.sets.offline_x, ctl0.sets.offline_y,
        k_off, sys_cfg.n_offline_epochs, valid=train_valid(ctl0.sets))
    accs = [_analyze_all(cfg, state, ctl0)]

    # --- online cycles ---
    dev = state.ta_state.device
    activity = []
    for cycle in range(sys_cfg.n_online_cycles):
        ctl = schedule(cycle, rt, sets)
        new_st, aux = fb_mod.train_datapoints(
            cfg, state, ctl.rt, ctl.sets.online_x, ctl.sets.online_y,
            rnd.fold_in(k_onl, cycle), valid=ctl.sets.online_valid)
        enabled = torch.tensor(ctl.online_enabled, device=dev)
        state = TMState(torch.where(enabled, new_st.ta_state,
                                    state.ta_state))
        accs.append(_analyze_all(cfg, state, ctl))
        activity.append(torch.where(enabled, torch.mean(aux.activity), 0.0))
    act = (torch.stack(activity) if activity
           else torch.zeros(0, dtype=torch.float32, device=dev))
    return state, torch.stack(accs), act


def run_orderings(cfg: TMConfig, sys_cfg: SystemConfig, states: TMState,
                  rt: TMRuntime, sets: Sets, schedule: Schedule,
                  keys: torch.Tensor, mesh=None):
    """All cross-validation orderings at once, through the replica-first
    engine: a thin caller of :meth:`CrossValRun.system`. ``states`` and
    every leaf of ``sets`` carry a leading ordering axis; ``keys`` is
    [O, 2]. Bitwise :func:`run_system` per ordering, activity within a
    float reduction's rounding. ``mesh`` shards the ordering axis; the
    results are gathered on the states' device."""
    from repro_torch.eval.crossval import CrossValRun

    res = CrossValRun(cfg, device=states.ta_state.device,
                      mesh=mesh).system(
        sys_cfg, states, rt, sets, schedule, keys)
    return res.state, res.accuracies, res.activity
