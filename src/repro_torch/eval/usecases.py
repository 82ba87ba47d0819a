"""The paper's use cases (§5, Figs 4-9) through the replica-first engine.

The port's own copy of the use-case half of the reference's figure
harness: the iris setup (16 clauses, T = 15, s = 1.375 offline / 1.0
online, 10 offline epochs, sets of 30 / 60 / 60, offline training on 20
of the 30 rows) and the MNIST-scale digit workload (``dataset="mnist"``,
f = side**2 boolean inputs, 10 classes, the same 150-row, 5-block
geometry), every cross-validation ordering run at once by
:meth:`repro_torch.eval.crossval.CrossValRun.system`, and the three
figure protocols:

* :func:`limited_data` -- Fig 4, online learning after a limited offline
  set;
* :func:`class_introduction` -- Figs 5-7, class 0 filtered, then
  introduced at cycle 5 with online learning off (Fig 6) and on (Fig 7);
* :func:`fault_mitigation` -- Figs 8-9, stuck-at-0 TAs injected at
  cycle 5, online learning off and on.

The mean curves are averaged in numpy over the orderings' float32
accuracies, as the reference averages them, so equal per-ordering
accuracies give equal curves bit for bit. Everything runs on the card
unless ``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.configs import tm_iris
from repro_torch.configs.tm_iris import TMSystemParams
from repro_torch.core import faults
from repro_torch.core import manager as mgr
from repro_torch.core.tm import init_runtime, resolve_device
from repro_torch.data import blocks
from repro_torch.eval.crossval import CrossValRun, SystemResult, replicate_state

CFG = tm_iris.CONFIG.tm


def system_params(dataset: str = "iris",
                  side: int | None = None) -> TMSystemParams:
    """The per-dataset system preset (iris; mnist at ``side``, default the
    full 28 x 28 raster)."""
    if dataset == "iris":
        return tm_iris.CONFIG
    if dataset == "mnist":
        from repro_torch.configs import tm_mnist

        return tm_mnist.config_for_side(tm_mnist.SIDE if side is None
                                        else side)
    raise ValueError(f"unknown dataset {dataset!r} (iris | mnist)")


def build_sets(n_orderings: int, offline_limit: int | None = 20,
               dataset: str = "iris", side: int | None = None
               ) -> tuple[mgr.Sets, int]:
    """Per-ordering ``Sets`` of numpy arrays (leading axis = ordering) and
    the ordering count: the offline set analyzed whole and trained on its
    first ``offline_limit`` rows (§5.1: 20 of 30; None = all)."""
    if dataset == "iris":
        osets, _ = blocks.iris_paper_sets(n_orderings=n_orderings)
    elif dataset == "mnist":
        osets, _ = blocks.mnist_paper_sets(n_orderings=n_orderings,
                                           side=side)
    else:
        raise ValueError(f"unknown dataset {dataset!r} (iris | mnist)")
    O, n_off = osets.offline_y.shape
    train_valid = np.ones((O, n_off), dtype=bool)
    if offline_limit is not None:
        train_valid[:, offline_limit:] = False
    sets = mgr.Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((O, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=train_valid)
    return sets, O


def run_system(schedule: mgr.Schedule, *, n_orderings: int = 24,
               n_cycles: int = 16, offline_limit: int | None = 20,
               seed: int = 0, dataset: str = "iris",
               side: int | None = None, device=None,
               backend: str | None = None) -> SystemResult:
    """Every ordering's Fig-3 run under ``schedule``, as one
    :meth:`CrossValRun.system` call: boundary-initialised banks, keys
    ``split(PRNGKey(seed), O)``, the preset's offline epochs and
    ``n_cycles`` online cycles. ``backend`` overrides the preset's kernel
    backend ("ref" runs the plain versions on the same device)."""
    dev = resolve_device(device)
    params = system_params(dataset, side)
    cfg = params.tm
    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    sets, O = build_sets(n_orderings, offline_limit, dataset, side)
    sys_cfg = mgr.SystemConfig(n_offline_epochs=params.n_offline_epochs,
                               n_online_cycles=n_cycles)
    rt = init_runtime(cfg, s=params.s_offline, T=params.T, device=dev)
    keys = rnd.split(rnd.PRNGKey(seed, dev), O)
    return CrossValRun(cfg, device=dev).system(
        sys_cfg, replicate_state(cfg, O, dev), rt,
        convert.sets_from_numpy(sets, dev), schedule, keys)


def mean_curves(res: SystemResult) -> tuple[np.ndarray, np.ndarray]:
    """The mean accuracy curve [1 + n_cycles, 3] and activity [n_cycles]
    over the orderings, averaged in numpy as the reference does."""
    return (res.accuracies.cpu().numpy().mean(axis=0),
            res.activity.cpu().numpy().mean(axis=0))


def run_schedule(schedule: mgr.Schedule, *, n_orderings: int = 24,
                 n_cycles: int = 16, offline_limit: int | None = 20,
                 seed: int = 0, dataset: str = "iris",
                 side: int | None = None, device=None):
    """Mean accuracy curves [1 + n_cycles, 3] over orderings, the mean
    activity [n_cycles], the engine's wall time and the ordering count."""
    res = run_system(schedule, n_orderings=n_orderings, n_cycles=n_cycles,
                     offline_limit=offline_limit, seed=seed,
                     dataset=dataset, side=side, device=device)
    curve, activity = mean_curves(res)
    return curve, activity, res.wall_s, res.replicas


def figure_schedule(fig: int, event: int = 5, fraction: float = 0.2,
                    dataset: str = "iris", side: int | None = None
                    ) -> mgr.Schedule:
    """The schedule of the paper's Fig ``fig`` (4-9): online learning at the
    preset's online s (Fig 4); class 0 filtered (Fig 5), introduced at
    cycle ``event`` with online learning off (Fig 6) or on (Fig 7); or
    ``fraction`` of the TAs stuck at 0 (evenly spread, §5.3.1) from cycle
    ``event``, online learning off (Fig 8) or on (Fig 9)."""
    params = system_params(dataset, side)
    s_onl = params.s_online
    if fig == 4:
        return mgr.make_schedule(online_s=s_onl)
    if fig == 5:
        return mgr.make_schedule(online_s=s_onl, filtered_class=0)
    if fig in (6, 7):
        return mgr.make_schedule(online_s=s_onl, filtered_class=0,
                                 introduce_at_cycle=event,
                                 online_enabled=fig == 7)
    if fig in (8, 9):
        masks = faults.even_spread_stuck_at(params.tm, fraction, 0)
        return mgr.make_schedule(online_s=s_onl, fault_masks=masks,
                                 inject_at_cycle=event,
                                 online_enabled=fig == 9)
    raise ValueError(f"no schedule for Fig {fig} (4-9)")


def curve_csv(name: str, curve: np.ndarray) -> str:
    """accuracy curve -> csv rows ``name,cycle,offline,validation,online``."""
    return "\n".join(f"{name},{i},{a:.4f},{b:.4f},{c:.4f}"
                     for i, (a, b, c) in enumerate(curve))


def limited_data(n_orderings: int = 24, seed: int = 0,
                 dataset: str = "iris", side: int | None = None,
                 device=None):
    """Fig 4: 10 offline epochs on 20 rows (s = 1.375), then 16 online
    cycles at s = 1.0. Returns (curve, derived figures, wall)."""
    curve, activity, wall, O = run_schedule(
        figure_schedule(4, dataset=dataset, side=side),
        n_orderings=n_orderings, seed=seed, dataset=dataset, side=side,
        device=device)
    gains = curve[-1] - curve[0]
    derived = {
        "start_offline": curve[0, 0], "start_val": curve[0, 1],
        "start_online": curve[0, 2],
        "gain_offline": gains[0], "gain_val": gains[1],
        "gain_online": gains[2],
        "mean_activity": float(activity.mean()),
        "orderings": O,
    }
    return curve, derived, wall


def class_introduction(n_orderings: int = 24, introduce_at: int = 5,
                       seed: int = 0, dataset: str = "iris",
                       side: int | None = None, device=None):
    """Figs 5-7 on the whole 30-row offline set: class 0 filtered for the
    whole run (Fig 5), introduced at ``introduce_at`` with online learning
    off (Fig 6) and on (Fig 7). Returns ({name: run_schedule's tuple},
    introduce_at)."""
    kw = dict(n_orderings=n_orderings, offline_limit=None, seed=seed,
              dataset=dataset, side=side, device=device)
    names = {5: "fig5_filtered_online", 6: "fig6_intro_no_online",
             7: "fig7_intro_online"}
    out = {name: run_schedule(figure_schedule(fig, introduce_at,
                                              dataset=dataset, side=side),
                              **kw)
           for fig, name in names.items()}
    return out, introduce_at


def fault_mitigation(n_orderings: int = 24, inject_at: int = 5,
                     fraction: float = 0.2, seed: int = 0,
                     dataset: str = "iris", side: int | None = None,
                     device=None):
    """Figs 8-9: ``fraction`` of the TAs stuck at 0 (evenly spread, §5.3.1)
    from cycle ``inject_at``, online learning off (Fig 8) and on (Fig 9).
    Returns ({name: run_schedule's tuple}, inject_at)."""
    kw = dict(n_orderings=n_orderings, seed=seed, dataset=dataset,
              side=side, device=device)
    names = {8: "fig8_faults_no_online", 9: "fig9_faults_online"}
    out = {name: run_schedule(figure_schedule(fig, inject_at, fraction,
                                              dataset=dataset, side=side),
                              **kw)
           for fig, name in names.items()}
    return out, inject_at
