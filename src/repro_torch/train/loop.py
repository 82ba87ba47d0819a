"""The fault-tolerant training loop, the twin of the reference's
``train/loop.py``.

The paper's runtime-management posture (accuracy watchdog -> retrain from a
known-good state; §5.3.2) generalised to the LM trainer:

* periodic **atomic checkpoints** + resume-from-latest on (re)start,
* a **health watchdog**: a non-finite loss or a per-step deadline breach is
  a fault event: the step is logged, and after ``max_faults`` consecutive
  events the loop restores the last checkpoint,
* **straggler watch**: steps slower than ``straggler_factor`` x the running
  median are recorded.

The loss is read to the host once a step (the watchdog's one sync), as in
the reference. Sharded (``shardings=``, the state's layout over a
``RankMesh``; every rank runs the loop): the ranks agree on the loss and
on the step's time, the slowest rank's, in one all-reduce before the
watchdog decides, so every rank applies or skips the same updates and
restores together; checkpoints are written collectively and restored
under ``shardings``. A faulty step's update is skipped: the loop keeps the state
it passed in. A donating ``step_fn`` (``train_step(..., donate=True)``,
the reference's ``donate_argnums``) has already written that update into
the state, its step counter included, so its update cannot be skipped:
a fault there restores the last checkpoint at once (and raises
``FileNotFoundError`` when there is none yet).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np

from repro_torch.distributed import collectives
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    keep: int = 3
    step_deadline_s: float = 120.0
    straggler_factor: float = 2.0
    max_faults: int = 3


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    losses: list = dataclasses.field(default_factory=list)
    fault_events: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)
    restores: int = 0


def run(
    lc: LoopConfig,
    state: TrainState,
    step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]],
    data_iter,
    *,
    shardings=None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
) -> tuple[TrainState, LoopReport]:
    mesh = collectives.mesh_of(shardings)
    report = LoopReport()
    durations: list[float] = []
    consecutive_faults = 0

    start_step = int(state.opt.step)
    last_good = start_step

    for step in range(start_step, lc.total_steps):
        batch = next(data_iter)
        t0 = time.monotonic()
        new_state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        if mesh is not None:
            loss, dt = collectives.agree(loss, dt, mesh)

        healthy = np.isfinite(loss) and dt <= lc.step_deadline_s
        if durations and dt > lc.straggler_factor * float(
                np.median(durations)):
            report.straggler_steps.append((step, dt))
        durations.append(dt)

        if not healthy:
            reason = "nan_loss" if not np.isfinite(loss) else "deadline"
            report.fault_events.append((step, reason, dt))
            consecutive_faults += 1
            log(f"[fault] step {step}: {reason} ({dt:.1f}s) "
                f"({consecutive_faults}/{lc.max_faults})")
            donated = new_state.opt.step is state.opt.step
            if donated or consecutive_faults >= lc.max_faults:
                log(f"[fault] restoring last good checkpoint @ {last_good}")
                state, _ = ckpt_mod.restore_tensors(
                    lc.checkpoint_dir, state, shardings=shardings)
                report.restores += 1
                consecutive_faults = 0
            continue  # skip the bad update

        consecutive_faults = 0
        state = new_state
        report.steps_run += 1
        report.losses.append(loss)

        if step % log_every == 0:
            log(f"step {step}: loss={loss:.4f} ({dt:.2f}s)")
        if (step + 1) % lc.checkpoint_every == 0:
            ckpt_mod.save(lc.checkpoint_dir, step + 1, state, keep=lc.keep)
            last_good = step + 1

    return state, report


def resume_or_init(lc: LoopConfig, init_state: TrainState, *,
                   shardings=None) -> TrainState:
    """Restore the latest checkpoint if present (restart path), else init;
    restored leaves land on ``init_state``'s devices, or are laid out by
    ``shardings`` on the current mesh, whichever mesh wrote them."""
    if ckpt_mod.latest_step(lc.checkpoint_dir) is None:
        return init_state
    return ckpt_mod.restore_tensors(lc.checkpoint_dir, init_state,
                                    shardings=shardings)[0]
