"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the smoke config, or the full config with ``--full``, from random
weights (``--seed``) on ``data.synthetic`` batches, on the card unless
``--device cpu`` (``--layers N`` cuts the depth to N layers: olmoe-1b-7b's
float32 parameters and moments do not fit one card at full depth),
through the fault-tolerant loop (``train.loop``: checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir``, resume from the latest one
there, the NaN / deadline watchdog, the straggler watch).
The step donates the state (updates it in place), as the reference's
jitted step does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tm import resolve_device
from repro_torch.data import synthetic
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tc = ts_mod.TrainConfig(
        opt=opt_mod.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5)),
        microbatches=args.microbatches,
        grad_compress=args.grad_compress,
    )
    specs = transformer.model_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prm = P.materialize(specs, gen, torch.float32, device=dev)
    state = ts_mod.init_state(tc, prm)
    n_params = P.count_params(specs)
    print(f"arch={cfg.arch_id} layers={cfg.n_layers} device={dev} "
          f"params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = synthetic.token_batches(cfg, shape, seed=args.seed)

    def step_fn(s, b):
        return ts_mod.train_step(cfg, tc, s, b, donate=True)

    lc = loop_mod.LoopConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir,
    )
    state = loop_mod.resume_or_init(lc, state)
    state, report = loop_mod.run(lc, state, step_fn, data)
    print(f"done: steps_run={report.steps_run} "
          f"final_loss={report.losses[-1] if report.losses else None} "
          f"faults={len(report.fault_events)} "
          f"stragglers={len(report.straggler_steps)} "
          f"restores={report.restores}")
    return state, report


if __name__ == "__main__":
    main()
