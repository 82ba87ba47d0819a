"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-param model
for a few hundred steps with the full production loop (AdamW + cosine,
atomic checkpoints, NaN/straggler watchdog, resume-on-restart).

    python examples/train_lm_torch.py [--steps 200] [--small] [--device cpu]

--small trains the reduced smoke config (seconds on the CPU). It runs on
the CUDA card unless ``--device`` names another device, and resumes from
the latest checkpoint in ``--ckpt`` (default: ``repro_train_lm`` in the
temporary directory, ``$TMPDIR`` or ``/tmp``). The weights start random,
drawn from torch's generator seeded with 0.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import GLOBAL, ModelConfig, ShapeConfig
from repro_torch.core.tm import resolve_device
from repro_torch.data import synthetic
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

CFG_100M = ModelConfig(
    arch_id="repro-100m",
    family="dense",
    n_layers=12,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=1708,
    vocab_size=32768,
    layer_pattern=(GLOBAL,),
    act="swiglu",
    compute_dtype="float32",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke_config("granite_8b") if args.small else CFG_100M
    specs = transformer.model_specs(cfg)
    print(f"model: {cfg.arch_id}  params={P.count_params(specs)/1e6:.1f}M")

    tc = ts_mod.TrainConfig(opt=opt_mod.OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    prm = P.materialize(specs, torch.Generator(device=dev).manual_seed(0),
                        torch.float32, device=dev)
    state = ts_mod.init_state(tc, prm)

    shape = ShapeConfig("ex", args.seq, args.batch, "train")
    data = synthetic.token_batches(cfg, shape)

    def step_fn(s, b):
        return ts_mod.train_step(cfg, tc, s, b, donate=True)

    lc = loop_mod.LoopConfig(total_steps=args.steps,
                             checkpoint_every=max(args.steps // 4, 10),
                             checkpoint_dir=args.ckpt)
    state = loop_mod.resume_or_init(lc, state)
    state, report = loop_mod.run(lc, state, step_fn, data, log_every=10)
    first = report.losses[0] if report.losses else float("nan")
    last = report.losses[-1] if report.losses else float("nan")
    print(f"\nloss {first:.3f} -> {last:.3f} over {report.steps_run} steps "
          f"(faults={len(report.fault_events)}, "
          f"stragglers={len(report.straggler_steps)})")
    return report


if __name__ == "__main__":
    main()
