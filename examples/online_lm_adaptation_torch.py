"""The paper's Fig-3 FSM applied to an LM (DESIGN.md §4), on the
PyTorch/CUDA port:

offline train -> analyze -> interleave online updates with periodic
analysis; if eval loss collapses (bad online data / faults), roll back to
the last good checkpoint — the TM architecture's accuracy-watchdog +
on-chip-retrain policy (§5.3.2) as an LM serving runtime.

    python examples/online_lm_adaptation_torch.py [--ckpt DIR] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device, and
keeps its known-good checkpoints in ``--ckpt`` (default:
``repro_online_lm`` in the temporary directory, ``$TMPDIR`` or ``/tmp``).
The weights start random, drawn from torch's generator seeded with 0.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tm import resolve_device
from repro_torch.data import synthetic
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.serve.online_adapt import OnlineAdaptConfig, OnlineAdaptManager
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_online_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke_config("gemma3_1b")
    prm = P.materialize(transformer.model_specs(cfg),
                        torch.Generator(device=dev).manual_seed(0),
                        torch.float32, device=dev)
    tc = ts_mod.TrainConfig(opt=opt_mod.OptConfig(
        lr=2e-3, warmup_steps=2, total_steps=500))
    state = ts_mod.init_state(tc, prm)
    oc = OnlineAdaptConfig(analyze_every=4, rollback_threshold=0.10,
                           checkpoint_dir=args.ckpt)
    m = OnlineAdaptManager(cfg, tc, state, oc, device=dev)

    shape = ShapeConfig("ex", 64, 2, "train")
    stream = synthetic.token_batches(cfg, shape, seed=0)
    evalb = synthetic.token_batches(cfg, shape, seed=99).__next__()

    base = m.offline_train([next(stream) for _ in range(8)], evalb)
    print(f"offline phase: eval loss {base:.3f}")

    for step in range(24):
        batch = next(stream)
        if 8 <= step < 12:  # a burst of corrupted online labels
            batch = dict(batch)
            batch["tokens"] = np.random.default_rng(step).integers(
                0, cfg.vocab_size, batch["tokens"].shape).astype(np.int32)
        loss = m.online_step(batch, evalb)
        if loss is not None:
            print(f"online step {step:2d}: eval={loss:.3f} "
                  f"rollbacks={m.rollbacks}")
    print(f"\nfinal eval {m.history[-1][1]:.3f} (offline {base:.3f}); "
          f"rollbacks={m.rollbacks}")
    return {"offline": base, "history": list(m.history),
            "rollbacks": m.rollbacks}


if __name__ == "__main__":
    main()
