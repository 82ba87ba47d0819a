"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the batched prefill + decode engine on the smoke config, or on the
full config with ``--full``, at random weights from ``--seed``, on the
card unless ``--device cpu``. Prints the generated tokens' shape, the
wall time and tokens/s (host clock around ``generate``, which ends with
the tokens on the host).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.tm import resolve_device
from repro_torch.models import params as P
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_config(args.arch) if args.full
           else configs.get_smoke_config(args.arch))
    if cfg.embeds_input or cfg.family == "vlm":
        raise SystemExit(f"{args.arch} takes stub embeddings, not tokens "
                         "alone; drive it through models.transformer with "
                         "models.stubs.synthetic_batch")
    specs = transformer.model_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prm = P.materialize(specs, gen, torch.float32, device=dev)

    ec = EngineConfig(
        max_seq=args.prompt_len + args.max_new,
        batch_slots=args.batch,
        temperature=args.temperature,
    )
    eng = Engine(cfg, prm, ec, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts, args.max_new)
    dt = time.time() - t0
    print(f"arch={cfg.arch_id} device={dev} generated {out.shape} in "
          f"{dt:.2f}s ({args.batch*args.max_new/dt:.1f} tok/s)")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
