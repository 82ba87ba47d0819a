"""Batched serving on the PyTorch/CUDA port: prefill + decode with a
persistent KV cache, through ``repro_torch.serve.engine.Engine``.

    python examples/serve_lm_torch.py [--arch gemma3-1b] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device. The
weights are random, drawn from torch's generator seeded with 0.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

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
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke_config(args.arch)
    if cfg.embeds_input:
        raise SystemExit("pick a token-input arch for this example")
    prm = P.materialize(transformer.model_specs(cfg),
                        torch.Generator(device=dev).manual_seed(0),
                        torch.float32, device=dev)
    ec = EngineConfig(max_seq=16 + args.max_new, batch_slots=args.batch)
    eng = Engine(cfg, prm, ec, device=dev)

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, 16)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts, args.max_new)
    dt = time.time() - t0
    print(f"{cfg.arch_id} (reduced): {args.batch} seqs x {args.max_new} "
          f"tokens in {dt:.2f}s ({args.batch*args.max_new/dt:.0f} tok/s)")
    print("first rows:", out[:2, :12])
    return out


if __name__ == "__main__":
    main()
