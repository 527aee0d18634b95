"""Training launcher: ``PYTHONPATH=src python -m repro_torch.launch.train
--arch <id> [--steps N] [--full [--layers L]] [--ckpt DIR]
[--device cuda|cpu]``.

The reduced config of the same family by default, the full config with
``--full`` (h2o-danube-1.8b, the default arch, trains at full width on one
80 GB card: ``--full --steps 5 --batch 4 --seq 2048``); ``--layers`` cuts
the full config's depth (the MoE configs at full depth do not fit one card:
qwen3-moe-235b-a22b trains at ``--layers 4``, arctic-480b at ``--layers
1``).  The optimizer is the config's (Adafactor for the MoE configs, AdamW
otherwise).  Weights are random, drawn on the device from a seeded
torch.Generator.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.optim import make_optimizer
from repro_torch.train.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--full", action="store_true",
                    help="use the full production config")
    ap.add_argument("--layers", type=int, default=0,
                    help="with --full, this many layers (0: full depth)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.full and args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    opt = make_optimizer(cfg.optimizer, cfg=cfg)
    loop = TrainLoop(cfg, opt, batch=args.batch, seq=args.seq, lr=args.lr,
                     ckpt_dir=args.ckpt or None,
                     grad_accum=args.grad_accum, device=args.device)
    print(f"arch={args.arch} optimizer={cfg.optimizer} steps={args.steps} "
          f"batch={args.batch}x{args.seq} on {loop.device}")
    m = loop.run(args.steps, log_every=max(args.steps // 10, 1))
    print(f"final loss {np.mean(m.losses[-5:]):.4f} "
          f"({np.mean(m.step_times)*1e3:.0f} ms/step)")
    return m


if __name__ == "__main__":
    main()
