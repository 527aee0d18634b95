"""Train a small LM for a few hundred steps with the full substrate:
synthetic data pipeline (prefetch), AdamW + cosine schedule, two-tier
checkpointing, loss curve.  The port's twin of ``examples/train_small.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_small --preset 100m
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.preset == "100m":
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32_000, attn_q_block=64)
    loop = TrainLoop(cfg, adamw(), batch=args.batch, seq=args.seq,
                     lr=3e-3, ckpt_dir=args.ckpt or None, device=args.device)
    print(f"training {args.arch} [{args.preset}] batch {args.batch} x seq "
          f"{args.seq}, {args.steps} steps on {loop.device}")
    m = loop.run(args.steps, log_every=20)
    first, last = np.mean(m.losses[:10]), np.mean(m.losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({np.mean(m.step_times)*1e3:.0f} ms/step)")
    assert last < first, "loss did not decrease"
    return m


if __name__ == "__main__":
    main()
