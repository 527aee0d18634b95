"""Serving launcher: ``PYTHONPATH=src python -m repro_torch.launch.serve
--arch <id> [--requests N] [--slots K] [--full] [--device cuda|cpu]`` —
continuous-batching engine over the reduced config, or over the full config
with ``--full``.  Weights are random, drawn from a seeded torch.Generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device=device)
    eng = ServingEngine(cfg, model, n_slots=args.slots, max_len=args.max_len,
                        device=device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size,
                              size=int(rng.integers(3, 9)))
        eng.submit(Request(i, prompt.astype(np.int32),
                           max_new=args.max_new))
    done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens_out) for r in done)
    print(f"{len(done)} requests, {toks} tokens, {dt:.1f}s "
          f"({toks/dt:.1f} tok/s) on {device}")
    return done


if __name__ == "__main__":
    main()
