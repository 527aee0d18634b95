"""End-to-end serving driver: batched requests through the continuous-
batching engine on a small LM (the paper's kind is a serving system, so the
e2e driver serves rather than trains).  The port's twin of
``examples/serve_pipeline.py``; weights are random, drawn from a seeded
torch.Generator.

    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline \
        [--arch gemma3-1b] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    print(f"serving {args.arch} (reduced config: {cfg.n_layers}L "
          f"d={cfg.d_model}) with {args.slots} decode slots on {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device=device)
    eng = ServingEngine(cfg, model, n_slots=args.slots, max_len=128,
                        device=device)

    rng = np.random.default_rng(0)
    # repro: allow(DB001): the driver reports real serving throughput
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size, size=rng.integers(3, 8))
        eng.submit(Request(i, prompt.astype(np.int32),
                           max_new=args.max_new))
    done = eng.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0   # repro: allow(DB001): as above

    total_tokens = sum(len(r.tokens_out) for r in done)
    print(f"completed {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.req_id}: prompt {r.prompt.tolist()} -> "
              f"{r.tokens_out}")
    return done


if __name__ == "__main__":
    main()
