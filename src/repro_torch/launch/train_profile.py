"""Where a training step's time goes on the card, inside the attention
backward.

    PYTHONPATH=src python -m repro_torch.launch.train_profile [--tag NAME]

Builds h2o-danube-1.8b at full width (random weights from a seeded
torch.Generator) with AdamW, as ``chip_smoke.py`` ``[train]`` does (TF32
off, 4 x 2048 tokens), and takes ``STEPS`` steps on synthetic tokens: their
host-clock times (synchronized) and the steps' peak
``max_memory_allocated``.  Then one more step under ``torch.profiler``:
the device time of every kernel that starts inside the spans of ``RANGE``
(the ``record_function`` of the flash kernel's backward), by kernel name,
with its count, and the step's device time outside the range.  Kernels run on one stream and the host waits inside backward, so a
kernel that starts inside a span belongs to it.  Prints the card's name and
power limit, readable lines, and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.optim import adamw
from repro_torch.train import steps as tsteps

ARCH, BATCH, SEQ, STEPS = "h2o-danube-1.8b", 4, 2048, 5
RANGE = "attention backward (eager)"


def range_kernels(prof, name: str) -> dict:
    """{"range_ms", "outside_ms", "spans", "kernels": {kernel: [ms,
    count]}} of one profiled step."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == name]
    kernels, outside = {}, 0.0
    for e in events:
        if e.name == name or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        t = e.time_range.start
        if any(a <= t < b for a, b in spans):
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += ms
            row[1] += 1
        else:
            outside += ms
    return {"range_ms": sum(ms for ms, _ in kernels.values()),
            "outside_ms": outside, "spans": len(spans), "kernels": kernels}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="", help="the name printed on each line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile measures the card; it needs cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    opt = adamw()
    state = tsteps.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                    cfg, opt, device=dev)
    data = SyntheticTokens(cfg, BATCH, SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_for_step(i).items()}
               for i in range(STEPS + 1)]
    step = tsteps.build_train_step(
        cfg, opt, lambda s: 1e-4, grad_accum=1)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        # repro: allow(DB001): a step's host time is the measurement
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        float(metrics["loss"])
        torch.cuda.synchronize()
        # repro: allow(DB001): a step's host time is the measurement
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        step(state, batches[STEPS])
        torch.cuda.synchronize()
    r = range_kernels(prof, RANGE)
    med = statistics.median(times[1:] or times)
    print(card)
    print(f"[{args.tag}] {ARCH} {BATCH} x {SEQ}: steps "
          f"{[round(t, 1) for t in times]} ms, median of steps 2.. {med:.1f} "
          f"ms, peak {peak:.2f} GB; profiled step: {RANGE!r} "
          f"{r['range_ms']:.3f} ms in {r['spans']} spans, the rest "
          f"{r['outside_ms']:.3f} ms; {card}")
    top = sorted(r["kernels"].items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in top[:25]:
        print(f"[{args.tag}]   {ms:9.3f} ms x{n:<5d} {name[:110]}")
    print(json.dumps({"tag": args.tag, "card": card, "arch": ARCH,
                      "batch": BATCH, "seq": SEQ,
                      "steps_ms": times, "median_ms": med, "peak_gb": peak,
                      "range": RANGE, "range_ms": r["range_ms"],
                      "outside_ms": r["outside_ms"], "spans": r["spans"],
                      "kernels": {n: v for n, v in top}}))


if __name__ == "__main__":
    main()
