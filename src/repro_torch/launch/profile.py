"""Where the time goes on the card, for the serving path.

    PYTHONPATH=src python -m repro_torch.launch.profile [--arch gemma3-1b]
        [--batch 4] [--seq 1024] [--iters 5]

(``--arch`` takes any of the ten architectures: gemma3-1b,
recurrentgemma-2b, rwkv6-7b, qwen3-moe-235b-a22b ...; ``--layers`` cuts the
depth, for the MoE configs whose full depth does not fit one card)

Builds the full-width model (random weights from a seeded torch.Generator),
takes its prefill batch from ``models.io.make_batch`` (whisper: ``--seq``
frames and ``--seq // 4`` decoder tokens; paligemma: 256 patches and the
rest tokens) and, for the prefill step and the decode step right after it,
prints: the host-clock time
of a call without the profiler (synchronized), the device time of a call
(the sum of its kernels' times in a ``torch.profiler`` trace; kernels run on
one stream and do not overlap), the device's idle share (1 - device/host),
the device time by kind of kernel, and the kernels that took the most.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.io import make_batch
from repro_torch.serving.steps import build_decode_step, build_prefill_step

# kernel-name fragments -> kind, first match wins
KINDS = (("flash_wgmma_kernel", "flash attention (this port's kernel)"),
         ("flash_fwd_kernel", "flash attention, CUDA cores (this port's kernel)"),
         ("rglru_scan_grouped_kernel", "RG-LRU scan (this port's kernel)"),
         ("rglru_scan_kernel",
          "RG-LRU scan, one thread a channel (this port's kernel)"),
         ("wkv6_chunk_kernel", "wkv6 (this port's kernel)"),
         ("wkv6_kernel", "wkv6, sequential (this port's kernel)"),
         ("nvjet", "matmul"), ("gemm", "matmul"), ("gemv", "matmul"),
         ("cutlass", "matmul"), ("xmma", "matmul"), ("sm90", "matmul"),
         ("Memcpy", "copies"), ("Memset", "copies"))


def _kind(name: str) -> str:
    return next((k for frag, k in KINDS if frag in name),
                "elementwise, reductions and the rest")


def measure(name: str, fn, iters: int):
    fn()                                  # warm-up: cuBLAS plans, allocator
    torch.cuda.synchronize()
    # repro: allow(DB001): the profiler's host time is a real measurement
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    # repro: allow(DB001): the profiler's host time is a real measurement
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    by_kind: dict = {}
    launches = 0
    for e in kernels:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3 / iters
        launches += e.count
    print(f"[{name}] host {host_ms:.3f} ms/call, device {dev_ms:.3f} ms/call, "
          f"device idle {max(0.0, 1 - dev_ms / host_ms):.1%}, "
          f"{launches / iters:.0f} kernel launches/call")
    for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   {k}: {ms:.3f} ms ({ms / dev_ms:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{name}]   {e.self_device_time_total / 1e3 / iters:8.3f} ms "
              f"x{e.count // iters:<4d} {e.key[:100]}")
    return host_ms, dev_ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full depth)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profiling measures the card; it needs cuda")

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, device=dev)
    batch = make_batch(cfg, gen, args.batch, args.seq)
    pos = args.seq // cfg.dec_len_ratio if cfg.encoder_decoder else args.seq
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    nxt, cache = prefill(model, batch)
    tok = nxt[:, None]
    measure(f"prefill {args.batch}x{args.seq}", lambda: prefill(model, batch),
            args.iters)
    measure(f"decode batch {args.batch}",
            lambda: decode(model, cache, tok, pos), args.iters)


if __name__ == "__main__":
    main()
