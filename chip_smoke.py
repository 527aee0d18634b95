#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (it is written for the H100: the kernels are built for
``sm_90a``) and ``nvcc``.  It exits non-zero, printing no result, when
``torch.cuda.is_available()`` is false or the port cannot be imported.  Any
failed check raises and ends the run: no phase carries on after an error.

Phases:
  1. device: the card's name and power limit (nvidia-smi); every kernel of the
     port built from ``src/repro_torch/kernels/**/csrc`` with nvcc.
  2. kernel vs plain version on the card, tf32 off: the flash attention sweep
     of tests/test_kernels.py in f32 and bf16, and gemma3-1b's prefill shapes
     (local and global layers), timed with CUDA events beside the plain
     version and one PyTorch library call (scaled_dot_product_attention with
     an explicit boolean mask, a yardstick the port never calls).
  3. prefill: gemma3-1b at full width (random weights from a seeded
     torch.Generator), 4 prompts of 1024 tokens through build_prefill_step;
     the flash kernel must launch once per layer (26 times).
  4. decode: 8 steps of build_decode_step from the prefill cache.
  5. engine: a full-width ServingEngine answers 4 requests.
  6. reference: the full-width prefill with the plain attention version in
     place of the kernel, and the gemma3-1b smoke config on the card against
     the port on the CPU, agree within the bf16 tolerance.
Then one JSON line describing each kernel, and last the device line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
TOL = {"float32": 3e-5, "bfloat16": 2.5e-2}     # tests/test_kernels.py
MODEL_TOL = 5e-2              # bf16 model tolerance of the port's tests
# tests/test_kernels.py:19-26: (BK, S, G, hd, window, softcap)
SWEEP = [(2, 256, 4, 64, 0, 0.0), (2, 256, 1, 64, 64, 0.0),
         (3, 128, 2, 32, 0, 50.0), (1, 512, 6, 128, 128, 30.0),
         (2, 192, 2, 64, 96, 0.0)]


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(BK, S, G, hd, window):
    """Least time (ms) the card could take for one causal bf16 flash call,
    and what bounds it: the operations the allowed (q, kv) pairs need (two
    products of 2*hd each) at the bf16 tensor-core rate, against q, k, v
    read once and o written once at the HBM rate."""
    pairs = sum(min(s + 1, window) if window else s + 1 for s in range(S))
    flops = 4 * hd * BK * G * pairs
    nbytes = (2 * BK * S * G * hd + 2 * BK * S * hd) * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def cache_leaves(cache):
    return [e[n] for part in ("blocks", "tail") for e in cache[part]
            for n in sorted(e)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import (flash_attention_bkg,
                                                     flash_attention_ref)
    from repro_torch.models import attention as attn
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.steps import build_decode_step, build_prefill_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device and build -------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    built = cuda_lib.build()
    print(f"[build] nvcc built {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in cuda_lib.SOURCES:
        for line in cuda_lib.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 2. kernel vs plain version --------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[kernels] tf32 off (matmul and cudnn): f32 comparisons are full f32")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sweep_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        worst = 0.0
        for BK, S, G, hd, win, cap in SWEEP:
            q, k, v = randn((BK, S, G, hd), dtype), randn((BK, S, hd), dtype), \
                randn((BK, S, hd), dtype)
            kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
            o = flash_attention_bkg(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            check(o.dtype == dtype and o.shape == q.shape, "kernel output type")
            check(err <= TOL[dname], f"sweep {dname} {(BK, S, G, hd, win, cap)}"
                                     f" max err {err} > {TOL[dname]}")
            worst = max(worst, err)
        sweep_err[dname] = worst
        print(f"[kernels] sweep {dname}: max abs err {worst:.3g} "
              f"(tol {TOL[dname]})")

    cfg = get_config("gemma3-1b")
    B, S = 4, 1024
    BK, G, hd = B * cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    main_shapes = {}
    for label, win in (("local", cfg.window_size), ("global", 0)):
        q = randn((BK, S, G, hd), torch.bfloat16)
        k, v = randn((BK, S, hd), torch.bfloat16), randn((BK, S, hd), torch.bfloat16)
        kw = dict(scale=hd ** -0.5, softcap=0.0, window=win)
        o = flash_attention_bkg(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        check(err <= TOL["bfloat16"], f"gemma3 {label} max err {err}")
        pos = torch.arange(S, device=dev)
        allow = pos[None, :] <= pos[:, None]
        if win:
            allow &= pos[None, :] > pos[:, None] - win
        qs = q.permute(0, 2, 1, 3)
        ks = k[:, None].expand(BK, G, S, hd)
        vs = v[:, None].expand(BK, G, S, hd)
        lib_err = (F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=allow, scale=kw["scale"]).permute(0, 2, 1, 3)
            .float() - ref.float()).abs().max().item()
        bound, bound_by = flash_bound(BK, S, G, hd, win)
        row = {
            "shape": f"BK={BK} Sq=Skv={S} G={G} hd={hd} bf16 window={win}",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_attention_bkg(q, k, v, **kw)),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(q, k, v, **kw)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=allow, scale=kw["scale"])),
            "bound_ms": bound, "bound_by": bound_by,
        }
        main_shapes[label] = row
        print(f"[kernels] gemma3-1b {label}: {row['shape']}: max abs err "
              f"{err:.3g}, kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.4f}, library_ms {row['library_ms']:.4f} "
              f"(library err {lib_err:.3g}), bound_ms {bound:.5f} "
              f"({bound_by}), {bound / row['ms']:.1%} of bound")

    # ---- 3. prefill at full width ------------------------------------------
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[prefill] gemma3-1b full width: {n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    tokens = torch.tensor(rng.integers(2, cfg.vocab_size, (B, S)),
                          dtype=torch.int32, device=dev)
    prefill = build_prefill_step(cfg)
    prefill(model, {"tokens": tokens})            # warm-up
    torch.cuda.synchronize()

    cuda_lib.launches.clear()                     # the main path starts here
    t0 = time.perf_counter()
    next_tok, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = cuda_lib.launches["flash_attention"]
    check(prefill_launches == cfg.n_layers,
          f"flash kernel launched {prefill_launches} times in one prefill, "
          f"want {cfg.n_layers}")
    check(next_tok.shape == (B,) and
          bool(((next_tok >= 0) & (next_tok < cfg.vocab_size)).all()),
          "prefill next tokens")
    leaves = cache_leaves(cache)
    for j, kind in enumerate(cfg.layer_pattern):
        L = cfg.window_size if kind == "local" else S
        want = (cfg.n_superblocks, B, L, cfg.n_kv_heads, hd)
        check(tuple(cache["blocks"][j]["k"].shape) == want,
              f"cache block {j} shape {tuple(cache['blocks'][j]['k'].shape)}")
    check(len(cache["tail"]) == cfg.n_tail, "cache tail")
    check(all(bool(torch.isfinite(t).all()) for t in leaves), "cache finite")
    print(f"[prefill] {B}x{S} tokens: {prefill_ms:.1f} ms "
          f"({B * S / prefill_ms * 1e3:.0f} tok/s), flash launches "
          f"{prefill_launches}")

    # ---- 4. decode from the prefill cache -----------------------------------
    decode = build_decode_step(cfg)
    tok = next_tok[:, None]
    step_ms = []
    for i in range(8):
        t0 = time.perf_counter()
        tok, cache = decode(model, cache, tok, S + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    logits, cache = forward_decode(model, cfg, cache, tok, S + 8)
    torch.cuda.synchronize()
    check(logits.shape == (B, 1, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), "decode logits finite")
    med = float(np.median(step_ms))
    print(f"[decode] 8 steps at batch {B}: median {med:.2f} ms/step "
          f"({med / B:.3f} ms/token, {B / med * 1e3:.0f} tok/s); "
          f"steps ms {[round(t, 2) for t in step_ms]}")

    # ---- 5. engine ------------------------------------------------------------
    eng = ServingEngine(cfg, model, n_slots=4, max_len=128, device=dev)
    for i in range(4):
        prompt = rng.integers(2, cfg.vocab_size, size=int(rng.integers(3, 9)))
        eng.submit(Request(i, prompt.astype(np.int32), max_new=8))
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done)
    check(sorted(r.req_id for r in done) == [0, 1, 2, 3],
          "engine completed every request")
    check(all(1 <= len(r.tokens_out) <= 8 and
              all(0 <= t < cfg.vocab_size for t in r.tokens_out) for r in done),
          "engine tokens")
    main_launches = cuda_lib.launches["flash_attention"]
    check(main_launches == prefill_launches,
          f"decode and engine launched the flash kernel "
          f"{main_launches - prefill_launches} times, want 0")
    print(f"[engine] {len(done)} requests, {n_tok} tokens in {eng_s:.2f} s "
          f"({n_tok / eng_s:.1f} generated tok/s, prompts fed token by token)")

    # ---- 6. against the plain version -----------------------------------------
    def plain_impl(q, k, v, *, window, softcap, scale):
        Bq, Sq, K, Gq, hdq = q.shape
        qf = q.permute(0, 2, 1, 3, 4).reshape(Bq * K, Sq, Gq, hdq)
        kf = k.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
        vf = v.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
        o = flash_attention_ref(qf, kf, vf, scale=scale, softcap=softcap,
                                window=window)
        return o.reshape(Bq, K, Sq, Gq, hdq).permute(0, 2, 1, 3, 4)

    kernel_logits, _ = forward_prefill(model, cfg, {"tokens": tokens})
    attn.set_attention_impl(plain_impl)
    try:
        forward_prefill(model, cfg, {"tokens": tokens})        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits, _ = forward_prefill(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        kernels.enable_flash_attention()
    full_err = rel_err(torch, kernel_logits, plain_logits)
    check(bool(torch.isfinite(kernel_logits).all()) and full_err <= MODEL_TOL,
          f"full-width logits, kernel vs plain: relative error {full_err}")
    print(f"[reference] full width, kernel vs plain attention: logits "
          f"relative error {full_err:.3g} (tol {MODEL_TOL}); prefill with "
          f"the plain version {plain_prefill_ms:.1f} ms vs {prefill_ms:.1f} ms")

    small = get_smoke_config("gemma3-1b")
    cpu_model = init_params(small, torch.Generator().manual_seed(SEED),
                            device="cpu")
    small_tok = torch.tensor(rng.integers(2, small.vocab_size, (2, 64)),
                             dtype=torch.int32)
    cl, ccache = forward_prefill(cpu_model, small, {"tokens": small_tok})
    gl, gcache = forward_prefill(cpu_model.to(dev), small,
                                 {"tokens": small_tok.to(dev)})
    torch.cuda.synchronize()
    small_err = (gl.float().cpu() - cl.float()).abs().max().item()
    cache_err = max(rel_err(torch, g.cpu(), c)
                    for g, c in zip(cache_leaves(gcache), cache_leaves(ccache)))
    check(small_err <= MODEL_TOL and cache_err <= MODEL_TOL,
          f"smoke config card vs cpu: logits {small_err}, cache {cache_err}")
    print(f"[reference] gemma3-1b smoke config, card (kernel) vs CPU (plain): "
          f"logits max abs err {small_err:.3g}, cache relative error "
          f"{cache_err:.3g} (tol {MODEL_TOL})")

    g, loc = main_shapes["global"], main_shapes["local"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": main_launches,
        "max_abs_err": max(g["max_abs_err"], loc["max_abs_err"]),
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": g["shape"], "local": loc, "sweep_max_abs_err": sweep_err,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
