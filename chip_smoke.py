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
     port built from ``src/repro_torch/kernels/**/csrc`` with nvcc, all at once.
  2. kernel vs plain version on the card, tf32 off, each timed with CUDA
     events beside its plain version and its bound:
     - flash attention: the sweep of tests/test_kernels.py in f32 (the
       CUDA-core kernel) and bf16 (the tensor-core kernel), gemma3-1b's
       prefill shapes (local and global layers) and recurrentgemma-2b's
       local layer (G=10, window 2048), each also beside one PyTorch library
       call (scaled_dot_product_attention with an explicit boolean mask, a
       yardstick the port never calls) and beside the CUDA-core kernel on
       the same bf16 inputs (the earlier design);
     - the RG-LRU scan: the channel-group TMA kernel (the wrappers' route)
       and the earlier one-thread-per-channel kernel, over test_rglru_kernel's
       sweep, ragged C, a near 1 (also at the prefill shape) and
       recurrentgemma-2b's prefill shape, against the plain version run in
       f64;
     - the wkv6: the chunked tensor-core kernel (the wrappers' route, 3xTF32)
       and the earlier sequential kernel, over test_wkv6_kernel's sweep, the
       edges (S = 1, ragged S, logw all -5, all -1e-4, all -40) and
       rwkv6-7b's prefill shape, output and final state against the plain
       version run in f64, and the tensor-core kernel against its numerics'
       plain version (``wkv6_chunk_ref``).
     Each kept earlier design is timed on the same inputs beside the new one.
  Then, for gemma3-1b, recurrentgemma-2b and rwkv6-7b in turn, at full width
  and depth (random weights from a seeded torch.Generator), each model freed
  before the next:
  3. prefill: 4 prompts of 1024 tokens through build_prefill_step; every
     kernel must launch exactly once per layer of its kind (gemma3-1b: flash
     26; recurrentgemma-2b: rglru_scan 18, flash 8; rwkv6-7b: wkv6 32), and
     every launch must be the new design's (flash: tensor cores; the scan:
     channel groups; the wkv6: chunked), never an earlier one's.
  4. decode: 8 steps of build_decode_step from the prefill cache.
  5. engine: a full-width ServingEngine answers 4 requests.
  6. reference: the full-width prefill with the path's kernel swapped for its
     plain version (flash for gemma3-1b, the recurrent kernel for the other
     two), and the smoke config on the card against the port on the CPU,
     agree within the bf16 model tolerance.  On the recurrent paths every
     kernel call of a full-width bf16 prefill is also held against its plain
     version on the same inputs, and the full-width logits are compared
     with f32 weights: in bf16 a random 32-layer RWKV stack amplifies
     rounding-level differences past any useful tolerance.  recurrentgemma-2b
     also holds its bf16 logits with flash swapped for its plain version (the
     tensor-core kernel on, in bf16: f32 weights would route flash to the
     CUDA-core kernel).
Then one JSON line describing each kernel, and last the device line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
TOL = {"float32": 3e-5, "bfloat16": 2.5e-2}     # tests/test_kernels.py
RGLRU_TOL = 2e-5              # tests/test_kernels.py::test_rglru_kernel
WKV6_TOL = 1e-3               # tests/test_kernels.py::test_wkv6_kernel
MODEL_TOL = 5e-2              # bf16 model tolerance of the port's tests
# tests/test_kernels.py:19-26: (BK, S, G, hd, window, softcap)
SWEEP = [(2, 256, 4, 64, 0, 0.0), (2, 256, 1, 64, 64, 0.0),
         (3, 128, 2, 32, 0, 50.0), (1, 512, 6, 128, 128, 30.0),
         (2, 192, 2, 64, 96, 0.0)]
# (B, S, C, a near 1): test_rglru_kernel's sweep, then ragged C (C % 4 != 0;
# a last group of 4 channels) and a near 1, also at the prefill shape
RGLRU_SWEEP = [(2, 256, 128, False), (1, 128, 512, False), (3, 64, 96, False),
               (4, 100, 2562, False), (3, 50, 2564, True), (2, 256, 128, True),
               (4, 1024, 2560, True)]
# where the earlier one-thread-per-channel scan misses 2e-5 (a known defect,
# on no model path): its f32 carry rounds every step, and with a near 1 over
# 1024 steps nothing decays those roundings
THREAD_DRIFTS = {(4, 1024, 2560, True)}
# (BH, S, hd, logw value or None): test_wkv6_kernel's sweep, then the edges
WKV6_SWEEP = [(2, 128, 32, None), (4, 256, 64, None), (1, 64, 16, None),
              (2, 96, 32, None), (3, 1, 64, None), (3, 37, 64, None),
              (4, 512, 64, -5.0), (4, 1024, 64, -1e-4), (2, 64, 32, -40.0)]
# where the earlier sequential wkv6 kernel misses 1e-3 (a known defect, on no
# model path): it multiplies the state by the f32-rounded exp(logw) once a
# step, and at logw = -1e-4 that rounding compounds over 1024 steps
SEQ_COMPOUNDS = {(4, 1024, 64, -1e-4)}
B, S = 4, 1024                # prompts and their length on the main paths
PATHS = {                     # arch -> the kernels its prefill must launch
    "gemma3-1b": {"flash_attention": 26, "flash_attention:wgmma": 26,
                  "flash_attention:fma": 0},
    "recurrentgemma-2b": {"rglru_scan": 18, "rglru_scan:grouped": 18,
                          "rglru_scan:thread": 0, "flash_attention": 8,
                          "flash_attention:wgmma": 8, "flash_attention:fma": 0},
    "rwkv6-7b": {"wkv6": 32, "wkv6:chunk": 32, "wkv6:seq": 0},
}
SWAPPED = {"gemma3-1b": "flash_attention", "recurrentgemma-2b": "rglru_scan",
           "rwkv6-7b": "wkv6"}     # the kernel phase 6 swaps for its plain version
RECURRENT = ("recurrentgemma-2b", "rwkv6-7b")
NO_LIBRARY = ("no single PyTorch call computes the RG-LRU scan or the wkv6 "
              "recurrence, so their library_ms is null")


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


def bound(flops: float, peak_flops: float, nbytes: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound(BK, S, G, hd, window):
    """One causal bf16 flash call: the operations the allowed (q, kv) pairs
    need (two products of 2*hd each) at the bf16 tensor-core rate, against
    q, k, v read once and o written once at the HBM rate."""
    pairs = sum(min(s + 1, window) if window else s + 1 for s in range(S))
    flops = 4 * hd * BK * G * pairs
    nbytes = (2 * BK * S * G * hd + 2 * BK * S * hd) * 2
    return bound(flops, PEAK_BF16_FLOPS, nbytes)


def rglru_bound(B, S, C):
    """a and b read once and h written once in f32, one FMA per element."""
    return bound(2 * B * S * C, PEAK_F32_FLOPS, 3 * B * S * C * 4)


def wkv6_bound(BH, S, hd):
    """r, k, v, logw read once, y and the final state written once, u read,
    in f32; per step and head 4 operations per state element (the two FMAs
    of y, the product k v and the decay FMA) and one exp per key channel."""
    flops = 4 * BH * S * hd * hd + BH * S * hd
    nbytes = (5 * BH * S * hd + BH * hd + BH * hd * hd) * 4
    return bound(flops, PEAK_F32_FLOPS, nbytes)


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_excess(torch, got, want, tol) -> float:
    """max |got - want| - tol * |want|: <= tol passes allclose(atol=rtol=tol)."""
    return float(((got.double() - want.double()).abs()
                  - tol * want.double().abs()).max())


def cache_leaves(cache):
    return [e[n] for part in ("blocks", "tail") for e in cache[part]
            for n in sorted(e)]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_flash(torch, F, randn, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import (
        flash_attention_bkg, flash_attention_ref, flash_attention_wgmma_ref,
        variant)
    from repro_torch.kernels.flash_attention.ops import flash_attention_fma

    def launch(q, k, v, **kw):
        """The wrapper's route, checked to launch the variant of the rule."""
        which = f"flash_attention:{variant(q.dtype, q.shape[-1])}"
        before = cuda_lib.launches[which]
        o = flash_attention_bkg(q, k, v, **kw)
        check(cuda_lib.launches[which] == before + 1, f"{which} launched")
        return o, which.split(":")[1]

    sweep_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        worst, used = 0.0, set()
        for BK, Sq, G, hd, win, cap in SWEEP:
            q, k, v = randn((BK, Sq, G, hd), dtype), randn((BK, Sq, hd), dtype), \
                randn((BK, Sq, hd), dtype)
            kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
            o, which = launch(q, k, v, **kw)
            used.add(which)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            check(o.dtype == dtype and o.shape == q.shape, "kernel output type")
            check(err <= TOL[dname], f"sweep {dname} {(BK, Sq, G, hd, win, cap)}"
                                     f" max err {err} > {TOL[dname]}")
            worst = max(worst, err)
        check(used == {"fma" if dtype == torch.float32 else "wgmma"},
              f"sweep {dname} took {used}")
        sweep_err[dname] = worst
        print(f"[kernels] flash sweep {dname} ({'/'.join(used)} kernel): max abs "
              f"err {worst:.3g} (tol {TOL[dname]})")

    rows = {}
    gemma3, rgemma = get_config("gemma3-1b"), get_config("recurrentgemma-2b")
    for label, cfg, win in (("local", gemma3, gemma3.window_size),
                            ("global", gemma3, 0),
                            ("recurrentgemma_local", rgemma, rgemma.window_size)):
        BK, G, hd = B * cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
        q = randn((BK, S, G, hd), torch.bfloat16)
        k, v = randn((BK, S, hd), torch.bfloat16), randn((BK, S, hd), torch.bfloat16)
        kw = dict(scale=hd ** -0.5, softcap=0.0, window=win)
        o, which = launch(q, k, v, **kw)
        check(which == "wgmma", f"{cfg.name} {label} took the {which} kernel")
        ref = flash_attention_ref(q, k, v, **kw)
        emu = flash_attention_wgmma_ref(q, k, v, **kw)
        fma = flash_attention_fma(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        emu_err = (o.float() - emu.float()).abs().max().item()
        fma_err = (fma.float() - ref.float()).abs().max().item()
        check(err <= TOL["bfloat16"], f"{cfg.name} {label} max err {err}")
        check(fma_err <= TOL["bfloat16"],
              f"{cfg.name} {label} CUDA-core kernel max err {fma_err}")
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
        bound_ms, bound_by = flash_bound(BK, S, G, hd, win)
        row = {
            "shape": f"BK={BK} Sq=Skv={S} G={G} hd={hd} bf16 window={win}",
            "variant": which, "max_abs_err": err,
            "emulation_max_abs_err": emu_err,
            "ms": time_ms(torch, lambda: flash_attention_bkg(q, k, v, **kw)),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(q, k, v, **kw)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=allow, scale=kw["scale"])),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        row["earlier_design"] = {
            "variant": "fma", "max_abs_err": fma_err,
            "ms": time_ms(torch, lambda: flash_attention_fma(q, k, v, **kw)),
        }
        rows[label] = row
        print(f"[kernels] flash {cfg.name} {label}: {row['shape']}: {which} "
              f"kernel max abs err {err:.3g} (vs its numerics' plain version "
              f"{emu_err:.3g}), kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.4f}, library_ms {row['library_ms']:.4f} "
              f"(library err {lib_err:.3g}), kernel_ms / library_ms "
              f"{row['ms'] / row['library_ms']:.3f}, bound_ms {bound_ms:.5f} "
              f"({bound_by}), {bound_ms / row['ms']:.1%} of bound; CUDA-core "
              f"kernel {row['earlier_design']['ms']:.4f} ms (max abs err "
              f"{fma_err:.3g})")
    return sweep_err, rows


def check_rglru(torch, randn):
    """The channel-group kernel (the wrapper's route) and the earlier
    one-thread-per-channel kernel against the plain version run in f64 (in
    f32 its own rounding drifts past 2e-5 where a is near 1 over 1024
    steps); returns the row of each at recurrentgemma-2b's prefill shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rglru_scan import rglru_scan_bsc, rglru_scan_ref
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_thread

    def inputs(shape, near_one=False):
        x = randn(shape, torch.float32)
        a = 1 - torch.sigmoid(x) * 1e-3 if near_one else torch.sigmoid(x)
        return a, randn(shape, torch.float32)

    def compare(a, b, what, thread_held=True):
        before = dict(cuda_lib.launches)
        h, h_thread = rglru_scan_bsc(a, b), rglru_scan_thread(a, b)
        ref = rglru_scan_ref(a.double(), b.double())
        torch.cuda.synchronize()
        for name, n in (("rglru_scan:grouped", 1), ("rglru_scan:thread", 1)):
            check(cuda_lib.launches[name] == before.get(name, 0) + n,
                  f"{name} launched")
        check(h.dtype == torch.float32 and h.shape == a.shape, "rglru output")
        held = [(h, "grouped")] + [(h_thread, "thread")] * thread_held
        for got, which in held:
            check(max_excess(torch, got, ref, RGLRU_TOL) <= RGLRU_TOL,
                  f"rglru {which} {what}")
        return tuple((got.double() - ref).abs().max().item()
                     for got in (h, h_thread))
    sweep = [0.0, 0.0]
    for case in RGLRU_SWEEP:
        held = case not in THREAD_DRIFTS
        errs = compare(*inputs(case[:3], case[3]), case, held)
        if not held:
            print(f"[kernels] rglru_scan sweep {case}: the earlier kernel's "
                  f"f32 carry drifts (known defect, on no model path): max "
                  f"abs err {errs[1]:.3g}, not held; grouped {errs[0]:.3g}")
        sweep = [max(sweep[0], errs[0]), max(sweep[1], errs[1]) if held
                 else sweep[1]]
    print(f"[kernels] rglru_scan sweep: max abs err {sweep[0]:.3g} (grouped), "
          f"{sweep[1]:.3g} (thread, held cases) (tol {RGLRU_TOL}, against "
          f"the plain version in f64)")
    cfg = get_config("recurrentgemma-2b")
    shape = (B, S, cfg.d_rnn)
    a, b = inputs(shape)
    err, err_thread = compare(a, b, f"{cfg.name} prefill shape {shape}")
    bound_ms, bound_by = rglru_bound(*shape)
    common = {"shape": f"B={shape[0]} S={shape[1]} C={shape[2]} f32",
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    plain_ms = time_ms(torch, lambda: rglru_scan_ref(a, b))
    # the two kernels in turns, new, old, old, new
    t = [time_ms(torch, lambda f=f: f(a, b)) for f in
         (rglru_scan_bsc, rglru_scan_thread, rglru_scan_thread, rglru_scan_bsc)]
    rows = {"grouped": {**common, "max_abs_err": err, "sweep_max_abs_err":
                        sweep[0], "ms": (t[0] + t[3]) / 2, "plain_ms": plain_ms},
            "thread": {**common, "max_abs_err": err_thread,
                       "sweep_max_abs_err": sweep[1], "ms": (t[1] + t[2]) / 2,
                       "plain_ms": plain_ms}}
    for which, row in rows.items():
        print(f"[kernels] rglru_scan ({which}) {cfg.name}: {row['shape']}: max "
              f"abs err {row['max_abs_err']:.3g}, kernel_ms {row['ms']:.4f}, "
              f"plain_ms {plain_ms:.4f}, bound_ms {bound_ms:.5f} ({bound_by}), "
              f"{bound_ms / row['ms']:.1%} of bound")
    return rows


def check_wkv6(torch, randn):
    """The chunked tensor-core kernel (the wrapper's route) and the earlier
    sequential kernel against the plain version, run in f64 (in f32 its own
    rounding, added to a kernel's, passes 1e-3 where y crosses 0 after 1024
    steps of slow decay); returns the row of each at rwkv6-7b's prefill
    shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rwkv6_chunk import wkv6_bh, wkv6_chunk_ref, wkv6_ref
    from repro_torch.kernels.rwkv6_chunk.ops import wkv6_seq

    def inputs(BH, Sq, hd, logw_value=None):
        r, k, v = (randn((BH, Sq, hd), torch.float32) for _ in range(3))
        logw = torch.clamp(-torch.exp(randn((BH, Sq, hd), torch.float32) * 0.5),
                           -5.0, -1e-4)
        if logw_value is not None:
            logw = torch.full_like(logw, logw_value)
        return r, k, v, logw, randn((BH, hd), torch.float32) * 0.1

    def compare(ins, what):
        before = dict(cuda_lib.launches)
        y, st = wkv6_bh(*ins)
        y_seq, st_seq = wkv6_seq(*ins)
        torch.cuda.synchronize()
        for name, n in (("wkv6:chunk", 1), ("wkv6:seq", 1)):
            check(cuda_lib.launches[name] == before.get(name, 0) + n,
                  f"{name} launched")
        y_ref, st_ref = wkv6_ref(*(t.double() for t in ins))
        check(y.shape == ins[0].shape and st.shape == st_ref.shape,
              f"wkv6 output shapes {what}")
        errs = []
        for got_y, got_st, which in ((y, st, "chunk"), (y_seq, st_seq, "seq")):
            errs.append(((got_y.double() - y_ref).abs().max().item(),
                         (got_st.double() - st_ref).abs().max().item()))
            if which == "seq" and what in SEQ_COMPOUNDS:
                print(f"[kernels] wkv6 (seq, the earlier design) at {what}: max "
                      f"abs err y {errs[-1][0]:.3g}, state {errs[-1][1]:.3g}, "
                      f"not held to {WKV6_TOL}: it compounds the rounding of "
                      f"exp(logw) once a step (a known defect, on no model "
                      f"path)")
                continue
            check(max_excess(torch, got_y.double(), y_ref, WKV6_TOL) <= WKV6_TOL,
                  f"wkv6 {which} y {what}")
            check(max_excess(torch, got_st.double(), st_ref, WKV6_TOL) <= WKV6_TOL,
                  f"wkv6 {which} final state {what}")
        return errs
    sweep = [0.0, 0.0]
    for case in WKV6_SWEEP:
        errs = compare(inputs(*case), case)
        if case in SEQ_COMPOUNDS:
            errs[1] = (0.0, 0.0)
        sweep = [max(x, *e) for x, e in zip(sweep, errs)]
    print(f"[kernels] wkv6 sweep and edges (y and final state, against the plain "
          f"version in f64): max abs err {sweep[0]:.3g} (chunk), {sweep[1]:.3g} "
          f"(seq) (tol {WKV6_TOL})")
    cfg = get_config("rwkv6-7b")
    hd = cfg.rwkv_head_dim
    shape = (B * cfg.d_model // hd, S, hd)
    ins = inputs(*shape)
    (y_err, st_err), (seq_y_err, seq_st_err) = compare(
        ins, f"{cfg.name} prefill shape {shape}")
    y, _ = wkv6_bh(*ins)
    emu_err = (y - wkv6_chunk_ref(*ins)[0]).abs().max().item()
    bound_ms, bound_by = wkv6_bound(*shape)
    common = {"shape": f"BH={shape[0]} S={shape[1]} hd={hd} f32",
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    plain_ms = time_ms(torch, lambda: wkv6_ref(*ins), iters=5)
    t = [time_ms(torch, lambda f=f: f(*ins)) for f in
         (wkv6_bh, wkv6_seq, wkv6_seq, wkv6_bh)]
    rows = {"chunk": {**common, "max_abs_err": max(y_err, st_err),
                      "state_max_abs_err": st_err, "sweep_max_abs_err": sweep[0],
                      "emulation_max_abs_err": emu_err,
                      "ms": (t[0] + t[3]) / 2, "plain_ms": plain_ms},
            "seq": {**common, "max_abs_err": max(seq_y_err, seq_st_err),
                    "state_max_abs_err": seq_st_err,
                    "sweep_max_abs_err": sweep[1], "ms": (t[1] + t[2]) / 2,
                    "plain_ms": plain_ms}}
    print(f"[kernels] wkv6 (chunk) vs its numerics' plain version "
          f"(wkv6_chunk_ref, 3xTF32): max abs err {emu_err:.3g}")
    for which, row in rows.items():
        print(f"[kernels] wkv6 ({which}) {cfg.name}: {row['shape']}: max abs err "
              f"{row['max_abs_err']:.3g} (state {row['state_max_abs_err']:.3g}), "
              f"kernel_ms {row['ms']:.4f}, plain_ms {plain_ms:.4f}, bound_ms "
              f"{bound_ms:.5f} ({bound_by}), {bound_ms / row['ms']:.1%} of bound")
    return rows


# ---------------------------------------------------------------------------
# phases 3-6: one model's serving path
# ---------------------------------------------------------------------------
def recurrent_kernel(arch):
    """(ops module, name of the kernel wrapper the model-facing wrapper
    calls, its plain version, tolerance) of a recurrent path's kernel."""
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_chunk import ops as wkv6_ops
    if arch == "recurrentgemma-2b":
        return rglru_ops, "rglru_scan_bsc", rglru_ops.rglru_scan_ref, RGLRU_TOL
    return wkv6_ops, "wkv6_bh", wkv6_ops.wkv6_ref, WKV6_TOL


def swap_for_plain(arch, kernel=None):
    """Put the plain version of ``kernel`` (default: the one phase 6 swaps
    on ``arch``'s path) where the model calls the kernel; returns the
    function that puts the kernel back."""
    if (kernel or SWAPPED[arch]) != "flash_attention":
        mod, name, plain, _ = recurrent_kernel(arch)
        kernel = getattr(mod, name)
        setattr(mod, name, plain)
        return lambda: setattr(mod, name, kernel)
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention as attn

    def plain_impl(q, k, v, *, window, softcap, scale):
        Bq, Sq, K, Gq, hdq = q.shape
        qf = q.permute(0, 2, 1, 3, 4).reshape(Bq * K, Sq, Gq, hdq)
        kf = k.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
        vf = v.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
        o = flash_attention_ref(qf, kf, vf, scale=scale, softcap=softcap,
                                window=window)
        return o.reshape(Bq, K, Sq, Gq, hdq).permute(0, 2, 1, 3, 4)
    attn.set_attention_impl(plain_impl)
    return kernels.enable_flash_attention


def shadow_with_plain(torch, arch, errs):
    """Make every call of the path's recurrent kernel also run its plain
    version on the same inputs and append (max abs err, allclose excess) of
    each output to ``errs``; returns the function that undoes it."""
    mod, name, plain, tol = recurrent_kernel(arch)
    kernel = getattr(mod, name)

    def both(*args):
        out, want = kernel(*args), plain(*args)
        for o, w in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            errs.append(((o - w).abs().max().item(),
                         max_excess(torch, o, w, tol)))
        return out
    setattr(mod, name, both)
    return lambda: setattr(mod, name, kernel)


def serve_path(torch, np, dev, arch):
    """Prefill, decode, engine and reference of one architecture at full
    width.  Returns the launches its main path made, by kernel."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.steps import build_decode_step, build_prefill_step

    cfg = get_config(arch)
    want = {name: n for name, n in PATHS[arch].items() if n}
    # ---- 3. prefill at full width ------------------------------------------
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[prefill] {arch} full width: {n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    tokens = torch.tensor(rng.integers(2, cfg.vocab_size, (B, S)),
                          dtype=torch.int32, device=dev)
    prefill = build_prefill_step(cfg)
    prefill(model, {"tokens": tokens})            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)

    cuda_lib.launches.clear()                     # the main path starts here
    t0 = time.perf_counter()
    next_tok, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {name: n for name, n in cuda_lib.launches.items() if n}
    check(prefill_launches == want,
          f"{arch} prefill launched {prefill_launches}, want {PATHS[arch]}")
    check(next_tok.shape == (B,) and
          bool(((next_tok >= 0) & (next_tok < cfg.vocab_size)).all()),
          "prefill next tokens")
    for j, kind in enumerate(cfg.layer_pattern):
        if kind in ("local", "global"):
            L = min(cfg.window_size, S) if kind == "local" else S
            shape = (cfg.n_superblocks, B, L, cfg.n_kv_heads, cfg.head_dim)
            got = tuple(cache["blocks"][j]["k"].shape)
            check(got == shape, f"cache block {j} shape {got}, want {shape}")
    check(len(cache["tail"]) == cfg.n_tail, "cache tail")
    check(all(bool(torch.isfinite(t).all()) for t in cache_leaves(cache)),
          "cache finite")
    peak_gb = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    print(f"[prefill] {arch} {B}x{S} tokens: {prefill_ms:.1f} ms "
          f"({B * S / prefill_ms * 1e3:.0f} tok/s), launches "
          f"{prefill_launches}, peak memory above the weights "
          f"{peak_gb:.2f} GB")

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
    print(f"[decode] {arch} 8 steps at batch {B}: median {med:.2f} ms/step "
          f"({med / B:.3f} ms/token, {B / med * 1e3:.0f} tok/s); "
          f"steps ms {[round(t, 2) for t in step_ms]}")
    del cache, logits

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
    main_launches = {name: n for name, n in cuda_lib.launches.items() if n}
    check(main_launches == prefill_launches,
          f"decode and engine launched kernels: {main_launches} after the "
          f"prefill's {prefill_launches}, want no more")
    print(f"[engine] {arch} {len(done)} requests, {n_tok} tokens in "
          f"{eng_s:.2f} s ({n_tok / eng_s:.1f} generated tok/s, prompts fed "
          f"token by token)")
    del eng

    # ---- 6. against the plain version -----------------------------------------
    calls = []
    restore = shadow_with_plain(torch, arch, calls) if arch in RECURRENT \
        else (lambda: None)
    try:
        kernel_logits, _ = forward_prefill(model, cfg, {"tokens": tokens})
    finally:
        restore()
    if arch in RECURRENT:
        tol = recurrent_kernel(arch)[3]
        n_out = 2 if arch == "rwkv6-7b" else 1          # wkv6 also has S_last
        check(len(calls) == want[SWAPPED[arch]] * n_out,
              f"{arch}: {len(calls)} kernel outputs compared")
        worst = max(e for e, _ in calls)
        check(max(x for _, x in calls) <= tol,
              f"{arch} full width, kernel vs plain on the same inputs, call "
              f"by call: max abs err {worst}")
        print(f"[reference] {arch} full width, each of the "
              f"{want[SWAPPED[arch]]} {SWAPPED[arch]} calls of a prefill "
              f"against its plain version on the same inputs: max abs err "
              f"{worst:.3g} (allclose tol {tol})")
    restore = swap_for_plain(arch)
    try:
        forward_prefill(model, cfg, {"tokens": tokens})        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits, _ = forward_prefill(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    full_err = rel_err(torch, kernel_logits, plain_logits)
    check(bool(torch.isfinite(kernel_logits).all()),
          f"{arch} full-width logits finite")
    # a random recurrent stack in bf16 amplifies the kernel's and the plain
    # version's f32 rounding differences layer by layer (rwkv6-7b: 0.59 after
    # 32 layers), so the recurrent paths compare their logits in f32 below
    check(arch in RECURRENT or full_err <= MODEL_TOL,
          f"{arch} full-width logits, kernel vs plain: relative error "
          f"{full_err}")
    checked = "bf16, not checked" if arch in RECURRENT else f"tol {MODEL_TOL}"
    print(f"[reference] {arch} full width, kernel vs plain {SWAPPED[arch]}: "
          f"logits relative error {full_err:.3g} ({checked}); prefill with "
          f"the plain version {plain_prefill_ms:.1f} ms vs {prefill_ms:.1f} ms")
    if "flash_attention" in want and SWAPPED[arch] != "flash_attention":
        restore = swap_for_plain(arch, "flash_attention")
        try:
            flash_plain_logits, _ = forward_prefill(model, cfg,
                                                    {"tokens": tokens})
        finally:
            restore()
        flash_err = rel_err(torch, kernel_logits, flash_plain_logits)
        check(flash_err <= MODEL_TOL, f"{arch} full-width bf16 logits, flash "
              f"kernel vs plain: relative error {flash_err}")
        print(f"[reference] {arch} full width in bf16, kernel vs plain "
              f"flash_attention: logits relative error {flash_err:.3g} (tol "
              f"{MODEL_TOL})")
        del flash_plain_logits
    del model, kernel_logits, plain_logits
    if arch in RECURRENT:
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        model = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        kernel_logits, _ = forward_prefill(model, cfg32, {"tokens": tokens})
        restore = swap_for_plain(arch)
        try:
            plain_logits, _ = forward_prefill(model, cfg32, {"tokens": tokens})
        finally:
            restore()
        f32_err = rel_err(torch, kernel_logits, plain_logits)
        check(bool(torch.isfinite(kernel_logits).all()) and f32_err <= MODEL_TOL,
              f"{arch} full-width f32 logits, kernel vs plain: relative error "
              f"{f32_err}")
        print(f"[reference] {arch} full width with f32 weights, kernel vs "
              f"plain {SWAPPED[arch]}: logits relative error {f32_err:.3g} "
              f"(tol {MODEL_TOL})")
        del model, kernel_logits, plain_logits

    small = get_smoke_config(arch)
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
          f"{arch} smoke config card vs cpu: logits {small_err}, cache "
          f"{cache_err}")
    print(f"[reference] {arch} smoke config, card (kernels) vs CPU (plain): "
          f"logits max abs err {small_err:.3g}, cache relative error "
          f"{cache_err:.3g} (tol {MODEL_TOL})")
    return main_launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import cuda_lib

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
        for fn, used, spill in cuda_lib.resources(name):
            print(f"[build] {name}: {fn}: {used}; {spill}")

    # ---- 2. kernel vs plain version --------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[kernels] tf32 off (matmul and cudnn): f32 comparisons are full f32")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash_sweep, flash_rows = check_flash(torch, F, randn, dev)
    rglru_rows = check_rglru(torch, randn)
    wkv6_rows = check_wkv6(torch, randn)
    print(f"[kernels] {NO_LIBRARY}")

    # ---- 3-6. the serving paths, one model at a time ---------------------
    launches = {}
    for arch in PATHS:
        launches[arch] = serve_path(torch, np, dev, arch)
        torch.cuda.empty_cache()

    def path_launches(name):
        by_path = {arch: n[name] for arch, n in launches.items() if name in n}
        return sum(by_path.values()), by_path

    g = flash_rows["global"]
    n_flash, flash_by_path = path_launches("flash_attention:wgmma")
    check(n_flash == path_launches("flash_attention")[0],
          "every flash launch of the main paths is the tensor-core kernel's")
    n_rglru, rglru_by_path = path_launches("rglru_scan:grouped")
    check(n_rglru == path_launches("rglru_scan")[0],
          "every scan launch of the main paths is the channel-group kernel's")
    n_wkv6, wkv6_by_path = path_launches("wkv6:chunk")
    check(n_wkv6 == path_launches("wkv6")[0],
          "every wkv6 launch of the main paths is the tensor-core kernel's")
    rec = "src/repro_torch/kernels/"
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "variant": g["variant"],
        "source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": n_flash, "launches_by_path": flash_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows.values()),
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": g["shape"], "earlier_design": {
            **g["earlier_design"], "source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"},
        "local": flash_rows["local"],
        "recurrentgemma_local": flash_rows["recurrentgemma_local"],
        "sweep_max_abs_err": flash_sweep,
    }, {
        "name": "rglru_scan", "route": "cuda", "variant": "grouped",
        "source": rec + "rglru_scan/csrc/rglru_scan_grouped.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
        "launches": n_rglru, "launches_by_path": rglru_by_path,
        **rglru_rows["grouped"],
    }, {
        "name": "rglru_scan:thread", "route": "cuda", "variant": "thread",
        "earlier_design_of": "rglru_scan",
        "source": rec + "rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
        "launches": path_launches("rglru_scan:thread")[0],
        **rglru_rows["thread"],
    }, {
        "name": "wkv6", "route": "cuda", "variant": "chunk",
        "source": rec + "rwkv6_chunk/csrc/wkv6_chunk.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk/kernel.py:72",
        "launches": n_wkv6, "launches_by_path": wkv6_by_path,
        **wkv6_rows["chunk"],
    }, {
        "name": "wkv6:seq", "route": "cuda", "variant": "seq",
        "earlier_design_of": "wkv6",
        "source": rec + "rwkv6_chunk/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk/kernel.py:72",
        "launches": path_launches("wkv6:seq")[0],
        **wkv6_rows["seq"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
