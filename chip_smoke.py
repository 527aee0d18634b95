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
  7. workflow: the flood-disaster workflow (``repro_torch.serverless``),
     which launches no kernel of the port (its convolutions are cuDNN's),
     with cuDNN's TF32 at PyTorch's default (the bodies pin their own
     convolutions to f32): each of its four bodies on the card against the
     same body on the CPU at 2, 10 and 50 MB (488, 2441 and 4096 frames), the
     keep mask exact, tensors to 1e-5, the alarm score to 1e-4, every output
     on the card, each body timed with CUDA events and the host clock (the
     first call apart), and what the bodies would give without their f32 pin
     (reported); one databelt instance at 10 MB through the engine on the
     card and on the CPU with the engine's clock stepped by a fixed amount,
     whose metrics must be identical; the Scenario front door with real
     compute on the card over Table 2's grid (sequential, 10 and 50 MB, three
     strategies) and Fig 13's point (stagger 0.05 s, 2 MB, n = 64), run
     three times: alone for the end-to-end numbers, with each body (ingest
     with its copy of the frames to the card) and make_payload (the host
     draw) timed inside the engine for the split of its real compute,
     and under torch.profiler for the device's idle share.  One JSON line
     holds it.
  8. frontdoor: ``python -m repro_torch.analysis src/repro_torch --strict``,
     ``--replay-smoke`` and ``--race-smoke`` (virtual specs), each exiting 0;
     ``Scenario.verify_races(device="cuda")`` on Fig 13's point with real
     compute (stagger 0.05 s, 2 MB, n = 64, databelt), which must be
     race-clean with every flood body run on the card once a mission;
     ``verify_replay(device="cuda")`` on the same spec, whose outcome is
     printed and not checked (real compute folds wall time into simulated
     time); the twins of examples/serve_pipeline.py on the card (8 requests
     answered; prompts are fed through decode, so no kernel launches) and
     examples/quickstart.py (virtual).  Each step's host time, beside the
     card's name and power limit, goes into one JSON line.
  9. train: h2o-danube-1.8b at full width (24 layers, remat "full", AdamW
     with f32 master weights, 4 x 2048 tokens from SyntheticTokens, a
     constant learning rate): the first step's loss and grad norm through the
     flash kernel against the same with the eager attention the reference
     trains through (2e-2, 5e-2 relative); 5 steps through build_train_step,
     each step's time, loss and grad norm (finite), flash launched twice a
     layer a step (forward and the remat recompute), every parameter with a
     finite grad, the median step time over steps 2-5, tokens/s, peak
     memory; one more step under torch.profiler split by kind (flash
     forward, the eager attention backward, matmul, elementwise, optimizer)
     with the device's idle share; flash at the training shape beside its
     plain version.  recurrentgemma-2b and rwkv6-7b at full width and one
     superblock: the same kernel-vs-plain check on the first step (the scan
     and flash, the wkv6) and one timed step whose launches are counted.  The
     smoke configs' train step in f32 on the card against the CPU (loss 1e-4,
     each grad leaf 1e-3 in relative norm).  One JSON line holds it.
  Phase 2 also holds each kernel's autograd function (the kernel forward, the
  plain version's autograd backward) against autograd of the plain version
  over the kernel's sweep, at the kernel's tolerance.
Then one JSON line describing each kernel (its launches summed over the
serving paths, serve_pipeline and the training paths, each counted from 0
just before its run), and
last the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
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
WORKFLOW_TOL = 1e-5           # a flood body's tensors, card vs CPU
SCORE_TOL = 1e-4              # the alarm score, card vs CPU
# payload sizes: 488, 2441 and 4096 frames (the reference's cap)
WORKFLOW_SIZES = (2e6, 10e6, 50e6)
TABLE2_MB = (10, 50)          # Table 2's smallest and largest input
# tests/test_kernels.py:19-26: (BK, S, G, hd, window, softcap)
SWEEP = [(2, 256, 4, 64, 0, 0.0), (2, 256, 1, 64, 64, 0.0),
         (3, 128, 2, 32, 0, 50.0), (1, 512, 6, 128, 128, 30.0),
         (2, 192, 2, 64, 96, 0.0)]
# (B, S, C, a near 1): test_rglru_kernel's sweep, then ragged C (C % 4 != 0;
# a last group of 4 channels) and a near 1, also at the prefill shape
RGLRU_SWEEP = [(2, 256, 128, False), (1, 128, 512, False), (3, 64, 96, False),
               (4, 100, 2562, False), (3, 50, 2564, True), (2, 256, 128, True),
               (4, 1024, 2560, True)]
# (BH, S, hd, logw value or None): test_wkv6_kernel's sweep, then the edges
WKV6_SWEEP = [(2, 128, 32, None), (4, 256, 64, None), (1, 64, 16, None),
              (2, 96, 32, None), (3, 1, 64, None), (3, 37, 64, None),
              (4, 512, 64, -5.0), (4, 1024, 64, -1e-4), (2, 64, 32, -40.0)]
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
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5     # h2o-danube-1.8b training
REC_TRAIN_B, REC_TRAIN_S = 4, 1024            # the recurrent archs' train step
LR_TRAIN = 1e-4
TRAIN_TOL = {"loss": 2e-2, "grad_norm": 5e-2}  # kernels vs plain, bf16
SMOKE_TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3}  # card vs CPU, f32, tf32 off
KINDS_OF = {"flash_attention": ("local", "global"), "rglru_scan": ("rglru",),
            "wkv6": ("rwkv",)}
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

    def compare(a, b, what):
        before = dict(cuda_lib.launches)
        h, h_thread = rglru_scan_bsc(a, b), rglru_scan_thread(a, b)
        ref = rglru_scan_ref(a.double(), b.double())
        torch.cuda.synchronize()
        for name, n in (("rglru_scan:grouped", 1), ("rglru_scan:thread", 1)):
            check(cuda_lib.launches[name] == before.get(name, 0) + n,
                  f"{name} launched")
        check(h.dtype == torch.float32 and h.shape == a.shape, "rglru output")
        for got, which in ((h, "grouped"), (h_thread, "thread")):
            check(max_excess(torch, got, ref, RGLRU_TOL) <= RGLRU_TOL,
                  f"rglru {which} {what}")
        return tuple((got.double() - ref).abs().max().item()
                     for got in (h, h_thread))
    sweep = [0.0, 0.0]
    for case in RGLRU_SWEEP:
        errs = compare(*inputs(case[:3], case[3]), case)
        sweep = [max(x, e) for x, e in zip(sweep, errs)]
    print(f"[kernels] rglru_scan sweep: max abs err {sweep[0]:.3g} (grouped), "
          f"{sweep[1]:.3g} (thread) (tol {RGLRU_TOL}, against the plain "
          f"version in f64)")
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
            check(max_excess(torch, got_y.double(), y_ref, WKV6_TOL) <= WKV6_TOL,
                  f"wkv6 {which} y {what}")
            check(max_excess(torch, got_st.double(), st_ref, WKV6_TOL) <= WKV6_TOL,
                  f"wkv6 {which} final state {what}")
        return errs
    sweep = [0.0, 0.0]
    for case in WKV6_SWEEP:
        errs = compare(inputs(*case), case)
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


def grads_of(torch, fn, inputs, cotangents):
    """(outputs, autograd of fn at detached copies of ``inputs``)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return out, torch.autograd.grad(out, leaves, cotangents)


def check_grads(torch, randn):
    """Each kernel's autograd function (forward: the kernel; backward: autograd
    of the plain version on the saved inputs) against autograd of the plain
    version alone, over the kernel's sweep, at the kernel's tolerance: flash
    in the model's layout (B, S, K=1, G, hd) against the eager attention the
    reference trains through; the scan and the wkv6 (y and final state)
    against their plain versions in f64.  Returns the worst error by kernel."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
    from repro_torch.kernels.rwkv6_chunk import wkv6, wkv6_ref
    from repro_torch.models.attention import plain_attention

    def excess(got, want, tol):
        return max(max_excess(torch, g, w, tol) for g, w in zip(got, want))

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for BK, Sq, G, hd, win, cap in SWEEP:
            kw = dict(window=win, softcap=cap, scale=hd ** -0.5)
            ins = (randn((BK, Sq, 1, G, hd), dtype), randn((BK, Sq, 1, hd), dtype),
                   randn((BK, Sq, 1, hd), dtype))
            go = (randn((BK, Sq, 1, G, hd), dtype),)
            before = cuda_lib.launches["flash_attention"]
            (o,), got = grads_of(torch, lambda *t: flash_attention(*t, **kw),
                                 ins, go)
            check(cuda_lib.launches["flash_attention"] == before + 1 and
                  o.grad_fn is not None, "flash autograd function launched")
            _, want = grads_of(torch, lambda *t: plain_attention(*t, **kw), ins,
                               go)
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            check(excess(got, want, TOL[dname]) <= TOL[dname],
                  f"flash grads {dname} {(BK, Sq, G, hd, win, cap)}: {err}")
            worst[f"flash_attention {dname}"] = max(
                worst.get(f"flash_attention {dname}", 0.0), err)
    for B_, S_, C, near_one in RGLRU_SWEEP:
        x = randn((B_, S_, C), torch.float32)
        a = 1 - torch.sigmoid(x) * 1e-3 if near_one else torch.sigmoid(x)
        ins, go = (a, randn((B_, S_, C), torch.float32)), \
            (randn((B_, S_, C), torch.float32),)
        _, got = grads_of(torch, rglru_scan, ins, go)
        _, want = grads_of(torch, rglru_scan_ref, [t.double() for t in ins],
                           [g.double() for g in go])
        err = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        check(excess(got, want, RGLRU_TOL) <= RGLRU_TOL,
              f"rglru grads {(B_, S_, C, near_one)}: {err}")
        worst["rglru_scan"] = max(worst.get("rglru_scan", 0.0), err)
    for BH, S_, hd, logw_value in WKV6_SWEEP:
        r, k, v = (randn((1, S_, BH, hd), torch.float32) for _ in range(3))
        logw = torch.clamp(-torch.exp(randn((1, S_, BH, hd), torch.float32) * 0.5),
                           -5.0, -1e-4)
        if logw_value is not None:
            logw = torch.full_like(logw, logw_value)
        ins = (r, k, v, logw, randn((BH, hd), torch.float32) * 0.1)
        go = (randn((1, S_, BH, hd), torch.float32),
              randn((1, BH, hd, hd), torch.float32))
        _, got = grads_of(torch, wkv6, ins, go)

        def plain(r, k, v, logw, u):
            y, st = wkv6_ref(*(t[0].transpose(0, 1).contiguous()
                               for t in (r, k, v, logw)), u)
            return y.transpose(0, 1)[None], st[None]
        _, want = grads_of(torch, plain, [t.double() for t in ins],
                           [g.double() for g in go])
        err = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        check(excess(got, want, WKV6_TOL) <= WKV6_TOL,
              f"wkv6 grads {(BH, S_, hd, logw_value)}: {err}")
        worst["wkv6"] = max(worst.get("wkv6", 0.0), err)
    print(f"[kernels] gradients through each kernel's autograd function against "
          f"autograd of the plain version, over the sweeps: max abs err "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (tols: flash "
          f"{TOL}, scan {RGLRU_TOL}, wkv6 {WKV6_TOL})")
    return worst


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


# ---------------------------------------------------------------------------
# phase 7: the Databelt workflow path
# ---------------------------------------------------------------------------
class StepClock:
    """Stands in for the engine's wall clock: each reading steps by a fixed
    amount, so that two runs of the engine give the same simulated times."""

    def __init__(self, step=0.125):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def run_body(torch, fn, args):
    """One synchronized call: (output, CUDA-event ms, host ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def same_outputs(torch, got, want, what):
    """A body's card output against its CPU output: the keep mask exactly,
    tensors to WORKFLOW_TOL, the score to SCORE_TOL; every tensor on cuda."""
    check(sorted(got) == sorted(want), f"{what} keys {sorted(got)}")
    errs = {}
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w):
            check(type(g) is type(w), f"{what} {k} type")
            err = abs(g - w)
            check(err <= (0 if isinstance(w, bool) else SCORE_TOL),
                  f"{what} {k}: {g} vs {w}")
        else:
            check(g.device.type == "cuda" and g.shape == w.shape,
                  f"{what} {k} on {g.device}, shape {tuple(g.shape)}")
            if w.dtype == torch.bool:
                err = int((g.cpu() != w).sum())
                check(err == 0, f"{what} {k}: {err} of {w.numel()} differ")
            else:
                err = (g.cpu() - w).abs().max().item()
                check(err <= WORKFLOW_TOL, f"{what} {k} max abs err {err}")
        errs[k] = err
    return errs


def workflow_path(torch, dev):
    """The flood workflow's bodies on the card against the CPU, the engine
    on the card against the engine on the CPU under a stepped clock, and the
    Scenario front door at Table 2's and Fig 13's sizes with real compute."""
    from repro_torch.kernels import cuda_lib

    out = {"bodies": [], "engine": {}, "front_door": []}
    t_phase = time.perf_counter()
    # the phase runs with cuDNN's TF32 at PyTorch's default (allowed), as in a
    # user's process: the bodies pin their own convolutions to f32
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        workflow_runs(torch, dev, out)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    launched = {name: n for name, n in cuda_lib.launches.items() if n}
    check(not launched, f"the workflow path launched {launched}")
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[workflow] no kernel of the port lies on this path (launches "
          f"{launched}); phase {out['phase_s']:.1f} s")
    return out


def timed(torch, record, key, fn):
    """``fn`` with its synchronized host time added to ``record[key]`` (ms)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        record[key] = record.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return res
    return run


def workflow_runs(torch, dev, out):
    """Phases 7a-7c, each result added to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda_lib
    from repro_torch.scenario import Scenario, WorkloadSpec
    from repro_torch.serverless import engine as engine_mod
    from repro_torch.serverless import workflow as wf

    cuda_lib.launches.clear()                    # the workflow path starts here
    # ---- 7a. each body on the card against the same body on the CPU --------
    w_cpu, w_dev = wf.flood_weights("cpu"), wf.flood_weights(dev)
    precision = torch.backends.cudnn.conv.fp32_precision
    bodies = (("ingest", wf.ingest_fn, ()), ("detect", wf.detect_fn, (w_dev,)),
              ("map", wf.map_fn, (w_dev,)), ("alarm", wf.alarm_fn, ()))
    for size in WORKFLOW_SIZES:
        inputs = {"ingest": wf.make_payload(size)}
        frames = len(inputs["ingest"]["frames"])
        for (name, fn, args), nxt in zip(bodies, ("detect", "map", "alarm",
                                                  None)):
            cpu_args = (w_cpu,) if args else ()
            want = fn(inputs[name], *cpu_args)
            if nxt:
                inputs[nxt] = want
            inp = {k: torch.as_tensor(v).to(dev)
                   for k, v in inputs[name].items()}
            got, cold_ms, cold_host = run_body(torch, fn, (inp, *args))
            errs = same_outputs(torch, got, want,
                                f"{name} at {frames} frames")
            run_body(torch, fn, (inp, *args))                # warm-up
            warm = [run_body(torch, fn, (inp, *args))[1:] for _ in range(10)]
            row = {"body": name, "size_mb": size / 1e6, "frames": frames,
                   "max_abs_err": errs,
                   "cold_event_ms": cold_ms, "cold_host_ms": cold_host,
                   "event_ms": sum(d for d, _ in warm) / len(warm),
                   "host_ms": sum(h for _, h in warm) / len(warm)}
            out["bodies"].append(row)
            print(f"[workflow] {name} at {size / 1e6:g} MB ({frames} frames): "
                  f"card vs CPU {errs}; device (CUDA events) "
                  f"{row['event_ms']:.4f} ms, host {row['host_ms']:.4f} ms; "
                  f"first call {cold_ms:.3f} / {cold_host:.3f} ms")
    check(torch.backends.cudnn.conv.fp32_precision == precision,
          "the bodies left the caller's TF32 setting as it was")
    # what the bodies' f32 pin guards against (reported, not checked): the
    # convolving bodies without it, cuDNN allowed TF32, at 10 MB
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in wf.make_payload(10e6).items()}
    pinned = wf.ingest_fn(inp)
    bare = wf.ingest_fn.__wrapped__(inp)
    det = wf.detect_fn(pinned, w_dev)["detections"]
    det_bare = wf.detect_fn.__wrapped__(pinned, w_dev)["detections"]
    out["tf32_unpinned"] = {
        "keep_differs": int((bare["keep"] != pinned["keep"]).sum()),
        "frames": len(pinned["keep"]),
        "detections_max_abs_diff": (det_bare - det).abs().max().item()}
    print(f"[workflow] without the f32 pin, cuDNN TF32 allowed, at 10 MB: "
          f"keep differs in {out['tf32_unpinned']['keep_differs']} of "
          f"{len(pinned['keep'])} frames, detections by up to "
          f"{out['tf32_unpinned']['detections_max_abs_diff']:.3g} "
          f"(not checked: what the pin guards against)")

    # ---- 7b. the engine on the card against the engine on the CPU ----------
    runs = {}
    real_clock = engine_mod._time
    try:
        for where in ("cpu", dev):
            engine_mod._time = StepClock()
            scores = []

            def maker(wid, where=where, scores=scores):
                flow = wf.flood_workflow(wid, device=where)
                alarm = flow.fn("alarm")
                body = alarm.compute

                def compute(payload):
                    res = body(payload)
                    scores.append(res["score"])
                    return res
                alarm.compute = compute
                return flow
            eng = Scenario(strategy="databelt",
                           real_compute=True).build_engine(device=where)
            m = eng.run_instance(maker("engine-check"), 10e6)
            runs[str(where)] = (dataclasses.asdict(m), scores)
    finally:
        engine_mod._time = real_clock
    (cm, cs), (gm, gs) = runs["cpu"], runs[str(dev)]
    check(cm == gm, f"engine metrics card {gm} vs cpu {cm}")
    check(len(cs) == len(gs) == 1 and abs(cs[0] - gs[0]) <= SCORE_TOL,
          f"engine alarm scores card {gs} vs cpu {cs}")
    out["engine"] = {"metrics": gm, "score_card": gs[0], "score_cpu": cs[0]}
    print(f"[workflow] engine, databelt at 10 MB, real compute with the "
          f"clock stepped: card and CPU metrics identical ({gm}); alarm "
          f"score card {gs[0]:.7f} vs CPU {cs[0]:.7f}")

    # ---- 7c. the front door at real sizes, real compute on the card --------
    table2 = Scenario(workload=WorkloadSpec(kind="sequential", spacing=120.0),
                      n=3, real_compute=True).sweep(
        input_bytes=[mb * 1e6 for mb in TABLE2_MB],
        strategy=["databelt", "random", "stateless"])
    fig13 = Scenario(workload=WorkloadSpec(kind="stagger", stagger=0.05),
                     n=64, input_bytes=2e6, real_compute=True).sweep(
        strategy=["databelt", "stateless"])
    cells = [("table2", sc) for sc in table2] + [("fig13", sc) for sc in fig13]
    # run 1, the path alone (no profiler, nothing wrapped): the end-to-end
    # numbers.  Real compute per mission is its compute time less that of the
    # same Scenario with virtual compute, which is deterministic.
    virtual = {}
    for label, sc in cells:
        vms = sc.replace(real_compute=False).run(device="cpu").instances
        virtual[label, sc.strategy, sc.input_bytes] = \
            sum(m.compute_time for m in vms) / len(vms)

    def real_ms(label, sc, ms):
        return (sum(m.compute_time for m in ms) / len(ms) -
                virtual[label, sc.strategy, sc.input_bytes]) * 1e3

    for label, sc in cells:
        c0 = time.perf_counter()
        rep = sc.run(device=dev)
        wall = time.perf_counter() - c0
        ms = rep.instances
        check(len(ms) == sc.n and all(
            math.isfinite(m.latency) and m.latency > 0 and
            m.compute_time > 0 for m in ms), f"{label} {sc.strategy} run")
        mean = lambda f: sum(f(m) for m in ms) / len(ms)
        row = {"cell": label, "strategy": sc.strategy,
               "size_mb": sc.input_bytes / 1e6, "n": sc.n,
               "mean_latency_s": rep.mean_latency,
               "compute_s": mean(lambda m: m.compute_time),
               "read_s": mean(lambda m: m.read_time),
               "write_s": mean(lambda m: m.write_time),
               "p95_s": rep.p95, "throughput_rps": rep.throughput_rps,
               "real_compute_ms_per_mission": real_ms(label, sc, ms),
               "host_wall_s": wall}
        out["front_door"].append(row)
        print(f"[workflow] {label} {sc.strategy} {row['size_mb']:g} MB "
              f"n={sc.n}: mean latency {row['mean_latency_s']:.4f} s "
              f"(compute {row['compute_s']:.4f}, read "
              f"{row['read_s']:.4f}, write {row['write_s']:.4f}), p95 "
              f"{row['p95_s']:.4f} s, {row['throughput_rps']:.4f} rps; real "
              f"compute {row['real_compute_ms_per_mission']:.4f} ms a "
              f"mission; host wall {wall:.3f} s")

    # run 2: where the engine's real compute goes.  Each body is timed inside
    # the engine's span (a synchronize before and after, the host clock;
    # ingest's includes the copy of the frames to the card), and so is
    # make_payload (the numpy draw on the host), which the engine calls
    # before its clock starts.
    out["front_door_split"] = []
    record = {}
    names = ("ingest_fn", "detect_fn", "map_fn", "alarm_fn")
    saved = {n: getattr(wf, n) for n in names}
    saved_payload = engine_mod.make_payload
    try:
        for n in names:
            setattr(wf, n, timed(torch, record, n[:-3], saved[n]))
        engine_mod.make_payload = timed(torch, record, "payload",
                                        saved_payload)
        for label, sc in cells:
            record.clear()
            ms = sc.run(device=dev).instances
            row = {"cell": label, "strategy": sc.strategy,
                   "size_mb": sc.input_bytes / 1e6,
                   "real_compute_ms_per_mission": real_ms(label, sc, ms),
                   **{k: v / sc.n for k, v in record.items()}}
            row["bodies_ms"] = sum(row[n[:-3]] for n in names)
            out["front_door_split"].append(row)
            print(f"[workflow] {label} {sc.strategy} {row['size_mb']:g} MB, a "
                  f"mission: real compute {row['real_compute_ms_per_mission']:.4f}"
                  f" ms, of which the bodies {row['bodies_ms']:.4f} ms (ingest "
                  f"{row['ingest']:.4f}, detect {row['detect']:.4f}, map "
                  f"{row['map']:.4f}, alarm {row['alarm']:.4f}); make_payload "
                  f"{row['payload']:.4f} ms (host draw), outside the timed "
                  f"compute")
    finally:
        for n in names:
            setattr(wf, n, saved[n])
        engine_mod.make_payload = saved_payload

    # run 3, under torch.profiler: the device's idle share over the front door
    profiled = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for label, sc in cells:
            ms = sc.run(device=dev).instances
            profiled.append(real_ms(label, sc, ms))
        torch.cuda.synchronize()
        front_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out["front_door_device"] = {
        "host_s": front_s, "device_busy_s": busy_s,
        "idle_share": 1 - busy_s / front_s,
        "real_compute_ms_per_mission": profiled,
        "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                        for e in top]}
    print(f"[workflow] front door, {len(cells)} runs under torch.profiler: "
          f"host {front_s:.3f} s, device busy {busy_s * 1e3:.2f} ms, device "
          f"idle {1 - busy_s / front_s:.2%}; real compute a mission (ms, "
          f"profiled) {[round(x, 4) for x in profiled]}; top kernels (ms, "
          f"launches): {[(k, round(t, 3), n) for k, t, n in out['front_door_device']['top_kernels']]}")


# ---------------------------------------------------------------------------
# phase 8: the Databelt front door's last pieces
# ---------------------------------------------------------------------------
def frontdoor_path(torch, dev, card):
    """The lint over the port, both sanitizer smokes, the race and replay
    sanitizers on Fig 13's point with real compute on the card, and the
    twins of the quickstart and serve_pipeline examples; each step timed on
    the host clock."""
    from repro_torch.analysis.__main__ import main as lint
    from repro_torch.examples import quickstart, serve_pipeline
    from repro_torch.kernels import cuda_lib
    from repro_torch.scenario import Scenario, WorkloadSpec
    from repro_torch.serverless import workflow as wf

    out = {"card": card, "steps": {}}

    def step(name, fn, *args):
        """``fn(*args)`` timed, its stdout captured and printed after."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn(*args)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        text = buf.getvalue()
        out["steps"][name] = {"host_s": host_s, "out": text.strip()[-600:]}
        print(f"[frontdoor] {name}: host {host_s:.3f} s ({card})"
              + "".join(f"\n[frontdoor]   {line}"
                        for line in text.strip().splitlines()))
        return res, out["steps"][name]

    root = Path(__file__).resolve().parent
    rc, _ = step("lint", lint, [str(root / "src" / "repro_torch"), "--strict"])
    check(rc == 0, "python -m repro_torch.analysis src/repro_torch --strict")
    rc, _ = step("replay_smoke", lint, ["--replay-smoke"])
    check(rc == 0, "python -m repro_torch.analysis --replay-smoke")
    rc, _ = step("race_smoke", lint, ["--race-smoke"])
    check(rc == 0, "python -m repro_torch.analysis --race-smoke")

    # Fig 13's point with real compute: a concurrent spec, so the race
    # sanitizer has processes to order (a sequential one is rejected).  The
    # sanitizer is passive, so this is the mission workload [workflow] times.
    fig13 = Scenario(workload=WorkloadSpec(kind="stagger", stagger=0.05),
                     n=64, input_bytes=2e6, strategy="databelt",
                     real_compute=True)
    calls = {}
    names = ("ingest_fn", "detect_fn", "map_fn", "alarm_fn")
    saved = {n: getattr(wf, n) for n in names}

    def counted(name, body):
        def run(payload, *args):
            res = body(payload, *args)
            calls[name] = calls.get(name, 0) + 1
            if name == "ingest_fn":
                check(res["frames"].device.type == "cuda",
                      f"ingest's frames on {res['frames'].device}")
            return res
        return run
    try:
        for n in names:
            setattr(wf, n, counted(n, saved[n]))
        races, row = step("verify_races", lambda: fig13.verify_races(
            device=dev))
        check(races.ok, f"Fig 13 with real compute: {races.describe()}")
        check(calls == {n: fig13.n for n in names},
              f"every flood body ran on the card once a mission: {calls}")
        row.update(events=races.events_processed, body_calls=dict(calls))
        calls.clear()
        replay, row = step("verify_replay", lambda: fig13.verify_replay(
            device=dev))
        check(calls == {n: 2 * fig13.n for n in names},
              f"both replays ran every body: {calls}")
    finally:
        for n in names:
            setattr(wf, n, saved[n])
    d = replay.divergence
    # an observation, not a gate: real compute folds the bodies' wall time
    # into simulated time, so two runs of one spec need not replay
    row.update(ok=replay.ok, events_a=replay.events_a,
               events_b=replay.events_b, metrics_match=replay.metrics_match,
               describe=replay.describe(),
               divergence=None if d is None else {
                   "index": d.index, "label_a": d.label_a,
                   "label_b": d.label_b, "time_a": d.time_a,
                   "time_b": d.time_b})
    print(f"[frontdoor] verify_replay on Fig 13 with real compute "
          f"(observed, not checked): {replay.describe()}")

    # the serving example: its engine feeds prompts token by token through
    # decode, whose attention is plain torch (the reference's is a jnp
    # einsum): no kernel of the port lies on this path, as in [engine]
    cuda_lib.launches.clear()
    done, row = step("serve_pipeline", serve_pipeline.main,
                     ["--device", "cuda"])
    launched = {name: n for name, n in cuda_lib.launches.items() if n}
    serve_launches = {name: cuda_lib.launches.get(name, 0)
                      for name in PATHS["gemma3-1b"]}
    check(sorted(r.req_id for r in done) == list(range(8)) and all(
        1 <= len(r.tokens_out) <= 12 for r in done),
        "serve_pipeline answered its 8 requests")
    check(not launched, f"serve_pipeline launched {launched}")
    row.update(tokens=sum(len(r.tokens_out) for r in done),
               launches=launched)
    reports, row = step("quickstart", quickstart.main)
    check([r.system for r in reports] == ["databelt", "random", "stateless"]
          and all(math.isfinite(r.mean_latency) for r in reports),
          "quickstart's virtual sweep")
    return out, serve_launches


# ---------------------------------------------------------------------------
# phase 9: the training path
# ---------------------------------------------------------------------------
def plain_for_training(kernel):
    """Put the plain version of ``kernel`` where training calls it (flash: the
    eager attention hook the reference trains through; a recurrent kernel:
    its plain version inside the autograd function's forward); returns the
    function that puts the kernel back."""
    from repro_torch import kernels
    from repro_torch.models import attention as attn
    if kernel == "flash_attention":
        attn.set_attention_impl(attn.plain_attention)
        return kernels.enable_flash_attention
    arch = "recurrentgemma-2b" if kernel == "rglru_scan" else "rwkv6-7b"
    return swap_for_plain(arch, kernel)


def loss_and_grad_norm(torch, tsteps, gnorm, state, cfg, batch):
    """The first step's loss and global grad norm (what the step reports
    before its update), from ``state`` without changing it."""
    model = state["params"]
    for p in model.parameters():
        p.grad = None
    total, metrics = tsteps.loss_fn(model, cfg, batch)
    total.backward()
    gn = gnorm({n: p.grad for n, p in model.named_parameters()})
    out = float(metrics["loss"].detach()), float(gn)
    for p in model.parameters():
        p.grad = None
    return out


def kernel_vs_plain_step(torch, tsteps, gnorm, state, cfg, batch, kernels, what):
    """The first step's loss and grad norm through the kernels and with each of
    ``kernels`` swapped for its plain version, checked to TRAIN_TOL."""
    got = loss_and_grad_norm(torch, tsteps, gnorm, state, cfg, batch)
    restores = [plain_for_training(k) for k in kernels]
    try:
        want = loss_and_grad_norm(torch, tsteps, gnorm, state, cfg, batch)
    finally:
        for restore in restores:
            restore()
    errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    check(all(math.isfinite(x) for x in got + want), f"{what} finite")
    check(errs[0] <= TRAIN_TOL["loss"] and errs[1] <= TRAIN_TOL["grad_norm"],
          f"{what}, kernel vs plain {kernels}: loss {got[0]} vs {want[0]}, grad "
          f"norm {got[1]} vs {want[1]}")
    print(f"[train] {what}, first step from the same state, kernels vs plain "
          f"{'/'.join(kernels)}: loss {got[0]:.6f} vs {want[0]:.6f} (rel "
          f"{errs[0]:.3g}, tol {TRAIN_TOL['loss']}), grad norm {got[1]:.6f} vs "
          f"{want[1]:.6f} (rel {errs[1]:.3g}, tol {TRAIN_TOL['grad_norm']})")
    return {"loss": got[0], "plain_loss": want[0], "grad_norm": got[1],
            "plain_grad_norm": want[1], "loss_rel_err": errs[0],
            "grad_norm_rel_err": errs[1]}


def kernel_kind(name: str) -> str:
    n = name.lower()
    for key, kind in (("flash", "flash forward"), ("rglru", "RG-LRU scan"),
                      ("wkv6", "wkv6"), ("memcpy", "copies"),
                      ("memset", "copies")):
        if key in n:
            return kind
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                            "sm90_", "sm80_")):
        return "matmul"
    return "elementwise"


def profile_step(torch, step, state, batch, ranges):
    """One train step under torch.profiler: device time by kind, the kernels
    inside each of ``ranges`` (record_function names) counted to that range,
    and the device's idle share over the step's host time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # the device timeline also holds the record_function ranges projected onto
    # it (user annotations): only kernels, copies and sets are device work
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and
              not getattr(e, "is_user_annotation", False) and
              e.name not in ranges]
    # a kernel belongs to a range when it starts inside the range's span on
    # the device timeline (one stream, and the host waits in backward(), so
    # no other work lands there)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA and
             e.name in ranges]
    split = {}
    for e in device:
        t = e.time_range.start
        kind = next((name for name, a, b in spans if a <= t < b),
                    kernel_kind(e.name))
        split[kind] = split.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(split.values())
    top = {}
    for e in device:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(top.items(), key=lambda kv: -kv[1])[:10]
    return {"host_ms": host_ms, "device_ms": busy,
            "idle_share": 1 - busy / host_ms if host_ms else None,
            "by_kind_ms": split, "device_events": len(device),
            "ranges_on_device": sorted({name for name, _, _ in spans}),
            "top_kernels_ms": [(n[:90], kernel_kind(n), ms) for n, ms in top]}


RANGES = ("attention backward (eager)", "rglru_scan backward (plain)",
          "wkv6 backward (plain)", "optimizer")


def print_profile(arch, prof, card):
    kinds = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
        prof["by_kind_ms"].items(), key=lambda kv: -kv[1]))
    print(f"[train] {arch} one step under torch.profiler: host "
          f"{prof['host_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms, "
          f"device idle {prof['idle_share']:.2%} ({prof['device_events']} device "
          f"events; ranges seen on the device {prof['ranges_on_device']}); "
          f"device time by kind: {kinds}; top kernels (ms): "
          f"{[(n[:60], k, round(ms, 3)) for n, k, ms in prof['top_kernels_ms']]}"
          f"; {card}")


def train_path(torch, np, dev, card):
    """Phase 9: h2o-danube-1.8b training at full width (the main path of
    training), the kernels against their plain versions, recurrentgemma-2b
    and rwkv6-7b train steps at full width and one superblock, and the smoke
    configs' train step on the card against the CPU.  Returns the launches
    of each train run, by kernel, and the phase's numbers."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import (flash_attention_bkg,
                                                     flash_attention_ref)
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, global_norm
    from repro_torch.train import steps as tsteps

    out = {"card": card}
    launches = {}

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # ---- 8a. h2o-danube-1.8b at full width ----------------------------------
    arch = "h2o-danube-1.8b"
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    opt = adamw()
    state = tsteps.init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                                    cfg, opt, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    data = SyntheticTokens(cfg, TRAIN_B, TRAIN_S, seed=SEED)
    batches = [on_dev(data.batch_for_step(i)) for i in range(TRAIN_STEPS + 1)]
    print(f"[train] {arch} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, window {cfg.window_size}, remat {cfg.remat}): "
          f"{n_params / 1e9:.4f} B params, AdamW with f32 master, batch "
          f"{TRAIN_B} x seq {TRAIN_S}; init {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    # 8b. the first step twice from the same state: kernel, then plain
    out["kernel_vs_plain"] = {arch: kernel_vs_plain_step(
        torch, tsteps, global_norm, state, cfg, batches[0], ["flash_attention"],
        f"{arch} full width")}
    step = tsteps.build_train_step(cfg, opt, tsteps_lr(), grad_accum=1)
    rows = []
    cuda_lib.launches.clear()                    # the training path starts here
    for i in range(TRAIN_STEPS):
        before = dict(cuda_lib.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        flash = cuda_lib.launches["flash_attention"] - before.get(
            "flash_attention", 0)
        rows.append({"step": i + 1, "ms": ms, "loss": loss, "grad_norm": gn,
                     "lr": float(metrics["lr"]), "flash_launches": flash})
        check(math.isfinite(loss) and math.isfinite(gn),
              f"{arch} step {i + 1} loss {loss} grad norm {gn}")
        print(f"[train] {arch} step {i + 1}: {ms:.1f} ms, loss {loss:.6f}, grad "
              f"norm {gn:.6f}, lr {rows[-1]['lr']:.3g}, flash launches {flash}")
    launches["train:" + arch] = {n: c for n, c in cuda_lib.launches.items() if c}
    want_flash = train_launches(cfg, "flash_attention")
    check(all(r["flash_launches"] == want_flash for r in rows),
          f"flash launches per step {[r['flash_launches'] for r in rows]}, want "
          f"{want_flash} (forward and the remat recompute)")
    missing = [n for n, p in state["params"].named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not missing, f"{arch} parameters without a finite grad: {missing}")
    med = float(np.median([r["ms"] for r in rows[1:]]))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = profile_step(torch, step, state, batches[TRAIN_STEPS], RANGES)
    out[arch] = {"params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
                 "steps": rows, "median_ms_steps_2_5": med,
                 "tokens_per_s": TRAIN_B * TRAIN_S / med * 1e3,
                 "peak_memory_gb": peak, "profile": prof,
                 "flash_launches_per_step": want_flash}
    print(f"[train] {arch}: median {med:.1f} ms/step over steps 2-{TRAIN_STEPS} "
          f"({TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s), peak memory "
          f"{peak:.2f} GB (max_memory_allocated), flash launches per step "
          f"{want_flash}, every parameter has a finite grad; {card}")
    print_profile(arch, prof, card)
    # the flash kernel at the training shape, beside its plain version
    BK, G, hd = TRAIN_B * cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((BK, TRAIN_S, G, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((BK, TRAIN_S, hd), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(scale=hd ** -0.5, window=cfg.window_size)
    err = (flash_attention_bkg(q, k, v, **kw).float() -
           flash_attention_ref(q, k, v, **kw).float()).abs().max().item()
    check(err <= TOL["bfloat16"], f"flash at the training shape: {err}")
    bound_ms, bound_by = flash_bound(BK, TRAIN_S, G, hd, cfg.window_size)
    out["flash_train_shape"] = {
        "shape": f"BK={BK} Sq=Skv={TRAIN_S} G={G} hd={hd} bf16 window="
                 f"{cfg.window_size}", "max_abs_err": err,
        "ms": time_ms(torch, lambda: flash_attention_bkg(q, k, v, **kw)),
        "plain_ms": time_ms(torch, lambda: flash_attention_ref(q, k, v, **kw),
                            iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by}
    f = out["flash_train_shape"]
    print(f"[train] flash at the training shape {f['shape']}: max abs err "
          f"{err:.3g}, kernel_ms {f['ms']:.4f}, plain_ms {f['plain_ms']:.4f}, "
          f"bound_ms {bound_ms:.5f} ({bound_by}), {bound_ms / f['ms']:.1%} of "
          f"bound; {card}")
    del state, batches, q, k, v
    torch.cuda.empty_cache()

    # ---- 8c. recurrentgemma-2b and rwkv6-7b, full width, one superblock -----
    for arch, kernels in (("recurrentgemma-2b", ["rglru_scan", "flash_attention"]),
                          ("rwkv6-7b", ["wkv6"])):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=full.pattern_len)
        torch.cuda.reset_peak_memory_stats(dev)
        opt = adamw()
        state = tsteps.init_train_state(
            torch.Generator(device=dev).manual_seed(SEED), cfg, opt, device=dev)
        batch = on_dev(SyntheticTokens(cfg, REC_TRAIN_B, REC_TRAIN_S,
                                       seed=SEED).batch_for_step(0))
        out["kernel_vs_plain"][arch] = kernel_vs_plain_step(
            torch, tsteps, global_norm, state, cfg, batch, kernels,
            f"{arch} full width, {cfg.n_layers} layers")
        step = tsteps.build_train_step(cfg, opt, tsteps_lr())
        step(state, batch)                                  # warm-up
        torch.cuda.synchronize()
        cuda_lib.launches.clear()              # this path's train step starts
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        launches["train:" + arch] = {n: c for n, c in cuda_lib.launches.items()
                                     if c}
        for kernel in kernels:
            n = train_launches(cfg, kernel)
            check(launches["train:" + arch].get(kernel, 0) == n,
                  f"{arch} train step launched {launches['train:' + arch]}, "
                  f"want {kernel} {n}")
        missing = [n for n, p in state["params"].named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        check(math.isfinite(loss) and math.isfinite(gn) and not missing,
              f"{arch} train step: loss {loss}, grad norm {gn}, no grad for "
              f"{missing}")
        n_params = sum(p.numel() for p in state["params"].parameters())
        out[arch] = {"params": n_params, "layers": cfg.n_layers,
                     "batch": REC_TRAIN_B, "seq": REC_TRAIN_S, "ms": ms,
                     "loss": loss, "grad_norm": gn,
                     "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "profile": profile_step(torch, step, state, batch, RANGES)}
        print(f"[train] {arch} full width, {cfg.n_layers} layers "
              f"({n_params / 1e9:.4f} B params), batch {REC_TRAIN_B} x seq "
              f"{REC_TRAIN_S}: one step {ms:.1f} ms, loss {loss:.6f}, grad norm "
              f"{gn:.6f}, launches {launches['train:' + arch]}, peak memory "
              f"{out[arch]['peak_memory_gb']:.2f} GB; every parameter has a "
              f"finite grad; {card}")
        print_profile(arch, out[arch]["profile"], card)
        del state, batch
        torch.cuda.empty_cache()

    # ---- 8d. the smoke configs' train step, card against CPU (f32) ----------
    out["smoke_card_vs_cpu"] = {}
    for arch in ("h2o-danube-1.8b", "recurrentgemma-2b", "rwkv6-7b"):
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
        batch = SyntheticTokens(cfg, 2, 64, seed=SEED).batch_for_step(0)
        res = {}
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
            state = tsteps.init_train_state(None, cfg, adamw(),
                                            params=model.to(where))
            state, metrics = tsteps.build_train_step(cfg, adamw(), tsteps_lr())(
                state, {k: torch.from_numpy(v).to(where)
                        for k, v in batch.items()})
            res[str(where)] = (float(metrics["loss"]), {
                n: p.grad.cpu() for n, p in state["params"].named_parameters()},
                {n: p.detach().cpu() for n, p in
                 state["params"].named_parameters()})
        (cl, cg, cp), (gl, gg, gp) = res["cpu"], res[str(dev)]
        loss_err = abs(gl - cl) / abs(cl)
        grad_err = max(rel_err(torch, gg[n], cg[n]) for n in cg)
        # AdamW's first step is about lr * sign(g): a grad near 0 may flip
        param_err = max(((gp[n] - cp[n]).abs() - 2 * LR_TRAIN *
                         (1 + 0.1 * cp[n].abs())).max().item() for n in cp)
        check(loss_err <= SMOKE_TRAIN_TOL["loss"] and
              grad_err <= SMOKE_TRAIN_TOL["grad"] and param_err <= 0,
              f"{arch} smoke train step card vs CPU: loss {loss_err}, grads "
              f"{grad_err}, params {param_err}")
        out["smoke_card_vs_cpu"][arch] = {"loss_rel_err": loss_err,
                                          "grad_leaf_rel_err": grad_err,
                                          "param_excess": param_err}
        print(f"[train] {arch} smoke config in f32, one train step card "
              f"(kernels) vs CPU (plain): loss rel err {loss_err:.3g} (tol "
              f"{SMOKE_TRAIN_TOL['loss']}), worst grad leaf rel err "
              f"{grad_err:.3g} (tol {SMOKE_TRAIN_TOL['grad']}), new params "
              f"within 2 lr (1 + wd |p|) (worst excess {param_err:.3g})")
    return launches, out


def train_launches(cfg, kernel) -> int:
    """Launches of ``kernel`` in one train step: once a layer of its kind, and
    once more in each checkpointed superblock's recompute under remat."""
    per_block = sum(k in KINDS_OF[kernel] for k in cfg.layer_pattern)
    tail = sum(k in KINDS_OF[kernel] for k in cfg.tail_pattern)
    return per_block * cfg.n_superblocks * (1 if cfg.remat == "none" else 2) \
        + tail


def tsteps_lr():
    """The constant learning rate of the phase's steps: the schedule's
    warmup starts at 0, which would leave the first step's params as they
    were."""
    return lambda step: LR_TRAIN


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
    grad_err = check_grads(torch, randn)
    print(f"[kernels] {NO_LIBRARY}")

    # ---- 3-6. the serving paths, one model at a time ---------------------
    launches = {}
    for arch in PATHS:
        launches[arch] = serve_path(torch, np, dev, arch)
        torch.cuda.empty_cache()

    # ---- 7. the Databelt workflow path -----------------------------------
    print(json.dumps({"workflow": workflow_path(torch, dev)}))

    # ---- 8. the front door's last pieces ---------------------------------
    frontdoor, launches["serve_pipeline"] = frontdoor_path(torch, dev, card)
    print(json.dumps({"frontdoor": frontdoor}))

    # ---- 9. the training path --------------------------------------------
    train_by_path, train_out = train_path(torch, np, dev, card)
    launches.update(train_by_path)
    print(json.dumps({"train": train_out}))

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
        "train_shape": train_out["flash_train_shape"],
        "sweep_max_abs_err": flash_sweep,
        "grad_sweep_max_abs_err": {
            k.split()[1]: v for k, v in grad_err.items()
            if k.startswith("flash")},
        "launches_per_train_step": train_out["h2o-danube-1.8b"][
            "flash_launches_per_step"],
    }, {
        "name": "rglru_scan", "route": "cuda", "variant": "grouped",
        "source": rec + "rglru_scan/csrc/rglru_scan_grouped.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
        "launches": n_rglru, "launches_by_path": rglru_by_path,
        "grad_sweep_max_abs_err": grad_err["rglru_scan"],
        **rglru_rows["grouped"],
    }, {
        "name": "rglru_scan:thread", "route": "cuda", "variant": "thread",
        "earlier_design_of": "rglru_scan",
        "timed_as": "the earlier design as kept, h carried in f64; not the "
                    "f32 carry it was first timed with",
        "source": rec + "rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
        "launches": path_launches("rglru_scan:thread")[0],
        **rglru_rows["thread"],
    }, {
        "name": "wkv6", "route": "cuda", "variant": "chunk",
        "source": rec + "rwkv6_chunk/csrc/wkv6_chunk.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk/kernel.py:72",
        "launches": n_wkv6, "launches_by_path": wkv6_by_path,
        "grad_sweep_max_abs_err": grad_err["wkv6"],
        **wkv6_rows["chunk"],
    }, {
        "name": "wkv6:seq", "route": "cuda", "variant": "seq",
        "earlier_design_of": "wkv6",
        "timed_as": "the earlier design as kept, state and decay in f64; not "
                    "the f32 state it was first timed with",
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
