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
       CUDA-core kernel) and bf16 (the tensor-core kernel), the same two
       kernels with q's rows at a row offset q0 (``Q0_SWEEP``: S/4 rows at
       q0 = S/4, S/2, 3S/4 against S keys, the q-rows route's shape), and
       the gradients through the q-block dispatch (``GRAD_Q_BLOCK``) and at
       row offsets (``GRAD_Q0``), gemma3-1b's
       prefill shapes (local and global layers), recurrentgemma-2b's
       local layer (G=10, window 2048), qwen3-moe's (G=16, hd 128),
       arctic's (G=7, hd 128) and whisper's decoder (G=1, hd 64, 256
       positions), each also beside one PyTorch library
       call (scaled_dot_product_attention with an explicit boolean mask, a
       yardstick the port never calls; on the unwindowed shapes also the
       fastest causal call, ``is_causal=True`` on each backend in turn, k/v
       one head with ``enable_gqa`` or expanded beforehand, and which
       backend it was) and beside the CUDA-core kernel on the same bf16
       inputs (the earlier design);
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
  Then, for gemma3-1b, recurrentgemma-2b, rwkv6-7b, qwen3-moe-235b-a22b,
  arctic-480b, whisper-small and paligemma-3b in turn, at full width and
  full depth, except the MoE configs, cut to 8 and 2 layers (``DEPTH``),
  each model freed before the next.  The non-MoE paths take the weights and
  inputs of their record in ``repro_torch.launch.golden.TIMED`` (the JAX
  reference's outputs at this shape, ``tests/golden/timed.npz``): the f32
  model drawn on the host from a ``BlockDraws`` (``golden.model``) and
  kept there, the timed bf16 model cast from it on the card, the numpy
  tokens, frames and patches of the record; the MoE paths random weights
  from a seeded torch.Generator and ``models.io.make_batch``:
  3. prefill: 4 x 1024 positions (whisper: 1024 frames and 256 decoder
     tokens; paligemma: 256 patches and 768 tokens)
     through build_prefill_step; every kernel must launch exactly once per
     layer that runs it (gemma3-1b: flash 26; recurrentgemma-2b: rglru_scan
     18, flash 8; rwkv6-7b: wkv6 32; qwen3-moe: flash 8; arctic: flash 2;
     whisper: flash 12, its decoder's causal self-attention; paligemma: none,
     its prefix-LM mask runs the plain path as in the reference), and every
     launch must be the new design's (flash: tensor cores; the scan: channel
     groups; the wkv6: chunked), never an earlier one's.
  4. decode: 8 steps of build_decode_step from the prefill cache.
  5. engine: a full-width ServingEngine answers 4 requests (the record's
     prompts, ``golden.engine_prompts``).
  5b. golden: the timed bf16 model, the same object, held to its record
     (``golden_cell``, tf32 off): its checksums on the card, a prefill with
     every position's logits and 8 teacher-forced decode steps at batch 4,
     the launches counted from 0 (``golden_launches``), at the cell's
     ``golden.tolerance`` (5e-2 a measure), its drift from the f32 record
     within 1.5x either way of the reference's own bf16; after phase 6 the
     f32 model, moved to the card, the same way (2e-4), and its serving
     engine's rows against the reference's engine (each request up to its
     first near-tie); then the path's cells cut in depth
     (``golden.cut_cells``: rwkv6-7b at 2 layers, at the standard limits)
     on a model of their own (``golden_cut_cell``).  Full-depth rwkv6-7b
     and the int8 cache's f32 decode take the limits measured for them
     (``golden.TOL_CELL``).  A miss runs ``golden_diagnosis`` (each kernel
     swapped for its plain version) and fails the run.  A MoE path, whose
     timed model keeps all 128 experts, is held instead through its record
     in ``golden.MOE_TIMED`` (``tests/golden/timed_moe.npz``: its depth and
     shape, f32, qwen3-moe's experts cut to 16, arctic's to 8), on a model
     of its own after the timed one is freed.
  6. reference: the full-width prefill with the path's kernel swapped for its
     plain version (flash, or the recurrent kernel on the recurrent paths),
     and the smoke config on the card against the port on the CPU, agree
     within the bf16 model tolerance.  On the recurrent and MoE paths every
     kernel call of a full-width bf16 prefill is also held against its plain
     version on the same inputs.  The recurrent paths compare their
     full-width logits with f32 weights: in bf16 a random 32-layer RWKV
     stack amplifies rounding-level differences past any useful tolerance.
     The MoE paths count the (layer, token) routes that differ between the
     kernel and the plain run and gate the bf16 logits where none does, else
     compare with f32 weights at 4 and 1 layers (``F32_DEPTH``; the flash
     kernel is then the CUDA-core one), and their smoke configs card vs CPU
     in f32: in bf16 a router's near-tie, moved by rounding, picks another
     expert.  recurrentgemma-2b also holds its bf16 logits with flash
     swapped for its plain version (the tensor-core kernel on, in bf16: f32
     weights would route flash to the CUDA-core kernel).
  Then the int8 KV cache: gemma3-1b at full width with ``kv_quant=True``
  beside the bf16 cache on the same weights (its record's, as above):
  prefill launches, 8 decode steps each (timed), logits within 0.5 of the
  bf16 cache's (the reference's bound), its record held in bf16 on the
  timed model and in f32 (``golden_cell``), and the smoke config's
  prefill and decode card vs CPU.  One JSON line holds the serving
  numbers.
  6b. golden: the cells of ``golden.CELLS`` (ten published
     configs at every published width, cut only in depth and the MoEs in
     experts; batch 1; gemma3-1b, h2o-danube-1.8b and recurrentgemma-2b
     also in bf16) on the card, tf32 off, against the JAX reference's own
     outputs in ``tests/golden/full_width.npz``: each cell's weights
     (``BlockDraws``, drawn on the host) checked against the file's
     checksums, its prefill (every position's logits) and 8 teacher-forced
     decode steps held to the file (the logits' projections on 16
     directions in relative norm, each logsumexp, the argmax where the
     reference's top-two gap is clear) at 2e-4 in f32 (rwkv6-7b 1e-3) and
     5e-2 in bf16, and its launches counted from 0: flash once a causal
     self-attention layer (f32: the CUDA-core kernel; bf16: ``wgmma``;
     paligemma-3b none), the scan 2 (recurrentgemma-2b), the wkv6 1
     (rwkv6-7b).  Where a cell is out of tolerance, it is run again with
     each of its kernels swapped for its plain version, to name the one at
     fault, and the phase fails.  One ``[golden]`` line a cell, one JSON
     line for all.
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
     ``[train_moe]``: qwen3-moe-235b-a22b (4 layers) and arctic-480b (1 layer),
     both with Adafactor over the stacked leaves and the MoE aux in the loss,
     whisper-small and paligemma-3b (AdamW, full depth), full width, 4 x 1024
     positions from models.io.make_batch: the first step through flash
     against the eager attention (2e-2, 5e-2 relative; with MoE layers the
     plain run takes the kernel run's routes and the routes it would have
     changed are counted), a warm-up step, one timed step (time, positions/s,
     loss, aux, grad norm, flash launches counted from 0: 8, 2, 24, 0), peak
     memory under 75 GB, one profiled step (the idle share).  The smoke
     configs' train step of all seven trained archs in f32 on the card
     against the CPU (loss 1e-4, each grad leaf 1e-3 in relative norm; new
     params: AdamW's within 2 lr (1 + wd |p|), Adafactor's steps to 1e-3).
     The timed non-MoE steps take the weights and batches of their record
     in ``golden.TRAIN_STEPS`` (the JAX reference's own three steps at
     this shape from one carried optimizer state,
     ``tests/golden/train_steps.npz``): the f32 ``BlockDraws`` draw cast
     to bf16 on the card (``golden.train_model``), ``SyntheticTokens``
     batches as the record keeps them (h2o-danube-1.8b, the recurrent
     pair) or the record's numpy tokens, frames and patches (whisper-small,
     paligemma-3b); the MoEs keep all 128 experts, a CUDA generator's
     draws and ``make_batch``.  golden: the record's steps 1-3 are held on
     the timed bf16 model (paligemma-3b's, which has no bf16 record of
     the steps, its step 1 against ``train.npz``) (h2o-danube-1.8b: its
     timed steps 1-3, step 4's loss the loss after; the others: the warm-up, the timed step and an
     untimed third, a forward pass's loss after it), ``HeldSteps`` sampling
     outside the timed region (``golden.TrainSampler``: the f32 master
     before each step; each parameter's clipped grad, its norm and its
     update after it; the optimizer's state after step 3): the loss, aux,
     grad norm and loss after within 5e-2, each leaf's grad norm and 256
     samples within 5e-2 in relative norm; AdamW's step-1 update within
     5e-2 where the reference's |g| clears the limit times the leaf's RMS
     (and ten eps), its later updates in relative norm where the
     reference's sqrt(v_hat) clears ten eps, within 2 lr (1 + wd |p|)
     elsewhere; m and v after step 3 in relative norm, the count exactly;
     each limit at least twice the reference's own bf16 error from its f32
     record, each step's grads' drift from the f32 record within 1.5x
     either way of the reference's own bf16; each step's launches as
     ``train_golden_launches``.  Before each, the same cell's three steps
     in f32 on a model of its own, tf32 off, at 2e-4, its launches counted
     from 0 (flash the CUDA-core kernel); after each timed MoE step, its
     record's expert cut (16 and 8 of 128, Adafactor, f32: its updates and
     its factored moments at the sampled rows and columns in relative
     norm) on a model of its own.  ``golden.TOL_CELL`` sets any other
     limit; ``golden.UNHELD`` records (rwkv6-7b's bf16) are printed past
     step 1 and not held there.  A miss runs ``golden_train_diagnosis`` (each kernel swapped
     for its plain version) and fails the run.  One ``[golden]`` line a
     step of a record, one for its state after.  One JSON line holds it.
  10. distributed: one NCCL rank (a FileStore in a temp dir, no network) and
     a 1 x 1 mesh from launch.mesh.make_mesh; moe_sharded on one full-width
     qwen3-moe-235b-a22b layer against moe_dense, f32 (to 1e-5) and bf16
     (the routes that differ), prefill (4 x 1024 tokens) and decode (4),
     the bf16 dispatches timed with CUDA events; compressed_psum on a grad
     tree against its formula; pipeline_apply with one stage against the
     sequential stack (2e-5).  With two or more cards one NCCL rank a card
     runs the sharded parity too; with one, a line says it was not run.
     The bf16 prefill's collectives, traced once (``roofline.trace``), and
     the least time the gathers' copies take beside the sharded - dense
     gap: on one rank they copy nothing (a gather over one rank is a view).
     The group is destroyed at the phase's end.  One JSON line holds it.
     With two or more cards the ranks also hold gemma3-1b's sharded prefill
     (f32, DTensor model) against the plain one, to 1e-5.
  10b. sharded: one NCCL rank, a 1 x 1 mesh; the DTensor model
     (``distributed.layouts.shard_params`` under ``use_rules``) against
     the plain model on the same weights, bit for bit, the kernels on the
     card through their ``local_map`` routes, each path's launches counted
     from 0 in both runs: gemma3-1b's prefill at full width and depth (4 x
     1024; host ms and CUDA-event ms of both, the DTensor dispatch
     overhead), recurrentgemma-2b's and rwkv6-7b's prefill at one
     superblock (the scan and the wkv6), and one h2o-danube-1.8b train step
     at full width cut to 4 layers, 4 x 2048, ``grad_accum=2``,
     ``grad_shardings`` and ``update_constraint`` set (loss, grad norm and
     every parameter).  Then that step as the dry-run builds it, plain and
     as the DTensor step, each run once under ``roofline.trace.OpTrace``:
     flops and bytes equal, and the DTensor step's predicted peak within
     ``PEAK_BAND`` of its measured ``max_memory_allocated``.  A line says
     whether the multi-card parity ran.  One JSON line holds it.
  11. roofline: every step the serving and training phases timed (the
     prefill and the decode step of each serving path, gemma3-1b's decode
     with the int8 cache, the h2o-danube-1.8b,
     recurrentgemma-2b, rwkv6-7b and ``[train_moe]`` train steps) traced
     once on the meta device at the same depth, batch and length
     (``launch.dryrun.trace_cell`` on a 1 x 1 mesh; no kernel launches):
     one ``[roofline]`` line each, a JSON object with the traced flops, the
     compulsory bytes (arguments read once, outputs written once), the
     eager bytes, the model flops, the bound (every flop at the bf16
     tensor-core peak), the measured time, roofline fraction and MFU, and
     the predicted peak memory beside the measured ``max_memory_allocated``
     of that step.  It fails where the bound exceeds the measured time by
     more than 5% (the count would be wrong) or the peaks differ by more
     than ``roofline.analysis.PEAK_BAND``.
  12. dryrun: ``python -m repro_torch.launch.dryrun --arch
     qwen3-moe-235b-a22b --shape train_4k --mesh pod --layers 1`` in a
     subprocess under a 90 s limit: the sharded step at full width, one
     layer, traced on the host as rank 0 of a fake 256-rank world; one
     ``[dryrun]`` line with the record's collectives, per-device flops and
     op count beside a CPU host's and the torch version;
     it fails on a non-zero exit, a timeout or no reduce-scatter.  Then
     gemma2-9b's cell the same way (16 q heads over 8 kv heads on 16
     ``model`` ranks): one ``[dryrun]`` line with its attention flops a
     device, its largest all-gather and flash's local q; it fails unless
     flash runs on 1 local q head (the q-heads route) and every all-gather
     is smaller than the f32 logits of the rank's rows (the vocab-parallel
     loss).  Then paligemma-3b's cell (8 heads on 16 ``model`` ranks, every
     layer under the prefix-LM mask): one ``[dryrun]`` line with its
     attention and other products' flops a device, the q-rows route's
     local q and the k/v projections' local columns; it fails unless the
     plain dispatch ran on one head's S / 2 rows (2 ranks a head) and the
     k/v projections were cut by columns over the 16 ranks.  Then
     recurrentgemma-2b's cell at one superblock (10 heads on 16 ``model``
     ranks: 2 groups of 5 heads, each group's rows over 8 ranks): one
     ``[dryrun]`` line with the traced rank, flash's local q and the
     attention flops a device; it fails unless rank 15 ran flash on 5
     heads' S / 8 rows.  Then rwkv6-7b's cell: one ``[dryrun]`` line with
     its products' flops a device beside the reference's compiled record's
     and their largest shapes; it fails unless they are within 1.05 of the
     reference's and the d x d products ran on the rank's S / 16 rows.
     Then whisper-small's cell (rank 15's products beside the
     reference's), gemma2-9b's decode_32k cell (rank 0's products a device
     beside the reference's; it fails above 1.05 of them), rwkv6-7b's
     decode_32k cell (the same, and its attention; it fails above 1.25 of
     the reference's) and gemma2-9b's
     train_4k cell on ``multipod`` (512 ranks) at the dry-run's grad_accum
     of 4: one ``[dryrun]`` line with its reductions over ``pod`` and
     ``data`` flattened, its parameters and the collectives over ``pod``
     alone; it fails unless each parameter's gradient and each
     microbatch's token count took one reduction there and no all-reduce
     ran over ``pod`` alone.  Each line gives its wall seconds.
  13. multirank, a host check like dryrun, started beside it: the sharded
     model's multi-rank cells under this machine's torch, 8 gloo ranks of
     ``tests/torch_dist_worker.py ... sharded`` on the host's CPU (one
     thread each, a (2, 4) ("data", "model") mesh from a FileStore in a temp
     dir) on inputs built without JAX (``multirank_inputs``: the port's own
     weights from seeded generators, the test's numpy draws): the 15 cells of
     tests/test_torch_sharded.py (prefill and decode, train steps, the
     q-rows and q-heads routes, head groups, the MoE, the vocab-parallel
     loss; smoke configs in f32) and rwkv6-7b at full width cut to one layer
     (prefill 8 x 32, one decode step), the kernels' DTensor routes, the
     head-group layers, rwkv6-7b's mixes on the rows, the reductions over
     flattened mesh dims, the vocab-parallel loss, the MoE fallback,
     ``_microbatch`` and the all-to-all; each output, cache leaf, parameter,
     gradient, loss and grad norm held to the unsharded port computed here
     meanwhile on the same inputs, to 1e-5 relative (tests/
     test_torch_sharded.py's rules).  One ``[multirank]`` line a cell or
     part, one JSON line with the torch version, gloo, the world and mesh,
     each one's largest relative error and the wall seconds; it fails on a
     rank's non-zero exit, its time limit or any mismatch.
  Phase 2 also holds each kernel's autograd function (the kernel forward, the
  plain version's autograd backward) against autograd of the plain version
  over the kernel's sweep, at the kernel's tolerance.
Then a ``[wall]`` line (the run's wall seconds so far), one JSON line
describing each kernel (its launches summed over the serving paths, the int8
cache's included, serve_pipeline, the training paths and the sharded paths,
each counted from 0 just before its run), and last the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

SEED = 0
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
# (BK, S, G, hd, window): both flash kernels with q's rows at a row offset
# q0 in {S/4, S/2, 3S/4}, Sq = S/4 rows against Skv = S keys (the q-rows
# route's shape), each case in f32 (the CUDA-core kernel) and bf16 (the
# tensor-core kernel at hd 64, 128 and 256)
Q0_SWEEP = [(2, 512, 2, 64, 0), (2, 512, 4, 64, 96), (2, 512, 3, 128, 0),
            (1, 512, 4, 128, 200), (1, 512, 2, 256, 0), (1, 512, 2, 256, 64)]
# the gradient sweep's q block: S = 256 packs (no window) or scans q blocks
# (a window; S = 192), S = 128 is one masked square
GRAD_Q_BLOCK = 64
# (B, Sq, q0, G, hd, window): gradients of the rows at q0 (a rank's block
# on the q-rows route) against the keys up to their last row
GRAD_Q0 = [(2, 64, 192, 4, 64, 0), (2, 64, 128, 2, 128, 48)]
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
    # causal self-attention only: whisper's encoder (bidirectional), its
    # cross-attention and paligemma's prefix-LM mask run the plain path, as
    # in the reference
    "qwen3-moe-235b-a22b": {"flash_attention": 8, "flash_attention:wgmma": 8,
                            "flash_attention:fma": 0},
    "arctic-480b": {"flash_attention": 2, "flash_attention:wgmma": 2,
                    "flash_attention:fma": 0},
    "whisper-small": {"flash_attention": 12, "flash_attention:wgmma": 12,
                      "flash_attention:fma": 0},
    "paligemma-3b": {"flash_attention": 0, "flash_attention:wgmma": 0,
                     "flash_attention:fma": 0},
}
# depth cuts at full width: qwen3-moe's 94 layers (2.49 B params each) and
# arctic's 35 (13.6 B each) do not fit one card; their f32 gate (phase 6)
# holds half as many layers again, as f32 weights take twice the bytes
DEPTH = {"qwen3-moe-235b-a22b": 8, "arctic-480b": 2}
F32_DEPTH = {"qwen3-moe-235b-a22b": 4, "arctic-480b": 1}
SWAPPED = {"gemma3-1b": "flash_attention", "recurrentgemma-2b": "rglru_scan",
           "rwkv6-7b": "wkv6", "qwen3-moe-235b-a22b": "flash_attention",
           "arctic-480b": "flash_attention", "whisper-small": "flash_attention"}
# the kernel phase 6 swaps for its plain version (paligemma's path has none)
RECURRENT = ("recurrentgemma-2b", "rwkv6-7b")
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")
KV_QUANT_BOUND = 0.5          # tests/test_smoke_archs.py::test_kv_quant_decode_parity
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5     # h2o-danube-1.8b training
REC_TRAIN_B, REC_TRAIN_S = 4, 1024            # the recurrent archs' train step
LR_TRAIN = 1e-4
# [train_moe]: the MoE, whisper and paligemma configs at full width, one
# timed step each at 4 x 1024 positions; the MoE configs at the depth one
# card holds (0: full depth), each step's peak held under PEAK_GB_LIMIT
TRAIN_MOE_DEPTH = {"qwen3-moe-235b-a22b": 4, "arctic-480b": 1,
                   "whisper-small": 0, "paligemma-3b": 0}
TRAIN_MOE_B, TRAIN_MOE_S = 4, 1024
PEAK_GB_LIMIT = 75.0
DIST_F32_TOL = 1e-5           # moe_sharded vs moe_dense in f32, relative
TRAIN_TOL = {"loss": 2e-2, "grad_norm": 5e-2}  # kernels vs plain, bf16
SMOKE_TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3}  # card vs CPU, f32, tf32 off
ROOFLINE_SLACK = 1.05         # a bound above the measured time: a wrong count
KINDS_OF = {"flash_attention": ("local", "global"), "rglru_scan": ("rglru",),
            "wkv6": ("rwkv",)}
VARIANT = {"flash_attention": "wgmma", "rglru_scan": "grouped",
           "wkv6": "chunk"}           # the kernel each wrapper launches
SHARDED_TRAIN_LAYERS = 4      # [sharded]: h2o-danube-1.8b's step, cut from 24
# [dryrun]: one production cell traced as rank 0 of a fake 256-rank world in
# a subprocess, cut to one layer, under its own time limit
DRYRUN_CELL = ("qwen3-moe-235b-a22b", "train_4k", "pod")
# and gemma2-9b's, whose 8 kv heads do not split over 16 ``model`` ranks:
# flash on each rank's own q head, the loss vocab-parallel
DRYRUN_HEADS_CELL = ("gemma2-9b", "train_4k", "pod")
# and paligemma-3b's, whose 8 heads spread over 16 ``model`` ranks under the
# prefix-LM mask: the plain dispatch on each rank's block of one head's
# rows (the q-rows route), the k and v projections cut by columns
DRYRUN_ROWS_CELL = ("paligemma-3b", "train_4k", "pod")
# and recurrentgemma-2b's at one superblock (3 layers), whose 10 heads do
# not divide 16 ``model`` ranks: flash on 5 heads' S / 8 rows a rank (2 head
# groups, each group's rows over 8 ranks), the heaviest rank traced
DRYRUN_GROUPS_CELL = ("recurrentgemma-2b", "train_4k", "pod")
DRYRUN_GROUPS_LAYERS = 3
# and rwkv6-7b's, whose mixes run each rank's rows of the residual stream:
# its products a device against the reference's compiled record of the
# same cell (jax 0.9.0 on a CPU host, PERF.md section 7; the grad_accum of
# 4 moves no product flops), the d x d products on the rank's S / 16 rows
DRYRUN_RWKV_CELL = ("rwkv6-7b", "train_4k", "pod")
DRYRUN_RWKV_REFERENCE_PRODUCTS = 13782550052864
DRYRUN_PRODUCTS_SLACK = 1.05
# and whisper-small's, whose vocab of 51865 does not split over 16 ``model``
# ranks: its head on each rank's rows (the forward, dx and dW each on S / 16
# of them), the traced rank 15's products a device against the reference's
# compiled record of the same cell (jax 0.9.0 on a CPU host, PERF.md
# section 7)
DRYRUN_WHISPER_CELL = ("whisper-small", "train_4k", "pod")
DRYRUN_WHISPER_REFERENCE_PRODUCTS = 3666865029120
# the gemma2-9b and rwkv6-7b cells' reduce-scatter and all-reduce operand
# bytes at rank 0 at a grad_accum of 1 (tests/dryrun_records_worker.py
# ``--accum 1``, torch 2.13.0+cpu on a CPU host): the step reduces each
# parameter's gradient once, so the dry-run's grad_accum of 4 reduce-
# scatters no more than these (within DRYRUN_REDUCE_SLACK)
DRYRUN_ACCUM1_BYTES = {
    "gemma2-9b": {"reduce-scatter": 2985558016, "all-reduce": 537729040},
    "rwkv6-7b": {"reduce-scatter": 2233467904, "all-reduce": 209682448}}
DRYRUN_REDUCE_SLACK = 1.01
# and gemma2-9b's decode_32k cell at full width and one superblock (its
# local and global layers; the reference's layer scan takes no fewer):
# rank 0's products a device against the reference's compiled record of
# the same cell (jax 0.9.0 on a CPU host, PERF.md section 7; C16: a decode
# step's residual stream laid out replicated over ``model`` after each
# sublayer)
DRYRUN_DECODE_CELL = ("gemma2-9b", "decode_32k", "pod")
DRYRUN_DECODE_LAYERS = 2
DRYRUN_DECODE_REFERENCE_PRODUCTS = 1754267648
# and rwkv6-7b's decode_32k cell at full width and one layer: rank 0's
# products and attention (the LoRA's second product and the recurrence's
# r . S, both batched) a device against the reference's compiled record of
# the same cell (jax 0.9.0 on a CPU host, PERF.md section 7; C17: the
# LoRAs on each rank's block of the model dim, the recurrence on each
# rank's rows and heads)
DRYRUN_RWKV_DECODE_CELL = ("rwkv6-7b", "decode_32k", "pod")
DRYRUN_RWKV_DECODE_REFERENCE_PRODUCTS = 487718912
DRYRUN_RWKV_DECODE_REFERENCE_ATTENTION = 917504
DRYRUN_ATTENTION_SLACK = 1.25
# and gemma2-9b's train_4k cell on ``multipod`` at the dry-run's grad_accum:
# each parameter's gradient reduced in one collective over ``pod`` and
# ``data`` flattened (32 ranks, 512 with ``model``), none over ``pod``
# alone (C15)
DRYRUN_MULTIPOD_CELL = ("gemma2-9b", "train_4k", "multipod")
DRYRUN_LAYERS = 1
DRYRUN_TIMEOUT_S = 90
# the same cell's trace on a CPU host (torch 2.13.0+cpu): printed beside the
# card machine's, so that a torch whose DTensor issues other ops or
# collectives, or whose bookkeeping the trace filters otherwise, shows
DRYRUN_CPU = {"torch": "2.13.0+cpu", "ops": 10971,
              "collective_counts": {"all-gather": 106, "all-reduce": 110,
                                    "reduce-scatter": 47, "all-to-all": 8,
                                    "collective-permute": 0}}
# [multirank]: the sharded model's multi-rank cells (tests/torch_dist_worker.py
# ``sharded``, tests/test_torch_sharded.py's cells) on the host: WORLD gloo
# ranks on CPU tensors, a (2, 4) ("data", "model") mesh, every output held to
# the unsharded port in this process to DIST_F32_TOL, under its own limit
MULTIRANK_WORLD = 8
MULTIRANK_TIMEOUT_S = 300
# and one cell at full width: rwkv6-7b cut to one layer, prefill 8 x 32 and
# one decode step (C17's family, whose collectives torch 2.11 chose
# otherwise); the CPU rehearsal runs it at smoke width
MULTIRANK_FULL_CELL = ("rwf", "rwkv6-7b", 1)
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
    from repro_torch.roofline.bounds import flash_bound

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

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        worst, worst_emu, used = 0.0, 0.0, set()
        for BK, S_, G, hd, win in Q0_SWEEP:
            k, v = randn((BK, S_, hd), dtype), randn((BK, S_, hd), dtype)
            for q0 in (S_ // 4, S_ // 2, 3 * S_ // 4):
                q = randn((BK, S_ // 4, G, hd), dtype)
                kw = dict(scale=hd ** -0.5, window=win, q0=q0)
                o, which = launch(q, k, v, **kw)
                used.add(which)
                ref = flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (o.float() - ref.float()).abs().max().item()
                check(o.dtype == dtype and o.shape == q.shape,
                      "kernel output type at q0")
                check(err <= TOL[dname], f"q0 sweep {dname} "
                      f"{(BK, S_, G, hd, win, q0)} max err {err} > {TOL[dname]}")
                worst = max(worst, err)
                if which == "wgmma":
                    emu = flash_attention_wgmma_ref(q, k, v, **kw)
                    worst_emu = max(worst_emu, (o.float() - emu.float())
                                    .abs().max().item())
        check(used == {"fma" if dtype == torch.float32 else "wgmma"},
              f"q0 sweep {dname} took {used}")
        sweep_err[f"{dname} q0"] = worst
        print(f"[kernels] flash q0 sweep {dname} ({'/'.join(used)} kernel; Sq "
              f"= S/4 rows at q0 = S/4, S/2, 3S/4 against S keys; G > 1; "
              f"hd 64/128/256; windows 0/64/96/200): max abs err {worst:.3g} "
              f"(tol {TOL[dname]})" + (f", vs its numerics' plain version "
                                       f"{worst_emu:.3g}" if worst_emu else ""))

    rows = {}
    gemma3, rgemma = get_config("gemma3-1b"), get_config("recurrentgemma-2b")
    qwen3, arctic = get_config("qwen3-moe-235b-a22b"), get_config("arctic-480b")
    whisper = get_config("whisper-small")
    # (label, config, window, positions): each path's prefill shape;
    # whisper's decoder attends over its S // 4 tokens
    for label, cfg, win, Sq in (
            ("local", gemma3, gemma3.window_size, S), ("global", gemma3, 0, S),
            ("recurrentgemma_local", rgemma, rgemma.window_size, S),
            ("qwen3_moe", qwen3, 0, S), ("arctic", arctic, 0, S),
            ("whisper_decoder", whisper, 0, S // whisper.dec_len_ratio)):
        BK, G, hd = B * cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
        q = randn((BK, Sq, G, hd), torch.bfloat16)
        k, v = randn((BK, Sq, hd), torch.bfloat16), randn((BK, Sq, hd),
                                                          torch.bfloat16)
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
        pos = torch.arange(Sq, device=dev)
        allow = pos[None, :] <= pos[:, None]
        if win:
            allow &= pos[None, :] > pos[:, None] - win
        qs = q.permute(0, 2, 1, 3)
        ks = k[:, None].expand(BK, G, Sq, hd)
        vs = v[:, None].expand(BK, G, Sq, hd)
        lib_err = (F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=allow, scale=kw["scale"]).permute(0, 2, 1, 3)
            .float() - ref.float()).abs().max().item()
        bound_ms, bound_by = flash_bound(BK, Sq, G, hd, win)
        row = {
            "shape": f"BK={BK} Sq=Skv={Sq} G={G} hd={hd} bf16 window={win}",
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
        if not win:
            row["library_causal"] = sdpa_causal(torch, F, q, k, v, kw["scale"],
                                                ref)
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
        if "library_causal" in row:
            lc = row["library_causal"]
            print(f"[kernels] flash {cfg.name} {label}: the fastest causal "
                  f"SDPA call ({lc['backend']}, {lc['kv']}) {lc['ms']:.4f} ms "
                  f"(max abs err {lc['max_abs_err']:.3g}), kernel_ms / that "
                  f"{row['ms'] / lc['ms']:.3f}; each backend tried: "
                  f"{lc['tried']}")
    return sweep_err, rows


def sdpa_causal(torch, F, q, k, v, scale, ref) -> dict:
    """The fastest single ``scaled_dot_product_attention`` call with
    ``is_causal=True`` on one flash shape (q (BK, S, G, hd), one kv head a
    row of BK), each backend forced in turn: k/v as one head with
    ``enable_gqa=True``, or, where the backend refuses that, expanded to
    the G heads and made contiguous outside the timed region.  q is made
    contiguous in SDPA's layout outside it too.  A yardstick: the port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    BK, Sq, G, hd = q.shape
    qs = q.permute(0, 2, 1, 3).contiguous()
    forms = {"enable_gqa": (k[:, None].contiguous(), v[:, None].contiguous(),
                            True),
             "k/v expanded": (k[:, None].expand(BK, G, Sq, hd).contiguous(),
                              v[:, None].expand(BK, G, Sq, hd).contiguous(),
                              False)}
    best, tried = None, {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for form, (ks, vs, gqa) in forms.items():
            def call():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, scale=scale, enable_gqa=gqa)
            try:
                # a refusing backend warns why before it raises
                with sdpa_kernel([backend]), warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    o = call()
                    torch.cuda.synchronize()
                    ms = time_ms(torch, call)
            except RuntimeError as e:
                tried[f"{backend.name} {form}"] = \
                    f"refused: {str(e).splitlines()[0][:80]}"
                continue
            err = (o.permute(0, 2, 1, 3).float() - ref.float()).abs().max()
            r = {"ms": ms, "backend": backend.name, "kv": form,
                 "max_abs_err": err.item()}
            tried[f"{backend.name} {form}"] = round(ms, 4)
            if best is None or ms < best["ms"]:
                best = r
            break
    check(best is not None, f"no SDPA backend ran causal attention: {tried}")
    return {**best, "tried": tried}


def check_rglru(torch, randn):
    """The channel-group kernel (the wrapper's route) and the earlier
    one-thread-per-channel kernel against the plain version run in f64 (in
    f32 its own rounding drifts past 2e-5 where a is near 1 over 1024
    steps); returns the row of each at recurrentgemma-2b's prefill shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.rglru_scan import rglru_scan_bsc, rglru_scan_ref
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_thread
    from repro_torch.roofline.bounds import rglru_bound

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
    from repro_torch.roofline.bounds import wkv6_bound

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
    in the model's layout (B, S, K=1, G, hd) at q block ``GRAD_Q_BLOCK``, its
    backward recomputed through the reference's q-block dispatch
    (``causal_attention``: packed, q-block scan or one square), against the
    whole-square eager attention, and at row offsets (``GRAD_Q0``), output
    and gradients, against the whole square of q0 + Sq rows with those rows
    sliced out of its output (no row offset on that side); the scan and the wkv6 (y and final
    state) against their plain versions in f64.  Returns the worst error by
    kernel."""
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
            (o,), got = grads_of(torch, lambda *t: flash_attention(
                *t, q_block=GRAD_Q_BLOCK, pack=True, **kw), ins, go)
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
        for B_, Sq, q0, G, hd, win in GRAD_Q0:
            # held against an independent computation: the whole square of
            # q0 + Sq rows (the first q0 of them fixed), the rows at q0..
            # sliced out of its output
            kw = dict(window=win, scale=hd ** -0.5)
            head = randn((B_, q0, 1, G, hd), dtype)
            ins = (randn((B_, Sq, 1, G, hd), dtype),
                   randn((B_, q0 + Sq, 1, hd), dtype),
                   randn((B_, q0 + Sq, 1, hd), dtype))
            go = (randn((B_, Sq, 1, G, hd), dtype),)
            (o,), got = grads_of(torch, lambda *t: flash_attention(
                *t, q0=q0, q_block=GRAD_Q_BLOCK, pack=True, **kw), ins, go)
            (w,), want = grads_of(torch, lambda q, k, v: plain_attention(
                torch.cat([head, q], dim=1), k, v, **kw)[:, q0:], ins, go)
            err = max((g.float() - w_.float()).abs().max().item()
                      for g, w_ in zip((o, *got), (w, *want)))
            check(excess((o, *got), (w, *want), TOL[dname]) <= TOL[dname],
                  f"flash output and grads {dname} at q0 "
                  f"{(B_, Sq, q0, G, hd, win)}: {err}")
            worst[f"flash_attention {dname} q0"] = max(
                worst.get(f"flash_attention {dname} q0", 0.0), err)
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


def plain_flash(q, k, v, *, window, softcap, scale, q_block, pack, q0=0):
    """The flash hook's plain version (``flash_attention_ref``, P·V in f32
    as the kernels) in the model's layout, q's rows at positions q0..; the
    hook's ``q_block`` and ``pack`` do not change it."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    Bq, Sq, K, Gq, hdq = q.shape
    qf = q.permute(0, 2, 1, 3, 4).reshape(Bq * K, Sq, Gq, hdq)
    kf = k.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
    vf = v.permute(0, 2, 1, 3).reshape(Bq * K, -1, hdq)
    o = flash_attention_ref(qf, kf, vf, scale=scale, softcap=softcap,
                            window=window, q0=q0)
    return o.reshape(Bq, K, Sq, Gq, hdq).permute(0, 2, 1, 3, 4)


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
    from repro_torch.models import attention as attn
    attn.set_attention_impl(plain_flash)
    return kernels.enable_flash_attention


def shadow_with_plain(torch, arch, errs):
    """Make every call of the path's kernel (the one phase 6 swaps) also run
    its plain version on the same inputs and append (max abs err, allclose
    excess) of each output to ``errs``; returns the function that undoes
    it."""
    if SWAPPED[arch] == "flash_attention":
        from repro_torch import kernels
        from repro_torch.models import attention as attn

        def flash_both(q, k, v, **kw):
            o, w = kernels.flash_attention(q, k, v, **kw), plain_flash(
                q, k, v, **kw)
            tol = TOL[str(q.dtype).split(".")[1]]
            errs.append(((o.float() - w.float()).abs().max().item(),
                         max_excess(torch, o, w, tol)))
            return o
        attn.set_attention_impl(flash_both)
        return kernels.enable_flash_attention
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


@contextlib.contextmanager
def recorded_routes(out):
    """Append each MoE routing's expert set (its indices sorted, (T, k)) to
    ``out``, call by call, for the block's duration."""
    from repro_torch.models import moe
    route = moe._route

    def recording(x, router, k):
        r = route(x, router, k)
        out.append(r[1].sort(dim=1).values)
        return r
    moe._route = recording
    try:
        yield out
    finally:
        moe._route = route


def differing_routes(a, b) -> int:
    """The (layer, token) routes whose expert sets differ between two runs."""
    check(len(a) == len(b), f"{len(a)} vs {len(b)} routings")
    return sum(int((x != y).any(dim=1).sum()) for x, y in zip(a, b))


def path_config(arch):
    """The full-width config of a path, at its depth (``DEPTH``)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    return cfg


def serve_path(torch, np, dev, arch):
    """Prefill, decode, engine and reference of one architecture at full
    width.  Returns the launches its main path made, by kernel, and a row
    of its numbers."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.models.io import make_batch
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.steps import build_decode_step, build_prefill_step

    cfg = path_config(arch)
    want = {name: n for name, n in PATHS[arch].items() if n}
    row = {"layers": cfg.n_layers}
    # ---- 3. prefill at full width ------------------------------------------
    gc.collect()                # earlier paths' models in reference cycles
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if arch in MOE:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        batch = make_batch(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           B, S)
        model32 = None
    else:
        # the timed record's weights and inputs: the f32 model drawn on the
        # host (kept there while the bf16 model is timed), the bf16 one cast
        # from it
        name = golden.timed_name(arch)
        model32, model, inp = timed_models(torch, dev, name, cfg)
        batch = golden.batch_of(inp, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[prefill] {arch} full width, {cfg.n_layers} layers: "
          f"{n_params / 1e9:.3f} B params ({n_params * 2 / 1e9:.2f} GB bf16), "
          f"init {time.perf_counter() - t0:.1f} s ("
          f"{'seeded generator' if arch in MOE else 'the timed record'})")
    n_pos = golden.decode_start(cfg, batch)
    prefill = build_prefill_step(cfg)
    prefill(model, batch)                         # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    phase_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)       # the prefill's own peak

    cuda_lib.launches.clear()                     # the main path starts here
    t0 = time.perf_counter()
    next_tok, cache = prefill(model, batch)
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
            L = min(cfg.window_size, n_pos) if kind == "local" else n_pos
            shape = (cfg.n_superblocks, B, L, cfg.n_kv_heads, cfg.head_dim)
            got = tuple(cache["blocks"][j]["k"].shape)
            check(got == shape, f"cache block {j} shape {got}, want {shape}")
            if cfg.encoder_decoder:
                shape = (cfg.n_superblocks, B, S, cfg.n_kv_heads, cfg.head_dim)
                got = tuple(cache["blocks"][j]["ck"].shape)
                check(got == shape, f"cross cache {j} shape {got}, want {shape}")
    check(len(cache["tail"]) == cfg.n_tail, "cache tail")
    check(all(bool(torch.isfinite(t).all()) for t in cache_leaves(cache)),
          "cache finite")
    prefill_peak = torch.cuda.max_memory_allocated(dev)
    peak_gb = (prefill_peak - before) / 1e9
    row.update(prefill_ms=prefill_ms, prefill_launches=prefill_launches,
               n_params=n_params, prefill_peak_gb=prefill_peak / 1e9)
    print(f"[prefill] {arch} {B}x{S} positions ({sorted(batch)}): "
          f"{prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.0f} positions/s), "
          f"launches {prefill_launches}, peak memory above the weights "
          f"{peak_gb:.2f} GB")

    # ---- 4. decode from the prefill cache -----------------------------------
    decode = build_decode_step(cfg)
    tok = next_tok[:, None]
    step_ms = []
    phase_peak = max(phase_peak, prefill_peak)
    torch.cuda.reset_peak_memory_stats(dev)       # the decode steps' peak
    for i in range(8):
        t0 = time.perf_counter()
        tok, cache = decode(model, cache, tok, n_pos + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    logits, cache = forward_decode(model, cfg, cache, tok, n_pos + 8)
    torch.cuda.synchronize()
    check(logits.shape == (B, 1, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), "decode logits finite")
    med = float(np.median(step_ms))
    row["decode_ms"] = med
    row["decode_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[decode] {arch} 8 steps at batch {B}: median {med:.2f} ms/step "
          f"({med / B:.3f} ms/token, {B / med * 1e3:.0f} tok/s); "
          f"steps ms {[round(t, 2) for t in step_ms]}")
    del cache, logits

    # ---- 5. engine ------------------------------------------------------------
    eng = ServingEngine(cfg, model, n_slots=golden.ENGINE["n_slots"],
                        max_len=golden.ENGINE["max_len"], device=dev)
    golden.submit(eng, Request, golden.engine_prompts(arch, cfg))
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done)
    check(sorted(r.req_id for r in done) == [0, 1, 2, 3],
          "engine completed every request")
    check(all(1 <= len(r.tokens_out) <= golden.ENGINE["max_new"] and
              all(0 <= t < cfg.vocab_size for t in r.tokens_out) for r in done),
          "engine tokens")
    main_launches = {name: n for name, n in cuda_lib.launches.items() if n}
    check(main_launches == prefill_launches,
          f"decode and engine launched kernels: {main_launches} after the "
          f"prefill's {prefill_launches}, want no more")
    row["engine_tok_s"] = n_tok / eng_s
    print(f"[engine] {arch} {len(done)} requests, {n_tok} tokens in "
          f"{eng_s:.2f} s ({n_tok / eng_s:.1f} generated tok/s, prompts fed "
          f"token by token)")
    del eng

    # ---- 5b. the timed path against the reference's own outputs ---------------
    if model32 is not None:
        stored = golden.load(golden.TIMED_GOLDEN)
        row["golden"] = {"bfloat16": golden_cell(torch, dev, stored, name,
                                                 "bfloat16", model)}

    # ---- 6. against the plain version -----------------------------------------
    if arch not in SWAPPED:
        kernel_logits, _ = forward_prefill(model, cfg, batch)
        check(bool(torch.isfinite(kernel_logits).all()),
              f"{arch} full-width logits finite")
        print(f"[reference] {arch}: no kernel of the port lies on this path "
              f"(prefix-LM attention is the plain path, as in the reference)")
        del kernel_logits
    else:
        reference_full_width(torch, dev, arch, cfg, model, batch, want, row)
    row["peak_gb"] = max(phase_peak, torch.cuda.max_memory_allocated(dev)) / 1e9
    print(f"[reference] {arch}: peak memory of the phase "
          f"{row['peak_gb']:.2f} GB")

    # ---- 6a. its f32 record (prefill, decode, engine), then its cut cells -----
    if model32 is not None:
        model.to("meta")
        torch.cuda.empty_cache()
        row["golden"]["float32"] = golden_cell(torch, dev, stored, name,
                                               "float32", model32.to(dev))
        model32.to("meta")
        torch.cuda.empty_cache()
        for cut in golden.cut_cells(name):
            row["golden"][cut] = golden_cut_cell(torch, dev, stored, cut)
    del model, model32, batch

    # ---- 6b. a MoE path's record: its experts cut, on a model of its own ------
    if arch in MOE:
        gc.collect()
        torch.cuda.empty_cache()
        stored = golden.load(golden.MOE_GOLDEN)
        cells = [n for n, c in golden.MOE_TIMED.items() if c.arch == arch]
        check(len(cells) == 1 and golden.cell_config(cells[0], "bfloat16") ==
              dataclasses.replace(cfg, moe=golden.cell_config(
                  cells[0], "bfloat16").moe),
              f"{arch}: the record {cells} is not the timed path's cut")
        row["golden"] = {cells[0]: golden_cut_cell(torch, dev, stored,
                                                   cells[0])}

    small = get_smoke_config(arch)
    if arch in MOE:
        # in bf16 a near-tie in a router's top-k, moved by rounding, picks
        # another expert for that token (tests/test_torch_moe.py): compare
        # the two devices in f32, where the card's flash is its CUDA-core
        # kernel and tf32 is off
        small = dataclasses.replace(small, param_dtype="float32")
    cpu_model = init_params(small, torch.Generator().manual_seed(SEED),
                            device="cpu")
    small_batch = make_batch(small, torch.Generator().manual_seed(SEED), 2, 64)
    cl, ccache = forward_prefill(cpu_model, small, small_batch)
    gl, gcache = forward_prefill(cpu_model.to(dev), small,
                                 {k: v.to(dev) for k, v in small_batch.items()})
    torch.cuda.synchronize()
    small_err = (gl.float().cpu() - cl.float()).abs().max().item()
    cache_err = max(rel_err(torch, g.cpu(), c)
                    for g, c in zip(cache_leaves(gcache), cache_leaves(ccache)))
    check(small_err <= MODEL_TOL and cache_err <= MODEL_TOL,
          f"{arch} smoke config card vs cpu: logits {small_err}, cache "
          f"{cache_err}")
    print(f"[reference] {arch} smoke config ({small.param_dtype}), card "
          f"(kernels) vs CPU (plain): logits max abs err {small_err:.3g}, "
          f"cache relative error {cache_err:.3g} (tol {MODEL_TOL})")
    return main_launches, row


def timed_models(torch, dev, name, cfg):
    """(f32 model on the host, bf16 model on the card, numpy inputs) of a
    ``golden.TIMED`` cell: the record's weights (``golden.model``, a
    ``BlockDraws`` draw; the bf16 leaves cast from the f32 ones) and
    inputs.  ``cfg``: the timed path's config, which must be the cell's."""
    from repro_torch.launch import golden
    check(golden.cell_config(name, cfg.param_dtype) == cfg,
          f"{name}: the timed config is not the record's")
    model32 = golden.model(golden.cell_config(name, "float32"), golden.SEED,
                           "cpu")
    model = golden.cast(model32, cfg).to(dev)
    return model32, model, golden.inputs(name, cfg)


@contextlib.contextmanager
def tf32_off(torch):
    """Full f32 products (matmul and cuDNN) for the block's duration."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def golden_cell(torch, dev, stored, name, dtype, m) -> dict:
    """One golden record on the card (``golden.run_cell`` on ``m``, built
    already: its checksums, its inputs, its prefill, decode and engine
    against the file's), tf32 off, launches counted from 0 and held to
    ``golden_launches``; one ``[golden]`` line.  A record out of tolerance
    is run again with each of its kernels swapped for its plain version
    (``golden_diagnosis``), then the run fails."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    cfg = golden.cell_config(name, dtype)
    c = golden.cell(name)
    want = golden_launches(cfg, dtype)
    with tf32_off(torch):
        cuda_lib.launches.clear()
        r = golden.run_cell(name, dtype, dev, stored, m)
        got = {k: n for k, n in cuda_lib.launches.items() if n}
    check(got == want, f"[golden] {name} {dtype} launched {got}, want {want}")
    e = r["errors"]
    line = (f"[golden] {name} {dtype} ({cfg.n_layers} layers, {c.batch} x "
            f"{c.seq} positions): prefill sketch "
            f"{e['prefill']['sketch_rel']:.3g}, logsumexp "
            f"{e['prefill']['lse_in_sizes']:.3g} sizes, argmax "
            f"{e['prefill']['argmax_differs']} of "
            f"{e['prefill']['argmax_checked']} differ; decode sketch "
            f"{e['decode']['sketch_rel']:.3g}, logsumexp "
            f"{e['decode']['lse_in_sizes']:.3g}, argmax "
            f"{e['decode']['argmax_differs']} of "
            f"{e['decode']['argmax_checked']}")
    if "engine" in e:
        g = e["engine"]
        line += (f"; engine {g['steps_checked']} of {g['steps']} steps "
                 f"checked, sketch {g.get('sketch_rel', float('nan')):.3g}, "
                 f"logsumexp {g.get('lse_in_sizes', float('nan')):.3g}, "
                 f"argmax {g.get('argmax_differs')} of "
                 f"{g.get('argmax_checked')}, rows differ {g['rows_differ']}")
    if "drift" in r:
        d = r["drift"]
        line += (f"; prefill sketch from the f32 record: port "
                 f"{d['port_vs_f32']['prefill']:.3g}, reference "
                 f"{d['reference_vs_f32']['prefill']:.3g} (ratio "
                 f"{d['ratio']:.3g}, within {golden.DRIFT_RATIO}x of 1)")
    print(line + f" (tol {tol_text(r['tol'])}); launches {got}; weights "
          f"{r['weights_s']:.1f} s, run {r['run_s']:.1f} s", flush=True)
    if not e["ok"]:
        with tf32_off(torch):
            golden_diagnosis(torch, dev, stored, name, dtype, want, m)
    check(e["ok"], f"[golden] {name} {dtype} against the reference's "
                   f"outputs: {e}")
    return {**r, "launches": got}


def tol_text(tol: dict) -> str:
    """``golden.tolerance``'s limits, one number where all are alike."""
    flat = {f"{p}:{m}": v for p, ms in tol.items() for m, v in ms.items()}
    if len(set(flat.values())) == 1:
        return str(next(iter(flat.values())))
    common = {}
    for m in {k.split(":")[1] for k in flat}:
        vals = {flat[k] for k in flat if k.endswith(":" + m)}
        if len(vals) == 1:
            common[m] = vals.pop()
    return ", ".join([f"{m} {v}" for m, v in sorted(common.items())] +
                     [f"{k} {v}" for k, v in sorted(flat.items())
                      if k.split(":")[1] not in common])


def golden_cut_cell(torch, dev, stored, name) -> dict:
    """A ``TIMED`` cell cut in depth, on a model of its own: its f32
    weights drawn on the card, then cast to bf16, each held to its record
    (``golden_cell``)."""
    from repro_torch.launch import golden
    out = {}
    m = golden.model(golden.cell_config(name, "float32"), golden.SEED, dev)
    for dtype in golden.cell(name).dtypes:
        cfg = golden.cell_config(name, dtype)
        out[dtype] = golden_cell(torch, dev, stored, name, dtype,
                                 m if dtype == "float32" else
                                 golden.cast(m, cfg))
    del m
    torch.cuda.empty_cache()
    return out


def golden_launches(cfg, dtype: str) -> dict:
    """The kernels one golden cell's prefill launches (its decode none):
    flash once a causal self-attention layer (none under paligemma's
    prefix-LM mask; whisper's encoder and cross-attention run the plain
    path), on the CUDA-core kernel in f32 and ``wgmma`` in bf16; the scan
    and the wkv6 once a layer of theirs."""
    kinds = cfg.layer_kinds()
    n_flash = 0 if cfg.frontend == "vision" else \
        sum(k in ("local", "global") for k in kinds)
    variant = "wgmma" if dtype == "bfloat16" else "fma"
    want = {}
    for name, n in (("flash_attention", n_flash),
                    (f"flash_attention:{variant}", n_flash),
                    ("rglru_scan", kinds.count("rglru")),
                    ("rglru_scan:grouped", kinds.count("rglru")),
                    ("wkv6", kinds.count("rwkv")),
                    ("wkv6:chunk", kinds.count("rwkv"))):
        if n:
            want[name] = n
    return want


def golden_path(torch, dev, card) -> dict:
    """Phase 6b: every full-width golden cell on the card against the
    reference's outputs (``golden_cell``).  A cell's bf16 weights are its
    f32 ones cast (the file's checksums hold them all the same): one host
    draw a cell."""
    from repro_torch.launch import golden

    stored = golden.load()
    rows, t_phase, f32 = {}, time.perf_counter(), None
    try:
        for name, dtype in golden.runs():
            cfg = golden.cell_config(name, dtype)
            t0 = time.perf_counter()
            if dtype == "float32":
                f32 = None
                gc.collect()
                f32 = golden.model(cfg, golden.SEED, dev)
                m = f32
            else:
                m = golden.cast(f32, cfg)
            drawn = time.perf_counter() - t0
            r = golden_cell(torch, dev, stored, name, dtype, m)
            r["weights_s"] += drawn
            del m
            rows[f"{name} {dtype}"] = r
    finally:
        del f32
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[golden] {len(rows)} cells within tolerance on {card} in "
          f"{seconds:.1f} s")
    return {"card": card, "seconds": seconds, "cells": rows}


def golden_diagnosis(torch, dev, stored, name, dtype, want, m):
    """Run a failing golden cell again on its model ``m`` with each of its
    kernels swapped for its plain version, and print each run's errors."""
    from repro_torch.launch import golden
    arch = golden.cell(name).arch
    for kernel in ("flash_attention", "rglru_scan", "wkv6"):
        if kernel not in want:
            continue
        restore = swap_for_plain(arch, kernel)
        try:
            r = golden.run_cell(name, dtype, dev, stored, m)
        finally:
            restore()
        print(f"[golden] {name} {dtype} with {kernel} swapped for its plain "
              f"version: {json.dumps(r['errors'])}", flush=True)


def reference_full_width(torch, dev, arch, cfg, model, batch, want, row):
    """Phase 6 at full width: the prefill with the path's kernel against the
    same with its plain version.  The recurrent and MoE paths also hold each
    kernel call of the bf16 prefill against its plain version on the same
    inputs; the MoE paths count the routes that differ between the two runs
    and, where any does, gate the logits with f32 weights (a random bf16
    stack amplifies rounding, and a router's near-tie picks another expert
    for a token)."""
    from repro_torch.models import forward_prefill, init_params
    kernel = SWAPPED[arch]
    calls, routes = [], {"kernel": [], "plain": []}
    shadow = arch in RECURRENT or arch in MOE
    restore = shadow_with_plain(torch, arch, calls) if shadow \
        else (lambda: None)
    try:
        with recorded_routes(routes["kernel"]):
            kernel_logits, _ = forward_prefill(model, cfg, batch)
    finally:
        restore()
    if shadow:
        tol = TOL["bfloat16"] if kernel == "flash_attention" \
            else recurrent_kernel(arch)[3]
        n_out = 2 if arch == "rwkv6-7b" else 1          # wkv6 also has S_last
        check(len(calls) == want[kernel] * n_out,
              f"{arch}: {len(calls)} kernel outputs compared")
        worst = max(e for e, _ in calls)
        check(max(x for _, x in calls) <= tol,
              f"{arch} full width, kernel vs plain on the same inputs, call "
              f"by call: max abs err {worst}")
        row["calls_max_abs_err"] = worst
        print(f"[reference] {arch} full width, each of the {want[kernel]} "
              f"{kernel} calls of a prefill against its plain version on the "
              f"same inputs: max abs err {worst:.3g} (allclose tol {tol})")
    restore = swap_for_plain(arch)
    try:
        forward_prefill(model, cfg, batch)                     # warm-up
        torch.cuda.synchronize()
        routes["plain"].clear()
        with recorded_routes(routes["plain"]):
            t0 = time.perf_counter()
            plain_logits, _ = forward_prefill(model, cfg, batch)
            torch.cuda.synchronize()
            plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    full_err = rel_err(torch, kernel_logits, plain_logits)
    check(bool(torch.isfinite(kernel_logits).all()),
          f"{arch} full-width logits finite")
    flips = differing_routes(routes["kernel"], routes["plain"])
    # a random recurrent stack in bf16 amplifies the kernel's and the plain
    # version's f32 rounding differences layer by layer (rwkv6-7b: 0.59 after
    # 32 layers), so the recurrent paths compare their logits in f32 below;
    # so do the MoE paths where a route differs
    gate_f32 = arch in RECURRENT or flips > 0
    check(gate_f32 or full_err <= MODEL_TOL,
          f"{arch} full-width logits, kernel vs plain: relative error "
          f"{full_err}")
    checked = "bf16, not checked" if gate_f32 else f"tol {MODEL_TOL}"
    row.update(bf16_logits_rel_err=full_err,
               plain_prefill_ms=plain_prefill_ms)
    if arch in MOE:
        rows = sum(r.shape[0] for r in routes["kernel"])
        row.update(differing_routes=flips, routes=rows)
        print(f"[reference] {arch} full width in bf16, kernel vs plain "
              f"{kernel}: {flips} of {rows} (layer, token) routes differ")
    print(f"[reference] {arch} full width, kernel vs plain {kernel}: "
          f"logits relative error {full_err:.3g} ({checked}); prefill with "
          f"the plain version {plain_prefill_ms:.1f} ms vs "
          f"{row['prefill_ms']:.1f} ms")
    if "flash_attention" in want and kernel != "flash_attention":
        restore = swap_for_plain(arch, "flash_attention")
        try:
            flash_plain_logits, _ = forward_prefill(model, cfg, batch)
        finally:
            restore()
        flash_err = rel_err(torch, kernel_logits, flash_plain_logits)
        check(flash_err <= MODEL_TOL, f"{arch} full-width bf16 logits, flash "
              f"kernel vs plain: relative error {flash_err}")
        print(f"[reference] {arch} full width in bf16, kernel vs plain "
              f"flash_attention: logits relative error {flash_err:.3g} (tol "
              f"{MODEL_TOL})")
        del flash_plain_logits
    del kernel_logits, plain_logits
    if not gate_f32:
        row["gate"] = "bf16 logits"
        return
    model.to("meta")             # free the bf16 weights before the f32 ones
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    if arch in F32_DEPTH:
        cfg32 = dataclasses.replace(cfg32, n_layers=F32_DEPTH[arch])
    model32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    routes = {"kernel": [], "plain": []}
    with recorded_routes(routes["kernel"]):
        kernel_logits, _ = forward_prefill(model32, cfg32, batch)
    restore = swap_for_plain(arch)
    try:
        with recorded_routes(routes["plain"]):
            plain_logits, _ = forward_prefill(model32, cfg32, batch)
    finally:
        restore()
    f32_err = rel_err(torch, kernel_logits, plain_logits)
    check(bool(torch.isfinite(kernel_logits).all()) and f32_err <= MODEL_TOL,
          f"{arch} full-width f32 logits, kernel vs plain: relative error "
          f"{f32_err}")
    row.update(gate=f"f32 weights, {cfg32.n_layers} layers",
               f32_logits_rel_err=f32_err)
    if arch in MOE:
        row["f32_differing_routes"] = differing_routes(routes["kernel"],
                                                       routes["plain"])
        print(f"[reference] {arch} with f32 weights: "
              f"{row['f32_differing_routes']} (layer, token) routes differ")
    print(f"[reference] {arch} full width with f32 weights "
          f"({cfg32.n_layers} layers), kernel vs plain {kernel}: logits "
          f"relative error {f32_err:.3g} (tol {MODEL_TOL}); branch taken: "
          f"{row['gate']}")
    del model32, kernel_logits, plain_logits


def kv_quant_path(torch, np, dev):
    """gemma3-1b at full width with the int8 KV cache (``kv_quant=True``)
    beside the bf16 cache, on the same weights and prompts: the prefill's
    launches, 8 decode steps from each cache (teacher-forced with the bf16
    run's tokens, each step timed), the int8 run's logits within the
    reference's bound of the bf16 run's (tests/test_smoke_archs.py::
    test_kv_quant_decode_parity); then the smoke config's prefill and 8
    decode steps with the int8 cache, card vs CPU.  Returns the launches of
    the int8 run and a row of its numbers."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    from repro_torch.models import forward_decode, forward_prefill, init_params
    from repro_torch.models.io import make_batch

    arch = "gemma3-1b"
    cfg = path_config(arch)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    record = golden.timed_name(arch, kv_quant=True)
    model32, model, inp = timed_models(torch, dev, record, cfgq)
    batch = golden.batch_of(inp, dev)
    runs, toks, launches = {}, [], {}
    for name, c in (("bf16", cfg), ("int8", cfgq)):
        forward_prefill(model, c, batch)                   # warm-up
        torch.cuda.synchronize()
        cuda_lib.launches.clear()
        logits, cache = forward_prefill(model, c, batch)
        launches[name] = {k: n for k, n in cuda_lib.launches.items() if n}
        check(launches[name] == {k: n for k, n in PATHS[arch].items() if n},
              f"{arch} {name} cache prefill launched {launches[name]}")
        entry = cache["blocks"][0]
        if name == "int8":
            check(entry["k"].dtype == torch.int8 and
                  entry["ksc"].dtype == torch.float32,
                  f"int8 cache leaves {[(k, t.dtype) for k, t in entry.items()]}")
        cache_mb = sum(t.numel() * t.element_size()
                       for t in cache_leaves(cache)) / 1e6
        out, step_ms = [logits.float()], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)     # the decode steps' peak
        for i in range(8):
            if name == "bf16":
                toks.append(torch.argmax(out[-1][:, -1], dim=-1)[:, None]
                            .to(torch.int32))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = forward_decode(model, c, cache, toks[i], S + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float())
        runs[name] = {"logits": out, "decode_ms": float(np.median(step_ms)),
                      "cache_mb": cache_mb, "decode_peak_gb":
                      torch.cuda.max_memory_allocated(dev) / 1e9}
        del cache
    err = max((a - b).abs().max().item()
              for a, b in zip(runs["int8"]["logits"], runs["bf16"]["logits"]))
    check(err < KV_QUANT_BOUND and all(bool(torch.isfinite(t).all())
                                       for t in runs["int8"]["logits"]),
          f"{arch} int8 cache vs bf16 cache: logits max abs {err}")
    row = {"int8_vs_bf16_logits_max_abs": err,
           **{f"{n}_decode_ms": r["decode_ms"] for n, r in runs.items()},
           **{f"{n}_decode_peak_gb": r["decode_peak_gb"]
              for n, r in runs.items()},
           **{f"{n}_cache_mb": r["cache_mb"] for n, r in runs.items()}}
    print(f"[kv_quant] {arch} full width, 8 decode steps at batch {B} after a "
          f"{B}x{S} prefill: median {runs['int8']['decode_ms']:.2f} ms/step "
          f"with the int8 cache ({runs['int8']['cache_mb']:.1f} MB) vs "
          f"{runs['bf16']['decode_ms']:.2f} ms/step with the bf16 cache "
          f"({runs['bf16']['cache_mb']:.1f} MB); logits max abs diff {err:.3g} "
          f"(bound {KV_QUANT_BOUND})")
    del runs
    # the timed model against the int8 cache's records, then its f32 twin
    stored = golden.load(golden.TIMED_GOLDEN)
    row["golden"] = {"bfloat16": golden_cell(torch, dev, stored, record,
                                             "bfloat16", model)}
    model.to("meta")
    del model
    torch.cuda.empty_cache()
    row["golden"]["float32"] = golden_cell(torch, dev, stored, record,
                                           "float32", model32.to(dev))
    del model32

    small = dataclasses.replace(get_smoke_config(arch), kv_quant=True)
    cpu_model = init_params(small, torch.Generator().manual_seed(SEED),
                            device="cpu")
    small_batch = make_batch(small, torch.Generator().manual_seed(SEED), 2, 64)
    nxt = torch.randint(2, small.vocab_size, (8, 2, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(SEED))
    got = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        m = cpu_model.to(d)                     # the CPU run first, then moved
        logits, cache = forward_prefill(
            m, small, {k: v.to(d) for k, v in small_batch.items()})
        out = [logits]
        for i in range(8):
            logits, cache = forward_decode(m, small, cache, nxt[i].to(d), 64 + i)
            out.append(logits)
        got[where] = ([t.float().cpu() for t in out],
                      [t.cpu() for t in cache_leaves(cache)])
    small_err = max((a - b).abs().max().item()
                    for a, b in zip(got["card"][0], got["cpu"][0]))
    cache_err = max(rel_err(torch, a, b)
                    for a, b in zip(got["card"][1], got["cpu"][1]))
    check(small_err <= MODEL_TOL and cache_err <= MODEL_TOL,
          f"{arch} int8 cache smoke config card vs cpu: logits {small_err}, "
          f"cache {cache_err}")
    row.update(smoke_logits_max_abs_err=small_err, smoke_cache_rel_err=cache_err)
    print(f"[kv_quant] {arch} smoke config with the int8 cache, prefill and 8 "
          f"decode steps, card vs CPU: logits max abs err {small_err:.3g}, "
          f"cache relative error {cache_err:.3g} (tol {MODEL_TOL})")
    return launches["int8"], row


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


@contextlib.contextmanager
def routes_pinned(torch, want, stats):
    """Within the block each MoE routing takes the expert sets ``want``
    recorded call by call (``recorded_routes``), its gates its own
    probabilities there, normalised (tests/test_torch_moe.py's
    ``pinned_routes``).  ``stats`` counts the (call, token) routes where it
    would have picked other experts and the largest (p_k - p_w) / p_k over
    them (p_k its k-th largest probability, p_w its probability of the
    pinned set's weakest expert)."""
    from repro_torch.models import moe
    route, calls = moe._route, iter(want)

    def pinned(x, router, k):
        gate, idx, probs = route(x, router, k)
        w = next(calls)
        flip = (idx.sort(dim=1).values != w).any(dim=1)
        stats["routes"] += idx.shape[0]
        if bool(flip.any()):
            pd = probs.detach()
            pk = pd.gather(1, idx[:, -1:])[flip, 0]
            pw = pd.gather(1, w).min(dim=1).values[flip]
            stats["differing_routes"] += int(flip.sum())
            stats["near_tie_gap"] = max(stats["near_tie_gap"],
                                        float(((pk - pw) / pk).max()))
        g = torch.gather(probs, 1, w)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), w, probs
    moe._route = pinned
    try:
        yield stats
    finally:
        moe._route = route


def kernel_vs_plain_step(torch, tsteps, gnorm, state, cfg, batch, kernels, what):
    """The first step's loss and grad norm through the kernels and with each of
    ``kernels`` swapped for its plain version, checked to TRAIN_TOL.  With
    MoE layers the plain run takes the kernel run's routes, so that a
    router's near-tie moved by rounding does not pick other experts, and the
    routes it would have picked otherwise are counted."""
    routes = []
    stats = {"routes": 0, "differing_routes": 0, "near_tie_gap": 0.0}
    moe = cfg.moe is not None
    with recorded_routes(routes) if moe else contextlib.nullcontext():
        got = loss_and_grad_norm(torch, tsteps, gnorm, state, cfg, batch)
    restores = [plain_for_training(k) for k in kernels]
    try:
        with routes_pinned(torch, routes, stats) if moe \
                else contextlib.nullcontext():
            want = loss_and_grad_norm(torch, tsteps, gnorm, state, cfg, batch)
    finally:
        for restore in restores:
            restore()
    errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    check(all(math.isfinite(x) for x in got + want), f"{what} finite")
    check(errs[0] <= TRAIN_TOL["loss"] and errs[1] <= TRAIN_TOL["grad_norm"],
          f"{what}, kernel vs plain {kernels}: loss {got[0]} vs {want[0]}, grad "
          f"norm {got[1]} vs {want[1]}")
    pinned = (f"; the plain run on the kernel run's routes: "
              f"{stats['differing_routes']} of {stats['routes']} (call, token) "
              f"routes would differ, largest near-tie gap "
              f"{stats['near_tie_gap']:.3g}") if moe else ""
    print(f"[train] {what}, first step from the same state, kernels vs plain "
          f"{'/'.join(kernels)}: loss {got[0]:.6f} vs {want[0]:.6f} (rel "
          f"{errs[0]:.3g}, tol {TRAIN_TOL['loss']}), grad norm {got[1]:.6f} vs "
          f"{want[1]:.6f} (rel {errs[1]:.3g}, tol {TRAIN_TOL['grad_norm']})"
          f"{pinned}")
    out = {"loss": got[0], "plain_loss": want[0], "grad_norm": got[1],
           "plain_grad_norm": want[1], "loss_rel_err": errs[0],
           "grad_norm_rel_err": errs[1]}
    if moe:
        out.update(stats)
    return out


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
    from repro_torch.launch import golden
    from repro_torch.models import init_params
    from repro_torch.optim import global_norm, make_optimizer
    from repro_torch.roofline.bounds import flash_bound
    from repro_torch.train import steps as tsteps

    out = {"card": card}
    launches = {}

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # ---- 8a. h2o-danube-1.8b at full width ----------------------------------
    arch = "h2o-danube-1.8b"
    cfg = get_config(arch)
    stored = golden.load(golden.TRAIN_STEPS_GOLDEN)
    name = steps_record_name(arch)
    # its f32 record, on a model of its own, before the timed one
    out["golden"] = {f"{name} float32": golden_train_f32(torch, dev, stored,
                                                         name, card)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    opt, state = train_state_of_record(torch, dev, name, cfg, stored)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    # steps 1 .. S + 1 on the record's batches (SyntheticTokens' on the
    # reference's host: its zipf draws differ under another numpy), steps
    # 1 .. S held to it, the rest on this host's SyntheticTokens
    data = SyntheticTokens(cfg, TRAIN_B, TRAIN_S, seed=SEED)
    record = record_batches(torch, dev, name, cfg, stored)
    held_steps = len(record) - 1
    same = all(np.array_equal(b["tokens"].cpu().numpy(),
                              data.batch_for_step(s)["tokens"])
               for s, b in enumerate(record))
    batches = record + [on_dev(data.batch_for_step(i))
                        for i in range(len(record), TRAIN_STEPS + 1)]
    print(f"[train] {arch}: numpy {np.__version__}'s SyntheticTokens "
          f"{'draws' if same else 'does not draw'} the record's batches "
          f"(the reference's host's); steps 1-{len(record)} take the "
          f"record's, steps 1-{held_steps} are held to it (step "
          f"{held_steps + 1}'s loss as the loss after), steps "
          f"{held_steps + 2}-{TRAIN_STEPS} are not held")
    print(f"[train] {arch} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, window {cfg.window_size}, remat {cfg.remat}): "
          f"{n_params / 1e9:.4f} B params, AdamW with f32 master, batch "
          f"{TRAIN_B} x seq {TRAIN_S}, the weights and batches of its record "
          f"{name}; init {time.perf_counter() - t0:.1f} s; {card}")
    # 8b. the first step twice from the same state: kernel, then plain
    out["kernel_vs_plain"] = {arch: kernel_vs_plain_step(
        torch, tsteps, global_norm, state, cfg, batches[0], ["flash_attention"],
        f"{arch} full width")}
    step = tsteps.build_train_step(cfg, opt, tsteps_lr(), grad_accum=1)
    rows = []
    phase_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)      # the train steps' own peak
    cuda_lib.launches.clear()                    # the training path starts here
    for i in range(TRAIN_STEPS):
        before = dict(cuda_lib.launches)
        if i == 0:      # the record's steps: their base sampled before them
            held = HeldSteps(state)
        if i < held_steps:
            held.begin()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i < held_steps:  # outside the timed region: its grads, update
            held.after(state, metrics, cfg, i == held_steps - 1)
        elif i == held_steps:   # the loss of this batch after the held steps
            rec = held.record(loss)
            del held
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
    step_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    peak = max(phase_peak / 1e9, step_peak)
    prof = profile_step(torch, step, state, batches[TRAIN_STEPS], RANGES)
    out[arch] = {"params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
                 "steps": rows, "median_ms_steps_2_5": med,
                 "tokens_per_s": TRAIN_B * TRAIN_S / med * 1e3,
                 "peak_memory_gb": peak, "step_peak_gb": step_peak,
                 "profile": prof, "flash_launches_per_step": want_flash}
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
    out["golden"][f"{name} bfloat16"] = judge_train_record(
        torch, dev, stored, name, "bfloat16", cfg, rec,
        f"the timed model's steps 1-{held_steps}, the loss after on step "
        f"{held_steps + 1}", card)

    # ---- 8c. recurrentgemma-2b and rwkv6-7b, full width, one superblock -----
    recurrent_train_path(torch, dev, card, stored, out, launches)

    # ---- 8d. [train_moe]: the MoE, whisper and paligemma configs ----------
    out["train_moe"] = train_moe_path(torch, np, dev, card, launches)

    # ---- 8e. the smoke configs' train step, card against CPU (f32) ----------
    out["smoke_card_vs_cpu"] = {}
    for arch in ("h2o-danube-1.8b", "recurrentgemma-2b", "rwkv6-7b",
                 *TRAIN_MOE_DEPTH):
        cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
        batch = SyntheticTokens(cfg, 2, 64, seed=SEED).batch_for_step(0)
        res = {}
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
            opt = make_optimizer(cfg.optimizer, cfg=cfg)
            state = tsteps.init_train_state(None, cfg, opt,
                                            params=model.to(where))
            state, metrics = tsteps.build_train_step(cfg, opt, tsteps_lr())(
                state, {k: torch.from_numpy(v).to(where)
                        for k, v in batch.items()})
            res[str(where)] = (float(metrics["loss"]), {
                n: p.grad.cpu() for n, p in state["params"].named_parameters()},
                {n: p.detach().cpu() for n, p in
                 state["params"].named_parameters()})
        (cl, cg, cp), (gl, gg, gp) = res["cpu"], res[str(dev)]
        loss_err = abs(gl - cl) / abs(cl)
        grad_err = max(rel_err(torch, gg[n], cg[n]) for n in cg)
        if cfg.optimizer == "adamw":
            # AdamW's first step is about lr * sign(g): a grad near 0 may flip
            param_err = max(((gp[n] - cp[n]).abs() - 2 * LR_TRAIN *
                             (1 + 0.1 * cp[n].abs())).max().item() for n in cp)
        else:
            # Adafactor's step is continuous in the grads: each parameter's
            # step (new - old) to the grads' tolerance in relative norm
            old = {n: p.detach().float() for n, p in init_params(
                cfg, torch.Generator().manual_seed(SEED),
                "cpu").named_parameters()}
            param_err = max(
                float(torch.linalg.vector_norm(gp[n] - cp[n]) / max(
                    float(torch.linalg.vector_norm(cp[n] - old[n])), 1e-30))
                for n in cp) - SMOKE_TRAIN_TOL["grad"]
        check(loss_err <= SMOKE_TRAIN_TOL["loss"] and
              grad_err <= SMOKE_TRAIN_TOL["grad"] and param_err <= 0,
              f"{arch} smoke train step card vs CPU: loss {loss_err}, grads "
              f"{grad_err}, params {param_err}")
        out["smoke_card_vs_cpu"][arch] = {"loss_rel_err": loss_err,
                                          "grad_leaf_rel_err": grad_err,
                                          "param_excess": param_err}
        bound_text = "within 2 lr (1 + wd |p|)" if cfg.optimizer == "adamw" \
            else f"steps to {SMOKE_TRAIN_TOL['grad']} in relative norm"
        print(f"[train] {arch} smoke config in f32 ({cfg.optimizer}), one "
              f"train step card (kernels) vs CPU (plain): loss rel err "
              f"{loss_err:.3g} (tol {SMOKE_TRAIN_TOL['loss']}), worst grad "
              f"leaf rel err {grad_err:.3g} (tol {SMOKE_TRAIN_TOL['grad']}), "
              f"new params {bound_text} (worst excess {param_err:.3g})")
    return launches, out


def recurrent_train_path(torch, dev, card, stored, out, launches):
    """Phase 9c: recurrentgemma-2b and rwkv6-7b at full width and one
    superblock, each on its record's weights and batches: the f32 record
    first, then the kernels against their plain versions, the record's
    step 1 (a warm-up), one timed step on batch 1 (the record's step 2, its
    launches counted from 0) and the record's step 3 (untimed), the three
    held to the bf16 record, and a profiled step.  Adds to ``out`` and
    ``launches``."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    from repro_torch.optim import global_norm
    from repro_torch.train import steps as tsteps

    for arch, kernels in (("recurrentgemma-2b", ["rglru_scan", "flash_attention"]),
                          ("rwkv6-7b", ["wkv6"])):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=full.pattern_len)
        name = steps_record_name(arch)
        out["golden"][f"{name} float32"] = golden_train_f32(torch, dev,
                                                            stored, name, card)
        torch.cuda.reset_peak_memory_stats(dev)
        opt, state = train_state_of_record(torch, dev, name, cfg, stored)
        check(golden.cell(name).synthetic and (golden.cell(name).batch,
                                               golden.cell(name).seq) ==
              (REC_TRAIN_B, REC_TRAIN_S), f"{name}: not the timed batches")
        batches = record_batches(torch, dev, name, cfg, stored)
        out["kernel_vs_plain"][arch] = kernel_vs_plain_step(
            torch, tsteps, global_norm, state, cfg, batches[0], kernels,
            f"{arch} full width, {cfg.n_layers} layers")
        step = tsteps.build_train_step(cfg, opt, tsteps_lr())
        held = HeldSteps(state)
        held.begin()
        metrics = step(state, batches[0])[1]    # warm-up: the record's step 1
        held.after(state, metrics, cfg, False)
        torch.cuda.synchronize()
        phase_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)  # the train step's own peak
        cuda_lib.launches.clear()              # this path's train step starts
        held.begin()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[1])    # the record's step 2
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        step_peak = torch.cuda.max_memory_allocated(dev)
        launches["train:" + arch] = {n: c for n, c in cuda_lib.launches.items()
                                     if c}
        held.after(state, metrics, cfg, len(batches) == 3)
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
        rec = held_after_timed(state, cfg, step, batches, held)
        n_params = sum(p.numel() for p in state["params"].parameters())
        out[arch] = {"params": n_params, "layers": cfg.n_layers,
                     "batch": REC_TRAIN_B, "seq": REC_TRAIN_S, "ms": ms,
                     "loss": loss, "grad_norm": gn,
                     "peak_memory_gb": max(phase_peak, step_peak) / 1e9,
                     "step_peak_gb": step_peak / 1e9,
                     "profile": profile_step(torch, step, state, batches[1],
                                             RANGES)}
        print(f"[train] {arch} full width, {cfg.n_layers} layers "
              f"({n_params / 1e9:.4f} B params), batch {REC_TRAIN_B} x seq "
              f"{REC_TRAIN_S}: one step {ms:.1f} ms, loss {loss:.6f}, grad norm "
              f"{gn:.6f}, launches {launches['train:' + arch]}, peak memory "
              f"{out[arch]['peak_memory_gb']:.2f} GB; every parameter has a "
              f"finite grad; {card}")
        print_profile(arch, out[arch]["profile"], card)
        del state, batches
        torch.cuda.empty_cache()
        out["golden"][f"{name} bfloat16"] = judge_train_record(
            torch, dev, stored, name, "bfloat16", cfg, rec,
            HELD_AFTER_WARM_UP, card)


# the held steps of a train path whose timed step is step 2
HELD_AFTER_WARM_UP = ("the timed model's warm-up step 1, timed step 2 and "
                      "untimed step 3, the loss after them of a forward pass")


def held_after_timed(state, cfg, step, batches, held):
    """The held steps of a train path after its timed step 2: steps 3 ..
    S on the record's batches, untimed, then the loss of batch S after
    them (a forward pass): ``HeldSteps.record``."""
    from repro_torch.launch import golden
    for i in range(2, len(batches) - 1):
        held.begin()
        metrics = step(state, batches[i])[1]
        held.after(state, metrics, cfg, i == len(batches) - 2)
    return held.record(golden.forward_loss(state["params"], cfg,
                                           batches[-1]))


def train_moe_path(torch, np, dev, card, launches):
    """[train_moe]: one train step at full width of qwen3-moe-235b-a22b and
    arctic-480b (Adafactor over the stacked leaves, the MoE aux in the loss;
    cut to the depth one card holds), whisper-small and paligemma-3b (AdamW,
    full depth), 4 x 1024 positions (the MoEs: models.io.make_batch; the
    others: their record's weights and batches): the first step through
    the kernels against the plain versions, a warm-up step, the timed step
    (its launches counted from 0) and a profiled step; whisper-small's and
    paligemma-3b's warm-up and timed steps and an untimed third are held
    to their bf16 record, the MoEs' records (their experts cut) on models of
    their own.  Returns the rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    from repro_torch.models.io import make_batch
    from repro_torch.optim import global_norm, make_optimizer
    from repro_torch.train import steps as tsteps

    rows = {}
    stored = golden.load(golden.TRAIN_STEPS_GOLDEN)
    for arch, depth in TRAIN_MOE_DEPTH.items():
        cfg = get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        name = steps_record_name(arch)
        moe = cfg.moe is not None
        check((golden.cell(name).batch, golden.cell(name).seq) ==
              (TRAIN_MOE_B, TRAIN_MOE_S), f"{name}: not the timed shape")
        records = {}
        # earlier phases' models may sit in reference cycles (autograd,
        # checkpointing) until the cyclic collector runs
        gc.collect()
        torch.cuda.empty_cache()
        if not moe:     # its f32 record, on a model of its own, first
            records["float32"] = golden_train_f32(torch, dev, stored, name,
                                                  card)
        held = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if moe:
            # all 128 experts and a CUDA generator's draws; the record's
            # expert cut is built apart below
            opt = make_optimizer(cfg.optimizer, cfg=cfg)
            state = tsteps.init_train_state(
                torch.Generator(device=dev).manual_seed(SEED), cfg, opt,
                device=dev)
            batch = make_batch(cfg, torch.Generator(device=dev).manual_seed(
                SEED), TRAIN_MOE_B, TRAIN_MOE_S)
            batches = [batch, batch]
        else:
            opt, state = train_state_of_record(torch, dev, name, cfg, stored)
            batches = record_batches(torch, dev, name, cfg, stored)
            batch = batches[0]
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in state["params"].parameters())
        print(f"[train_moe] {arch} full width, {cfg.n_layers} layers "
              f"({n_params / 1e9:.4f} B params, {cfg.optimizer}, remat "
              f"{cfg.remat}), batch {TRAIN_MOE_B} x {TRAIN_MOE_S} positions "
              f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())}"
              f"); {held:.2f} GB held before its init; init "
              f"{time.perf_counter() - t0:.1f} s; {card}")
        kernels = ["flash_attention"]
        row = {"layers": cfg.n_layers, "params": n_params,
               "optimizer": cfg.optimizer, "held_before_init_gb": held,
               "kernel_vs_plain": kernel_vs_plain_step(
                   torch, tsteps, global_norm, state, cfg, batch, kernels,
                   f"{arch} full width, {cfg.n_layers} layers")}
        peaks = {"init and kernel vs plain": torch.cuda.max_memory_allocated(
            dev) / 1e9}
        step = tsteps.build_train_step(cfg, opt, tsteps_lr())
        torch.cuda.reset_peak_memory_stats(dev)
        sampled = None if moe else HeldSteps(state)
        cuda_lib.launches.clear()
        if sampled:
            sampled.begin()
        metrics = step(state, batch)[1]     # warm-up: the record's step 1
        if sampled:
            sampled.after(state, metrics, cfg, False)
        torch.cuda.synchronize()
        peaks["warm-up step"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.launches.clear()              # this path's train step starts
        if sampled:
            sampled.begin()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[1])    # the record's step 2
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        aux = float(metrics["aux"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # the train step's peak, from just before it to its end
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if sampled:
            sampled.after(state, metrics, cfg, len(batches) == 3)
        launches["train:" + arch] = {n: c for n, c in cuda_lib.launches.items()
                                     if c}
        # causal self-attention runs flash: not paligemma's prefix-LM mask,
        # nor whisper's encoder or cross-attention (as in the reference)
        want = 0 if cfg.n_prefix_tokens else train_launches(cfg,
                                                            "flash_attention")
        got = launches["train:" + arch].get("flash_attention", 0)
        check(got == want and launches["train:" + arch].get(
            "flash_attention:wgmma", 0) == want,
            f"{arch} train step launched {launches['train:' + arch]}, want "
            f"flash {want} (tensor-core kernel)")
        missing = [n for n, p in state["params"].named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        check(math.isfinite(loss) and math.isfinite(gn) and
              math.isfinite(aux) and not missing,
              f"{arch} train step: loss {loss}, aux {aux}, grad norm {gn}, no "
              f"finite grad for {missing}")
        check((aux > 0) == (cfg.moe is not None), f"{arch} aux {aux}")
        check(peak <= PEAK_GB_LIMIT, f"{arch} train step peak {peak:.2f} GB "
              f"(other peaks {peaks})")
        if sampled:     # the record's step 3, untimed, and the loss after it
            rec = held_after_timed(state, cfg, step, batches, sampled)
        prof = profile_step(torch, step, state, batches[1], RANGES)
        row.update(ms=ms, positions_per_s=TRAIN_MOE_B * TRAIN_MOE_S / ms * 1e3,
                   loss=loss, aux=aux, grad_norm=gn, peak_memory_gb=peak,
                   other_peaks_gb=peaks, flash_launches_per_step=got,
                   profile=prof)
        rows[arch] = row
        print(f"[train_moe] {arch}: step {ms:.1f} ms "
              f"({row['positions_per_s']:.0f} positions/s), loss {loss:.6f}, "
              f"aux {aux:.6f}, grad norm {gn:.6f}, flash launches per step "
              f"{got}, the step's peak memory {peak:.2f} GB "
              f"(max_memory_allocated, limit {PEAK_GB_LIMIT}; "
              f"{', '.join(f'{k} {v:.2f} GB' for k, v in peaks.items())}), "
              f"device idle {prof['idle_share']:.2%} over "
              f"the profiled step; every parameter has a finite grad; {card}")
        print_profile(arch, prof, card)
        del state, batch, batches, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        if moe:         # the record's expert cut, on a model of its own
            records["float32"] = golden_train_f32(torch, dev, stored, name,
                                                  card)
        else:
            records["bfloat16"] = judge_train_record(
                torch, dev, stored, name, "bfloat16", cfg, rec,
                HELD_AFTER_WARM_UP, card)
        row["golden"] = records
    return rows


def train_golden_launches(cfg, dtype: str) -> dict:
    """The kernels one train step of a golden train cell launches: each
    kernel of ``golden_launches`` ``train_launches`` times (the forward and
    the remat recompute)."""
    return {name: train_launches(cfg, name.split(":")[0]) for name in
            golden_launches(cfg, dtype)}


def train_record_name(arch: str) -> str:
    """The ``golden.TRAIN`` cell of a timed train path: at its timed shape
    and depth (the MoEs: their experts cut, built apart from the timed
    model)."""
    from repro_torch.launch import golden
    names = [n for n, c in golden.TRAIN.items()
             if c.arch == arch and n != golden.REGENERATED_TRAIN]
    check(len(names) == 1, f"{arch}: train records {names}")
    return names[0]


def steps_record_name(arch: str) -> str:
    """The ``golden.TRAIN_STEPS`` cell of a timed train path: its
    ``TRAIN`` cell's steps past the first."""
    from repro_torch.launch import golden
    return golden.steps_name(train_record_name(arch))


def train_state_of_record(torch, dev, name, cfg, stored):
    """(AdamW, its state) of a timed train path on the bf16 weights of its
    record (``golden.train_model``: the f32 ``BlockDraws`` draw on the card,
    cast), checked against the record's checksums.  ``cfg``: the path's
    config, which must be the record's."""
    from repro_torch.launch import golden
    from repro_torch.optim import adamw
    from repro_torch.train import steps as tsteps
    check(golden.cell_config(name, cfg.param_dtype) == cfg and
          LR_TRAIN == golden.LR,
          f"{name}: the timed config or rate is not the record's")
    model = golden.train_model(name, cfg.param_dtype, dev)
    golden.check_weights(model, name, cfg.param_dtype,
                         record_weights(stored, name, cfg.param_dtype))
    opt = adamw()
    return opt, tsteps.init_train_state(None, cfg, opt, params=model)


def record_weights(stored, name, dtype) -> dict:
    """{"names", "sums"} of a train path's weights in ``dtype``: its steps
    record's, else (a dtype the steps file holds no record in:
    paligemma-3b's bf16) its one-step record's in ``train.npz``, which
    ``judge_train_record`` then holds its step 1 to."""
    from repro_torch.launch import golden
    if f"{name}/{dtype}/names" not in stored:
        name, stored = golden.train_name(name), golden.load(
            golden.TRAIN_GOLDEN)
    return {"names": [str(n) for n in stored[f"{name}/{dtype}/names"]],
            "sums": stored[f"{name}/{dtype}/checksums"]}


def record_batches(torch, dev, name, cfg, stored) -> list:
    """The batches of a train record (0 .. S-1: its steps; S: the forward
    after the last) on ``dev``, checked against the file."""
    from repro_torch.launch import golden
    batches = [golden.train_batch(name, cfg, s, stored)
               for s in range(int(stored[f"{name}/steps"]) + 1)]
    golden.check_train_inputs(stored, name, batches)
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in batches]


class HeldSteps:
    """The held steps of a timed train path, sampled outside its timers:
    ``begin()`` just before each held step, ``after(state, metrics, cfg,
    last)`` right after it (its
    grads and update, the launches since the last call; after the last,
    the optimizer's state), ``record(loss_after)`` (the next step's loss,
    or a forward pass's) -> (the record, each step's launches)."""

    def __init__(self, state):
        from repro_torch.kernels import cuda_lib
        from repro_torch.launch import golden
        self.sampler = golden.TrainSampler(state)
        self.steps, self.launches, self.opt_state = [], [], None
        self.counts = cuda_lib.launches
        self.mark = {}

    def begin(self):
        """Just before a held step: its launches count from here."""
        self.mark = dict(self.counts)

    def after(self, state, metrics, cfg, last: bool):
        self.launches.append({n: c - self.mark.get(n, 0)
                              for n, c in self.counts.items()
                              if c - self.mark.get(n, 0)})
        self.steps.append(self.sampler.after(state, metrics))
        if last:
            self.opt_state = self.sampler.state(state, cfg)

    def record(self, loss_after: float) -> tuple:
        from repro_torch.launch import golden
        rec = {"names": self.steps[0]["names"],
               "numels": self.steps[0]["numels"], "steps": self.steps,
               **self.opt_state}
        return golden.with_losses_after(rec, loss_after), self.launches


def golden_train_line(name, dtype, cfg, k, e, drift, tol, launches, what,
                      card) -> str:
    """The ``[golden]`` line of step ``k`` (from 1) of a train record:
    ``e``, its errors (``compare_train``'s or ``compare_later_step``'s)."""
    from repro_torch.launch import golden
    c = golden.cell(name)
    u = e["update"]
    line = (f"[golden] {name} {dtype} step {k} ({what}; {cfg.n_layers} layers"
            f"{', ' + str(cfg.moe.n_experts) + ' experts' if cfg.moe else ''}"
            f", {c.batch} x {c.seq} positions, {cfg.optimizer}): "
            f"checksums equal; " +
            ", ".join(f"{m} {v:.3g}" for m, v in e["scalars"].items()) +
            f"; grads {e['grad']['worst']:.3g} nearest its limit "
            f"{e['grad']['worst_limit']:.3g} ({e['grad']['worst_leaf']}; "
            f"{e['grad']['limits_widened']} limits widened to "
            f"{golden.SPREAD}x the reference's own error from f32; "
            f"largest "
            f"{e['grad']['largest_error']:.3g}) over {e['leaves']} leaves, "
            f"{e['indices']} indices; update {u['worst']:.3g} at worst "
            f"({u['worst_leaf']}")
    line += (f"; limit {u['worst_limit']:.3g}, {u['limits_widened']} "
             f"widened, largest {u['largest_error']:.3g})"
             if "worst_limit" in u else ")")
    if "clear" in u:
        line += (f", {u['indices_cleared']} indices past {u['clear']:.3g}"
                 f" RMS grads (a grad's sign differs up to "
                 f"{u['sign_flip_in_rms']:.3g} RMS), {u['indices_bounded']} "
                 f"held to 2 lr (1 + wd |p|) (used {u['bound_used']:.3g} of "
                 f"it)")
    elif "indices_cleared" in u:
        line += (f", {u['indices_cleared']} indices past sqrt(v_hat) "
                 f"{golden.CLEAR_EPS} eps, {u['indices_bounded']} held to "
                 f"2 lr (1 + wd |p|) (used {u['bound_used']:.3g} of it)")
    if drift:
        line += (f"; grads from the f32 record: port "
                 f"{drift['port_vs_f32']:.3g}, reference "
                 f"{drift['reference_vs_f32']:.3g} (ratio "
                 f"{drift['ratio']:.3g}, within {golden.DRIFT_RATIO}x of "
                 f"1)")
    return line + f" (tol {tol}); launches {launches}; {card}"


def golden_steps_lines(name, dtype, cfg, r, launches, what, card):
    """Print a train record's ``[golden]`` lines: one a step (``launches``:
    each step's), then the optimizer's state after the last."""
    from repro_torch.launch import golden
    e = r["errors"]
    for k, s in enumerate(e["steps"]):
        drift = r["drift"][k] if "drift" in r else None
        line = golden_train_line(
            name, dtype, cfg, k + 1, s, drift,
            golden.step_limits(r["later_tol"], k) if k else r["tol"],
            launches[k], what, card)
        print(line + (f"; not held: {r['unheld']}" if k and "unheld" in r
                      else ""), flush=True)
    st = e["state"]
    print(f"[golden] {name} {dtype} the optimizer's state after step "
          f"{len(e['steps'])} ({what}): {st['worst']:.3g} nearest its limit "
          f"{st['worst_limit']:.3g} ({st['worst_leaf']}; largest "
          f"{st['largest_error']:.3g}), count {st['count']} (the file's "
          f"{st['want_count']})"
          f"{'; not held: ' + r['unheld'] if 'unheld' in r else ''}; {card}",
          flush=True)


def judge_train_record(torch, dev, stored, name, dtype, cfg, held, what,
                       card) -> dict:
    """A timed path's held steps (``HeldSteps.finish``'s record) against the
    file: one ``[golden]`` line a step; each step's launches held to
    ``train_golden_launches``; a miss runs ``golden_train_diagnosis``, then
    fails the run."""
    from repro_torch.launch import golden
    rec, launches = held
    want = train_golden_launches(cfg, dtype)
    check(all(n == want for n in launches),
          f"[golden] {name} {dtype} steps launched {launches}, want {want} "
          f"each")
    if f"{name}/{dtype}/names" not in stored:
        # no record of the steps in this dtype: step 1 against train.npz's
        name = golden.train_name(name)
        r = golden.judge_train(name, dtype, rec["steps"][0],
                               golden.load(golden.TRAIN_GOLDEN))
        print(golden_train_line(name, dtype, cfg, 1, r["errors"],
                                r.get("drift"), r["tol"], launches[0], what,
                                card), flush=True)
        check(r["errors"]["ok"], f"[golden] {name} {dtype} against the "
                                 f"reference's step: {r['errors']}")
        return {**r, "launches": launches}
    r = golden.judge_train_steps(name, dtype, rec, stored)
    golden_steps_lines(name, dtype, cfg, r, launches, what, card)
    if not r["errors"]["ok"]:
        golden_train_diagnosis(torch, dev, stored, name, dtype, want)
    check(r["errors"]["ok"], f"[golden] {name} {dtype} against the "
                             f"reference's steps: {r['errors']}")
    return {**r, "launches": launches}


def golden_train_f32(torch, dev, stored, name, card) -> dict:
    """The f32 record of a train cell on a model of its own, built and freed
    here, tf32 off: ``golden.run_train_steps_cell``, its launches counted
    from 0 (``train_golden_launches`` a step and the forward after the
    last, ``golden_launches``); held as ``judge_train_record`` holds it."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import golden
    cfg = golden.cell_config(name, "float32")
    n_steps = int(stored[f"{name}/steps"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with tf32_off(torch):
        cuda_lib.launches.clear()
        r = golden.run_train_steps_cell(name, "float32", dev, stored)
        got = {k: n for k, n in cuda_lib.launches.items() if n}
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    step = train_golden_launches(cfg, "float32")
    forward = golden_launches(cfg, "float32")
    want = {k: n_steps * step[k] + forward[k] for k in step}
    check(got == want, f"[golden] {name} float32 {n_steps} steps and the "
                       f"forward after them launched {got}, want {want}")
    golden_steps_lines(name, "float32", cfg, r, [step] * n_steps,
                       f"its own model, peak {peak:.2f} GB, weights "
                       f"{r['weights_s']:.1f} s, {n_steps} steps "
                       f"{r['run_s']:.1f} s", card)
    if not r["errors"]["ok"]:
        golden_train_diagnosis(torch, dev, stored, name, "float32", want)
    check(r["errors"]["ok"], f"[golden] {name} float32 against the "
                             f"reference's steps: {r['errors']}")
    return {**r, "launches": got, "peak_gb": peak}


def golden_train_diagnosis(torch, dev, stored, name, dtype, want):
    """A train record out of its limits, run again on a fresh model with
    each of its kernels swapped for its plain version (``plain_for_
    training``), tf32 off; each run's errors printed."""
    from repro_torch.launch import golden
    for kernel in ("flash_attention", "rglru_scan", "wkv6"):
        if kernel not in want:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        restore = plain_for_training(kernel)
        try:
            with tf32_off(torch):
                r = golden.run_train_steps_cell(name, dtype, dev, stored)
        finally:
            restore()
        print(f"[golden] {name} {dtype} with {kernel} swapped for its plain "
              f"version: {json.dumps(r['errors'])}", flush=True)


# ---------------------------------------------------------------------------
# phase 10: the distribution layer
# ---------------------------------------------------------------------------
def init_group(dev, world: int, rank: int, store: str):
    """A process group from a FileStore (no network): NCCL on the card,
    gloo on the CPU."""
    import torch.distributed as dist
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def moe_parity(torch, mesh, cfg, p, x, decode):
    """``moe_sharded`` on this rank's blocks of the full ``p`` and ``x``
    (gathered back to full) against ``moe_dense`` on the full tensors.
    Returns ({y_rel_err, aux_abs_err, differing_routes, routes, tokens}, a
    function that runs the sharded call again, for timing)."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import context
    from repro_torch.distributed.layouts import choose_layout
    from repro_torch.models import moe
    rules = choose_layout(cfg, LM_SHAPES["train_4k"], mesh)
    wg = rules.spec(("experts", None, "moe_ff"))
    wd = rules.spec(("experts", "moe_ff", None))
    local = moe.MoE({"router": p.router,
                     "w_gate": context.local_shard(p.w_gate, wg, mesh),
                     "w_up": context.local_shard(p.w_up, wg, mesh),
                     "w_down": context.local_shard(p.w_down, wd, mesh)})
    sp = not decode and rules.rules["act_seq"] == rules.moe_axis and \
        cfg.n_heads % context.axis_sizes(mesh)[rules.moe_axis] == 0
    spec = rules.spec(("batch", "act_seq" if sp else "seq", None))
    xl = context.local_shard(x, spec, mesh)

    def sharded():
        with context.use_rules(rules):
            return moe.moe_layer(local, xl, cfg, decode=decode)
    routes = {"sharded": [], "dense": []}
    with recorded_routes(routes["sharded"]):
        y, aux = sharded()
    for d, axes in enumerate(spec):
        if axes:
            y = coll.all_gather(y, axes, d, mesh)
    with recorded_routes(routes["dense"]):
        yd, auxd = moe.moe_dense(p, x, cfg)
    return {"y_rel_err": rel_err(torch, y, yd),
            "aux_abs_err": abs(float(aux) - float(auxd)),
            "differing_routes": differing_routes(routes["sharded"],
                                                 routes["dense"]),
            "routes": sum(r.shape[0] for r in routes["dense"]),
            "tokens": x.shape[0] * x.shape[1]}, sharded


def multi_card_rank(rank: int, n: int, store: str, device_type: str,
                    arch: str, smoke: bool):
    """One rank of the multi-card MoE parity: a (1, n) mesh, experts over
    ``model``; f32, against moe_dense, to DIST_F32_TOL (rank 0 prints)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import init_moe
    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    init_group(dev, n, rank, store)
    import torch.distributed as dist
    try:
        cfg = (get_smoke_config if smoke else get_config)(arch)
        cfg = dataclasses.replace(cfg, param_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p = init_moe(cfg, gen, dev)
        x = torch.randn((B, 64 if smoke else S, cfg.d_model), generator=gen,
                        device=dev)
        mesh = make_mesh((1, n), ("data", "model"), device=dev.type)
        for decode in (False, True):
            row, _ = moe_parity(torch, mesh, cfg, p,
                                x[:, :1] if decode else x, decode)
            what = "decode" if decode else "prefill"
            check(row["y_rel_err"] <= DIST_F32_TOL and
                  row["aux_abs_err"] <= DIST_F32_TOL,
                  f"{n} ranks, {arch} moe_sharded vs moe_dense ({what}): "
                  f"{row}")
            if rank == 0:
                print(f"[distributed] {n} {dev.type} ranks, (1, {n}) mesh, "
                      f"{arch} one MoE layer in f32, {what}: moe_sharded vs "
                      f"moe_dense relative error {row['y_rel_err']:.3g}, aux "
                      f"diff {row['aux_abs_err']:.3g} (tol {DIST_F32_TOL}), "
                      f"{row['differing_routes']} of {row['routes']} routes "
                      f"differ", flush=True)
        sharded_prefill_parity(torch, dev, mesh, smoke, rank, n)
    finally:
        dist.destroy_process_group()


def sharded_prefill_parity(torch, dev, mesh, smoke: bool, rank: int, n: int):
    """gemma3-1b's prefill in f32 as a DTensor model on the (1, n) mesh
    (heads, ff and vocab over ``model``) against the plain model on the
    same weights, to DIST_F32_TOL (rank 0 prints)."""
    from repro_torch.configs.base import (ShapeConfig, get_config,
                                          get_smoke_config)
    from repro_torch.distributed import context, layouts
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.io import make_batch
    arch = "gemma3-1b"
    cfg = dataclasses.replace((get_smoke_config if smoke else get_config)(
        arch), param_dtype="float32")
    seq = 64 if smoke else S
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    batch = make_batch(cfg, torch.Generator(device=dev).manual_seed(SEED), B,
                       seq)
    want, _ = forward_prefill(model, cfg, batch)
    rules = layouts.choose_layout(cfg, ShapeConfig("prefill", "prefill", seq,
                                                   B), mesh)
    layouts.shard_params(model, cfg, rules, mesh)
    with context.use_rules(rules):
        got, _ = forward_prefill(model, cfg, layouts.distribute_tree(
            batch, layouts.batch_pspecs(batch, rules), mesh))
    err = rel_err(torch, got.full_tensor(), want)
    check(err <= DIST_F32_TOL, f"{n} ranks, {arch} sharded prefill vs plain: "
          f"relative error {err}")
    if rank == 0:
        print(f"[sharded] {n} {dev.type} ranks, (1, {n}) mesh, {arch} "
              f"prefill in f32, DTensor model vs plain: relative error "
              f"{err:.3g} (tol {DIST_F32_TOL})", flush=True)


def spawn_multi_card(torch, n: int, arch: str, smoke: bool, device_type: str,
                     limit_s: float = 300.0):
    """Runs ``multi_card_rank`` on n processes (one a card) under a time
    limit; a rank's failure or the limit fails the phase."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(multi_card_rank, args=(
            n, str(Path(d) / "store"), device_type, arch, smoke), nprocs=n,
            join=False, start_method="spawn")
        deadline = time.monotonic() + limit_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                check(time.monotonic() < deadline,
                      f"multi-card parity did not finish in {limit_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()


def distributed_path(torch, np, dev, card):
    """Phase 10: the port's distribution layer on the card.  One NCCL rank
    (world size 1, a FileStore in a temp dir, a 1 x 1 mesh from
    launch.mesh.make_mesh): moe_sharded on one qwen3-moe-235b-a22b layer at
    full width against moe_dense (f32 to DIST_F32_TOL, bf16 by the routes
    that differ), prefill (4 x 1024 tokens) and decode (4 tokens), both
    dispatches timed with CUDA events; compressed_psum against its formula
    on a grad tree; pipeline_apply with one stage against the sequential
    stack.  With two or more cards, one NCCL rank a card runs the sharded
    MoE parity too.  Returns the phase's numbers."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    arch = "qwen3-moe-235b-a22b"
    out = {"card": card, "arch": arch}
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    init_group(dev, 1, 0, str(Path(tmp.name) / "store"))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev.type)
        print(f"[distributed] {dist.get_backend()} group of "
              f"{dist.get_world_size()} rank from a FileStore, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}; {card}")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch), param_dtype=dtype)
            p = moe.init_moe(cfg, gen, dev)
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device=dev).to(getattr(torch, dtype))
            for decode in (False, True):
                xi = x[:, :1] if decode else x
                what = "decode" if decode else "prefill"
                row, sharded = moe_parity(torch, mesh, cfg, p, xi, decode)
                if dtype == "float32":
                    check(row["y_rel_err"] <= DIST_F32_TOL and
                          row["aux_abs_err"] <= DIST_F32_TOL,
                          f"{arch} f32 {what}: moe_sharded vs moe_dense {row}")
                    timing = ""
                else:
                    row.update(
                        sharded_ms=time_ms(torch, sharded, iters=10),
                        dense_ms=time_ms(torch, lambda: moe.moe_dense(
                            p, xi, cfg), iters=10))
                    timing = (f"; sharded {row['sharded_ms']:.3f} ms vs dense "
                              f"{row['dense_ms']:.3f} ms (CUDA events, 10 "
                              f"calls)")
                    if not decode:
                        row["collectives"] = sharded_collectives(
                            torch, sharded, row, card)
                out[f"{dtype} {what}"] = row
                tol = f" (tol {DIST_F32_TOL})" if dtype == "float32" else ""
                print(f"[distributed] {arch} one MoE layer at full width, "
                      f"{dtype}, {what} ({row['tokens']} tokens): moe_sharded "
                      f"vs moe_dense relative error {row['y_rel_err']:.3g}"
                      f"{tol}, aux diff {row['aux_abs_err']:.3g}, "
                      f"{row['differing_routes']} of {row['routes']} routes "
                      f"differ{timing}; {card}")
            del p, x
            torch.cuda.empty_cache()

        # compressed_psum on a grad tree: one qwen3-moe attention layer's
        cfg = get_config(arch)
        hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        tree = {n: torch.randn(shape, generator=gen, device=dev)
                for n, shape in (("wq", (cfg.d_model, hq)),
                                 ("wk", (cfg.d_model, hk)),
                                 ("wv", (cfg.d_model, hk)),
                                 ("wo", (hq, cfg.d_model)),
                                 ("ln1", (cfg.d_model,)))}
        group = mesh.get_group("data")
        for n, g in tree.items():
            res = torch.randn(g.shape, generator=gen, device=dev) * 1e-3
            mean, new_res = compressed_psum(g, group, res)
            q, scale = quantize_int8(g + res)
            deq = dequantize_int8(q, scale)
            # one rank: the int32 sum is q, the summed scale is the scale
            # and the rank count is 1
            check(torch.equal(mean, deq) and
                  torch.equal(new_res, g + res - deq),
                  f"compressed_psum on {n}")
        out["compressed_psum"] = {"leaves": {n: list(t.shape)
                                             for n, t in tree.items()},
                                  "exact": True}
        shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in tree.items())
        print(f"[distributed] compressed_psum over the data axis (1 rank) on "
              f"a grad tree ({shapes}): mean equals q * scale and the "
              f"residual g + r - q * scale, exactly")
        del tree

        # pipeline_apply with one stage against the sequential stack
        pmesh = make_mesh((1,), ("pp",), device=dev.type)
        w = torch.randn((8, 256, 256), generator=gen, device=dev) * 0.06
        xp = torch.randn((8, 256), generator=gen, device=dev)

        def stage_fn(ws, h):
            for wi in ws:
                h = torch.tanh(h @ wi)
            return h
        got = pipeline_apply(w, xp, stage_fn, pmesh, "pp", microbatches=4)
        err = (got - stage_fn(w, xp)).abs().max().item()
        check(err <= 2e-5, f"pipeline_apply one stage: {err}")
        out["pipeline_one_stage_max_abs_err"] = err
        print(f"[distributed] pipeline_apply, one stage of 8 layers, 4 "
              f"microbatches: max abs err {err:.3g} against the sequential "
              f"stack (tol 2e-5)")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()

    n = torch.cuda.device_count()
    if n >= 2:
        spawn_multi_card(torch, n, arch, False, "cuda")
        out["multi_card"] = f"{n} NCCL ranks, one a card: parity checked"
    else:
        out["multi_card"] = (f"not run: {n} card on this machine, and NCCL "
                             f"takes one rank a card")
        print(f"[distributed] multi-card NCCL parity not run: this machine "
              f"has {n} card (NCCL takes one rank a card; the multi-rank "
              f"parity runs on gloo in tests/test_torch_distributed.py)")
    return out


def sharded_collectives(torch, sharded, row, card) -> dict:
    """``collective_stats`` of one traced ``moe_sharded`` call, and the
    least time its gathers' copies take: on one rank a gather is a view of
    its operand (C2), so nothing is copied and the bound is 0; on more
    ranks each gathered byte is written once and read once at the HBM
    rate."""
    import torch.distributed as dist
    from repro_torch.roofline.bounds import PEAK_BYTES
    from repro_torch.roofline.trace import OpTrace, collective_stats
    with OpTrace() as trace:
        sharded()
    torch.cuda.synchronize()
    stats = collective_stats(trace)
    gathered = stats["all-gather"]["operand_bytes"]
    copy_ms = 2 * gathered / PEAK_BYTES * 1e3
    gap = row["sharded_ms"] - row["dense_ms"]
    if dist.get_world_size() == 1:
        check(gathered == 0 and copy_ms == 0,
              f"one rank: moe_sharded issued gathers of {gathered} bytes")
        print(f"[distributed] collective_stats of one traced moe_sharded "
              f"prefill call: {json.dumps(stats)}; on one rank its gathers "
              f"copy nothing (views of their operands, C2): "
              f"gather_copy_bound_ms {copy_ms}; the sharded - dense gap "
              f"{gap:.3f} ms; {card}")
    else:
        print(f"[distributed] collective_stats of one traced moe_sharded "
              f"prefill call: {json.dumps(stats)}; the gathers' "
              f"{gathered / 1e9:.3f} GB take at least {copy_ms:.3f} ms at "
              f"{PEAK_BYTES / 1e12} TB/s, against the sharded - dense gap "
              f"{gap:.3f} ms; {card}")
    return {"stats": stats, "gather_copy_bound_ms": copy_ms,
            "sharded_minus_dense_ms": gap}


# ---------------------------------------------------------------------------
# phase 10b: the sharded model
# ---------------------------------------------------------------------------
def sharded_prefill(torch, dev, mesh, cfg, arch, want, card):
    """One prefill of ``cfg`` at full width, 4 x 1024, with plain tensors and
    then with the same weights as DTensors (``shard_params``), under the
    rules of a prefill cell: outputs bit for bit, launches equal to
    ``want`` in both runs (each counted from 0), host ms (one call, then
    synchronised; median of 3) and CUDA-event ms (mean of 3) of each.
    Returns (the DTensor run's launches, a row)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import context, layouts
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.io import make_batch

    gc.collect()
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    batch = make_batch(cfg, torch.Generator(device=dev).manual_seed(SEED), B, S)
    rules = layouts.choose_layout(cfg, ShapeConfig("prefill", "prefill", S, B),
                                  mesh)
    runs = {}
    for name in ("plain", "dtensor"):
        if name == "dtensor":
            layouts.shard_params(model, cfg, rules, mesh)
            batch = layouts.distribute_tree(
                batch, layouts.batch_pspecs(batch, rules), mesh)
        with context.use_rules(rules if name == "dtensor" else None):
            forward_prefill(model, cfg, batch)           # warm-up
            torch.cuda.synchronize()
            cuda_lib.launches.clear()                    # the path starts here
            logits, cache = forward_prefill(model, cfg, batch)
            torch.cuda.synchronize()
            launched = {k: n for k, n in cuda_lib.launches.items() if n}
            host = []
            for _ in range(3):
                t0 = time.perf_counter()
                forward_prefill(model, cfg, batch)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            event_ms = time_ms(torch, lambda: forward_prefill(model, cfg,
                                                             batch),
                               iters=3, warmup=0)
        check(launched == want, f"{arch} {name} prefill launched {launched}, "
              f"want {want}")
        runs[name] = {"out": [logits] + cache_leaves(cache),
                      "host_ms": float(np.median(host)), "event_ms": event_ms,
                      "launches": launched}
        del logits, cache
    outs = zip(runs["dtensor"]["out"], runs["plain"]["out"])
    same = [torch.equal(d.full_tensor(), p) for d, p in outs]
    check(all(same), f"{arch} sharded prefill vs plain: outputs "
          f"{[i for i, ok in enumerate(same) if not ok]} differ")
    row = {"layers": cfg.n_layers, "batch": B, "seq": S,
           "bit_identical_outputs": len(same),
           **{f"{n}_{k}": r[k] for n, r in runs.items()
              for k in ("host_ms", "event_ms")},
           "dtensor_host_overhead_ms":
               runs["dtensor"]["host_ms"] - runs["plain"]["host_ms"],
           "launches": runs["dtensor"]["launches"], "card": card}
    print(f"[sharded] {arch} prefill at full width, {cfg.n_layers} layers, "
          f"{B}x{S}, 1 x 1 mesh: DTensor model equals the plain model bit "
          f"for bit ({len(same)} outputs: logits and cache leaves); launches "
          f"{runs['dtensor']['launches']} in both; host ms plain "
          f"{runs['plain']['host_ms']:.2f} / DTensor "
          f"{runs['dtensor']['host_ms']:.2f} (DTensor dispatch overhead "
          f"{row['dtensor_host_overhead_ms']:.2f} ms), CUDA-event ms plain "
          f"{runs['plain']['event_ms']:.2f} / DTensor "
          f"{runs['dtensor']['event_ms']:.2f}; {card}")
    del model, runs
    return row["launches"], row


def sharded_train(torch, dev, mesh, card):
    """One h2o-danube-1.8b train step at full width (d 2560), cut to
    ``SHARDED_TRAIN_LAYERS`` layers, 4 x 2048, ``grad_accum=2``, AdamW with
    f32 master: the plain model, then the same weights as DTensors with
    ``grad_shardings`` and ``update_constraint`` set (``opt_pspecs``'
    ZeRO layout through ``param_placements``).  Loss, grad norm and every
    parameter bit for bit; flash launches equal.  Returns (the DTensor
    step's launches, a row)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import context, layouts
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.train import steps as tsteps

    arch = "h2o-danube-1.8b"
    cfg = dataclasses.replace(get_config(arch), n_layers=SHARDED_TRAIN_LAYERS)
    data = SyntheticTokens(cfg, TRAIN_B, TRAIN_S, seed=SEED)
    rules = layouts.choose_layout(
        cfg, ShapeConfig("train", "train", TRAIN_S, TRAIN_B), mesh)
    runs = {}
    for name in ("plain", "dtensor"):
        gc.collect()
        torch.cuda.empty_cache()
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_for_step(0).items()}
        gshard = None
        if name == "dtensor":
            layouts.shard_params(model, cfg, rules, mesh)
            gshard = layouts.param_placements(model, cfg, layouts.opt_pspecs(
                layouts.param_pspecs(model, cfg, rules), model, cfg, mesh),
                mesh)
            batch = layouts.distribute_tree(
                batch, layouts.batch_pspecs(batch, rules), mesh)
        opt = make_optimizer("adamw", update_constraint=gshard)
        state = tsteps.init_train_state(None, cfg, opt, params=model)
        step = tsteps.build_train_step(cfg, opt, tsteps_lr(), grad_accum=2,
                                       grad_shardings=gshard)
        with context.use_rules(rules if name == "dtensor" else None):
            torch.cuda.synchronize()
            cuda_lib.launches.clear()                    # the path starts here
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launched = {k: n for k, n in cuda_lib.launches.items() if n}

        def full(t):
            return t.full_tensor() if context.is_dtensor(t) else t
        runs[name] = {
            "metrics": {k: full(metrics[k]) for k in ("loss", "grad_norm")},
            "params": {n: full(p.detach()).clone()
                       for n, p in model.named_parameters()},
            "ms": ms, "launches": launched}
        del model, state, opt, step, batch, metrics
    n = 2 * train_launches(cfg, "flash_attention")     # two microbatches
    want = {"flash_attention": n, "flash_attention:wgmma": n}
    for name, r in runs.items():
        check(r["launches"] == want, f"{arch} {name} sharded train step "
              f"launched {r['launches']}, want {want} (two microbatches, "
              f"forward and remat recompute)")
    d, p = runs["dtensor"], runs["plain"]
    differ = [k for k in d["metrics"] if not torch.equal(d["metrics"][k],
                                                        p["metrics"][k])]
    differ += [n for n in p["params"] if not torch.equal(d["params"][n],
                                                        p["params"][n])]
    check(not differ, f"{arch} sharded train step vs plain differs at "
          f"{differ[:8]}")
    loss, gn = float(d["metrics"]["loss"]), float(d["metrics"]["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gn), f"{arch} loss {loss}")
    row = {"layers": cfg.n_layers, "d_model": cfg.d_model, "batch": TRAIN_B,
           "seq": TRAIN_S, "grad_accum": 2, "loss": loss, "grad_norm": gn,
           "bit_identical_params": len(p["params"]), "plain_ms": p["ms"],
           "dtensor_ms": d["ms"], "launches": d["launches"], "card": card}
    print(f"[sharded] {arch} one train step at full width (d_model "
          f"{cfg.d_model}), cut to {cfg.n_layers} of 24 layers, {TRAIN_B}x"
          f"{TRAIN_S}, grad_accum 2, AdamW with grad_shardings and "
          f"update_constraint (ZeRO placements): loss {loss:.6f}, grad norm "
          f"{gn:.6f} and all {len(p['params'])} parameters bit-identical to "
          f"the plain step; launches {d['launches']} in both; first step "
          f"{p['ms']:.1f} ms plain, {d['ms']:.1f} ms DTensor; {card}")
    del runs
    return row["launches"], row


def sharded_trace(torch, dev, mesh, card):
    """``sharded_train``'s step (h2o-danube-1.8b, full width, cut to
    ``SHARDED_TRAIN_LAYERS`` layers, TRAIN_B x TRAIN_S, ``grad_accum`` 2) as
    the dry-run builds it (``launch.dryrun.build_cell``: seeded weights,
    zero tokens), plain and as the DTensor step on the 1 x 1 NCCL mesh, each
    run once on the card under ``roofline.trace.OpTrace`` (which counts a
    DTensor's local ops): flops and bytes equal, flash launched twice a
    layer and microbatch in both, and the DTensor step's predicted peak
    (``launch.dryrun.record``) within PEAK_BAND of its measured
    ``max_memory_allocated``, less what earlier phases still hold.
    Returns (the DTensor step's launches, a row)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.distributed import context, layouts
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline.analysis import PEAK_BAND
    from repro_torch.roofline.trace import OpTrace, collective_stats

    arch = "h2o-danube-1.8b"
    cfg = dataclasses.replace(get_config(arch), n_layers=SHARDED_TRAIN_LAYERS)
    shape = ShapeConfig("train", "train", TRAIN_S, TRAIN_B)
    n = 2 * train_launches(cfg, "flash_attention")     # two microbatches
    want = {"flash_attention": n, "flash_attention:wgmma": n}
    runs = {}
    for name, m in (("plain", AbstractMesh(("data", "model"), (1, 1))),
                    ("dtensor", mesh)):
        gc.collect()
        torch.cuda.empty_cache()
        kept = torch.cuda.memory_allocated(dev)     # what earlier phases keep
        rules = layouts.choose_layout(cfg, shape, m)
        fn, args, in_specs, out_specs, donate = dryrun.build_cell(
            cfg, shape, m, rules, grad_accum=2, device=dev.type)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)    # the step's own peak
        cuda_lib.launches.clear()                  # the path starts here
        with context.use_rules(rules if name == "dtensor" else None), \
                OpTrace() as trace:
            out = fn(*args)
        torch.cuda.synchronize()
        launched = {k: c for k, c in cuda_lib.launches.items() if c}
        rec = dryrun.record(cfg, m, trace, out, args, in_specs, out_specs,
                            donate)
        runs[name] = {
            "flops": trace.flops, "bytes": trace.bytes_accessed,
            "ops": len(trace.ops), "launches": launched,
            "collective_operand_bytes": sum(
                v["operand_bytes"] for v in collective_stats(trace).values()),
            "predicted_peak_gb": rec["memory"]["peak_gb"],
            "argument_gb": rec["memory"]["argument_gb"],
            "kept_before_gb": kept / 1e9,
            "measured_peak_gb":
                (torch.cuda.max_memory_allocated(dev) - kept) / 1e9}
        check(launched == want, f"{arch} {name} traced train step launched "
              f"{launched}, want {want}")
        del fn, args, out, trace
    d, p = runs["dtensor"], runs["plain"]
    check(d["flops"] == p["flops"] and d["bytes"] == p["bytes"],
          f"{arch} DTensor step traced {d['flops']} flops / {d['bytes']} "
          f"bytes, the plain step {p['flops']} / {p['bytes']}")
    ratio = d["measured_peak_gb"] / d["predicted_peak_gb"]
    check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
          f"{arch} DTensor step: measured peak {d['measured_peak_gb']} GB "
          f"against the predicted {d['predicted_peak_gb']} GB, outside "
          f"{PEAK_BAND}: {runs}")
    row = {"layers": cfg.n_layers, "batch": TRAIN_B, "seq": TRAIN_S,
           "grad_accum": 2, **runs, "peak_ratio": ratio, "card": card}
    print(f"[sharded] {arch} train step ({cfg.n_layers} layers, {TRAIN_B}x"
          f"{TRAIN_S}, grad_accum 2) traced on the card: DTensor on the 1 x 1 "
          f"mesh {d['flops']:.6e} flops, {d['bytes']:.6e} bytes, {d['ops']} "
          f"ops; plain {p['flops']:.6e} flops, {p['bytes']:.6e} bytes, "
          f"{p['ops']} ops; predicted peak {d['predicted_peak_gb']:.3f} GB, "
          f"measured {d['measured_peak_gb']:.3f} GB (ratio {ratio:.4f}, band "
          f"{PEAK_BAND}; plain {p['predicted_peak_gb']:.3f} / "
          f"{p['measured_peak_gb']:.3f} GB; earlier phases held "
          f"{d['kept_before_gb']:.3f} GB); launches {d['launches']} in both; "
          f"{card}")
    return d["launches"], row


def sharded_path(torch, np, dev, card):
    """Phase 10b: the sharded model (``distributed.layouts.shard_params``:
    DTensor parameters at ``param_pspecs``, under ``use_rules``) on one
    NCCL rank and a 1 x 1 mesh, the kernels on the card through their
    ``local_map`` routes, each path against the plain model bit for bit:
    gemma3-1b's prefill at full width and depth, recurrentgemma-2b's and
    rwkv6-7b's at one superblock, h2o-danube-1.8b's train step
    (``sharded_train``).  With two or more cards the sharded prefill runs
    across NCCL ranks too (``spawn_multi_card``).  Returns (launches by
    path, the phase's numbers)."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh

    out, launches = {"card": card}, {}
    tmp = tempfile.TemporaryDirectory()
    init_group(dev, 1, 0, str(Path(tmp.name) / "store"))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev.type)
        print(f"[sharded] {dist.get_backend()} group of "
              f"{dist.get_world_size()} rank, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}; {card}")
        for arch in ("gemma3-1b",) + RECURRENT:
            cfg = path_config(arch)
            if arch in RECURRENT:
                cfg = dataclasses.replace(get_config(arch),
                                          n_layers=cfg.pattern_len)
            want = {}
            for kernel, kinds in KINDS_OF.items():
                n = sum(kind in kinds for kind in cfg.layer_kinds())
                if n:
                    want[kernel] = want[f"{kernel}:{VARIANT[kernel]}"] = n
            launches[f"{arch} sharded"], out[f"{arch} prefill"] = \
                sharded_prefill(torch, dev, mesh, cfg, arch, want, card)
        launches["h2o-danube-1.8b sharded train"], out["h2o-danube-1.8b train"] \
            = sharded_train(torch, dev, mesh, card)
        launches["h2o-danube-1.8b sharded trace"], out["h2o-danube-1.8b trace"] \
            = sharded_trace(torch, dev, mesh, card)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    n = torch.cuda.device_count()
    if n >= 2:
        out["multi_card"] = (f"{n} NCCL ranks, one a card: the sharded "
                             f"prefill parity ran in [distributed]")
    else:
        out["multi_card"] = (f"not run: {n} card on this machine, and NCCL "
                             f"takes one rank a card")
        print(f"[sharded] the sharded prefill across NCCL ranks not run: this "
              f"machine has {n} card (the 8-rank parity runs on gloo in "
              f"tests/test_torch_sharded.py)")
    return launches, out


def roofline_steps(serving, train_out) -> list:
    """(path, config, shape, measured ms, measured peak GB) of every step
    the serving and training phases timed, at their depth, batch and
    length."""
    from repro_torch.configs.base import ShapeConfig, get_config
    steps = []
    for arch in PATHS:
        cfg, row = path_config(arch), serving[arch]
        for kind in ("prefill", "decode"):
            steps.append((f"{arch} {kind}", cfg, ShapeConfig(kind, kind, S, B),
                          row[f"{kind}_ms"], row[f"{kind}_peak_gb"]))
    kvq = serving["gemma3-1b kv_quant"]
    steps.append(("gemma3-1b kv_quant decode",
                  dataclasses.replace(path_config("gemma3-1b"), kv_quant=True),
                  ShapeConfig("decode", "decode", S, B), kvq["int8_decode_ms"],
                  kvq["int8_decode_peak_gb"]))
    h2o = train_out["h2o-danube-1.8b"]
    steps.append(("h2o-danube-1.8b train", get_config("h2o-danube-1.8b"),
                  ShapeConfig("train", "train", TRAIN_S, TRAIN_B),
                  h2o["median_ms_steps_2_5"], h2o["step_peak_gb"]))
    for arch in RECURRENT:
        full = get_config(arch)
        steps.append((f"{arch} train",
                      dataclasses.replace(full, n_layers=full.pattern_len),
                      ShapeConfig("train", "train", REC_TRAIN_S, REC_TRAIN_B),
                      train_out[arch]["ms"], train_out[arch]["step_peak_gb"]))
    for arch, depth in TRAIN_MOE_DEPTH.items():
        cfg = get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        row = train_out["train_moe"][arch]
        steps.append((f"{arch} train", cfg,
                      ShapeConfig("train", "train", TRAIN_MOE_S, TRAIN_MOE_B),
                      row["ms"], row["peak_memory_gb"]))
    return steps


def roofline_path(torch, steps, card) -> list:
    """Phase 11: each timed step traced on the meta device (the dry-run's
    ``trace_cell``, a 1 x 1 mesh), held against its H100 roofline: the
    bound (every flop at the bf16 tensor-core peak against the arguments
    read once and the outputs written once) must not exceed the measured
    time by more than ROOFLINE_SLACK, and the measured peak memory must lie
    within PEAK_BAND of the predicted one."""
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline.analysis import PEAK_BAND, step_model_flops
    from repro_torch.roofline.bounds import PEAK_BF16_FLOPS, bound
    mesh = AbstractMesh(("data", "model"), (1, 1))
    rows = []
    for name, cfg, shape, ms, peak_gb in steps:
        rec = trace_cell(cfg, shape, mesh, grad_accum=1)
        flops = rec["cost"]["flops_per_device"]
        compulsory = rec["cost"]["compulsory_bytes"]
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, compulsory)
        model_flops = step_model_flops(cfg, shape)
        row = {"path": name, "layers": cfg.n_layers, "batch": shape.global_batch,
               "seq": shape.seq_len, "flops": flops,
               "compulsory_bytes": compulsory,
               "bytes_accessed": rec["cost"]["bytes_accessed"],
               "model_flops": model_flops, "bound_ms": bound_ms,
               "bound_by": bound_by, "measured_ms": ms,
               "roofline_fraction": bound_ms / ms,
               "mfu": model_flops / (ms / 1e3 * PEAK_BF16_FLOPS),
               "predicted_peak_gb": rec["memory"]["peak_gb"],
               "measured_peak_gb": peak_gb,
               "peak_ratio": peak_gb / rec["memory"]["peak_gb"],
               "traced_ops": rec["hlo_len"], "trace_s": rec["lower_s"],
               "card": card}
        print("[roofline] " + json.dumps(row), flush=True)
        check(row["roofline_fraction"] <= ROOFLINE_SLACK,
              f"{name}: bound {bound_ms} ms above the measured {ms} ms: the "
              f"count is wrong")
        check(PEAK_BAND[0] <= row["peak_ratio"] <= PEAK_BAND[1],
              f"{name}: measured peak {peak_gb} GB against the predicted "
              f"{rec['memory']['peak_gb']} GB, outside {PEAK_BAND}")
        rows.append(row)
    return rows


def dryrun_record(cell, layers: int = DRYRUN_LAYERS) -> tuple:
    """``python -m repro_torch.launch.dryrun`` on ``cell`` cut to
    ``layers`` layers, in a subprocess (a fake world needs a process
    without a process group) under ``DRYRUN_TIMEOUT_S`` -> (its record,
    the wall seconds); fails on a non-zero exit or a timeout."""
    arch, shape, mesh = cell
    root = Path(__file__).resolve().parent
    path = root / "experiments" / "dryrun_torch" / \
        f"{arch}__{shape}__{mesh}.json"
    path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--layers", str(layers)]
    t0 = time.perf_counter()
    try:
        run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=DRYRUN_TIMEOUT_S, env=dict(
                                 os.environ, PYTHONPATH=str(root / "src")))
    except subprocess.TimeoutExpired:
        check(False, f"[dryrun] {' '.join(cmd[1:])} did not finish in "
              f"{DRYRUN_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"[dryrun] {' '.join(cmd[1:])} exited "
          f"{run.returncode}: {run.stderr[-3000:]}")
    rec = json.loads(path.read_text())
    chips = 512 if mesh == "multipod" else 256
    check(rec["cost"]["split"] == f"rank{rec['rank_traced']}" and
          rec["n_chips"] == chips, f"[dryrun] the record does not name the "
          f"rank it traced of {chips}: {rec['cost']}")
    return rec, wall


def dryrun_records(cells: dict) -> dict:
    """``dryrun_record`` of each of ``cells`` ({name: (cell, layers)}) at
    once, each in its own subprocess -> {name: (record, wall seconds)}.
    The traces are independent and each spends most of its wall time
    starting Python and torch, so together they take about the longest
    one's time, not their sum."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(cells)) as pool:
        runs = {name: pool.submit(dryrun_record, *cell)
                for name, cell in cells.items()}
        return {name: run.result() for name, run in runs.items()}


def dryrun_path(card) -> dict:
    """Phase 12: ``DRYRUN_CELL``'s sharded step traced as one rank of a fake
    256-rank world (``launch.dryrun.traced_rank``: rank 0 here) on the host (``dryrun_record``).  Prints its
    collectives, per-device flops and op count on one line, beside a CPU
    host's (``DRYRUN_CPU``); fails on no reduce-scatter.  Then
    ``DRYRUN_HEADS_CELL``'s: prints its attention flops a device (flash
    and the eager backward's ``bmm``), its largest all-gather and flash's
    local q; fails unless flash runs on one q head of the rank's rows, or
    where an all-gather is as large as the f32 logits of those rows.  Then
    ``DRYRUN_ROWS_CELL``'s: prints its attention and other products' flops
    a device, the q-rows route's local q and the k/v projections' local
    columns (the record's ``q_rows:attention`` and ``kv_columns``); fails
    unless the rank ran one head's S / n rows (n = 16 / heads) of its
    microbatch rows and the projections' K * hd / 16 columns.  Then
    ``DRYRUN_GROUPS_CELL``'s at its superblock: prints the traced rank,
    flash's local q and the attention flops a device; fails unless the
    rank at ``model`` coordinate 15 ran flash on one head group's S / n
    rows (g = gcd(heads, 16) groups, n = 16 / g).  Then
    ``DRYRUN_RWKV_CELL``'s: prints its products' flops a device and their
    largest shapes; fails unless they are within ``DRYRUN_PRODUCTS_SLACK``
    of the reference's and the d x d products ran on the rank's S / 16
    rows of its microbatch.  The gemma2-9b and rwkv6-7b lines give their
    reduce-scatter and all-reduce bytes at the dry-run's grad_accum beside
    the CPU trace's at 1 (``reductions``), and fail unless the
    reduce-scatter is within ``DRYRUN_REDUCE_SLACK`` of it (C8).  Then
    ``DRYRUN_WHISPER_CELL``'s: prints rank 15's products' flops a device
    beside the reference's and their largest shapes; fails unless they
    are within ``DRYRUN_PRODUCTS_SLACK`` of it (C14: the head on each
    rank's rows).  Then ``DRYRUN_DECODE_CELL``'s the same way, against
    ``DRYRUN_DECODE_REFERENCE_PRODUCTS`` (C16), and
    ``DRYRUN_RWKV_DECODE_CELL``'s, against the reference's products and
    attention (C17; ``dryrun_decode_row``).  Then
    ``DRYRUN_MULTIPOD_CELL``'s: prints its reductions
    (``multipod_reductions``); fails unless every parameter's gradient and
    every microbatch's token count took one collective over ``pod`` and
    ``data`` flattened and no all-reduce ran over ``pod`` alone (C15;
    ``DeviceMesh._flatten`` under the card machine's torch).  The nine
    cells run at once (``dryrun_records``); each line gives its
    subprocess's wall seconds: these are the runs of the routes under the
    card machine's torch."""
    import torch
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.launch.dryrun import TRAIN_GRAD_ACCUM
    runs = dryrun_records({
        "dryrun": (DRYRUN_CELL, DRYRUN_LAYERS),
        "heads": (DRYRUN_HEADS_CELL, DRYRUN_LAYERS),
        "rows": (DRYRUN_ROWS_CELL, DRYRUN_LAYERS),
        "groups": (DRYRUN_GROUPS_CELL, DRYRUN_GROUPS_LAYERS),
        "rwkv": (DRYRUN_RWKV_CELL, DRYRUN_LAYERS),
        "whisper": (DRYRUN_WHISPER_CELL, DRYRUN_LAYERS),
        "decode": (DRYRUN_DECODE_CELL, DRYRUN_DECODE_LAYERS),
        "rwkv_decode": (DRYRUN_RWKV_DECODE_CELL, DRYRUN_LAYERS),
        "multipod": (DRYRUN_MULTIPOD_CELL, DRYRUN_LAYERS)})
    arch, shape, mesh = DRYRUN_CELL
    rec, wall = runs["dryrun"]
    row = {"cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
           "n_chips": rec["n_chips"], "n_ranks_traced": rec["n_ranks_traced"],
           "flops_per_device": rec["cost"]["flops_per_device"],
           "bytes_accessed": rec["cost"]["bytes_accessed"],
           "temp_gb": rec["memory"]["temp_gb"],
           "peak_gb": rec["memory"]["peak_gb"],
           "collectives": rec["collectives"], "trace_s": rec["lower_s"],
           "wall_s": wall, "ops": rec["hlo_len"], "torch": torch.__version__,
           "cpu_trace": DRYRUN_CPU, "card": card}
    print("[dryrun] " + json.dumps(row), flush=True)
    check(rec["collectives"]["reduce-scatter"]["count"] > 0,
          f"[dryrun] {arch} {shape} on {mesh} issued no reduce-scatter")

    arch, shape, mesh = DRYRUN_HEADS_CELL
    rec, wall = runs["heads"]
    cfg, sh = get_config(arch), LM_SHAPES[shape]
    rows = sh.global_batch // TRAIN_GRAD_ACCUM // 16    # 16 data ranks
    work = rec[rec["cost"]["split"]]
    flash_q = work["kernel_shapes"]["flash_attention"]
    heads = sorted({bk * g // rows for bk, _, g, _ in flash_q})
    gather = work["largest_collective"]["all-gather"]
    logits = rows * sh.seq_len * cfg.vocab_size * 4
    ops = work["op_flops"]
    heads_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "attention_flops_per_device":
            ops.get("flash_attention", 0) + ops.get("aten.bmm", 0),
        "flash_local_q": flash_q, "flash_local_q_heads": heads,
        "largest_all_gather": gather, "logits_rows_bytes": logits,
        **reductions(arch, rec), "collectives": rec["collectives"],
        "trace_s": rec["lower_s"], "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(heads_row), flush=True)
    check_reductions(heads_row)
    check(heads == [1] and all(s == sh.seq_len for _, s, _, _ in flash_q),
          f"[dryrun] {arch}: flash's local q {flash_q} is not 1 head of "
          f"the rank's {rows} rows")
    check(gather["output_bytes"] < logits,
          f"[dryrun] {arch}: an all-gather of {gather['output_bytes']} bytes "
          f"carries the logits ({logits} bytes)")

    arch, shape, mesh = DRYRUN_ROWS_CELL
    rec, wall = runs["rows"]
    cfg, sh = get_config(arch), LM_SHAPES[shape]
    rows = sh.global_batch // TRAIN_GRAD_ACCUM // 16    # 16 data ranks
    work = rec[rec["cost"]["split"]]
    shapes, ops = work["kernel_shapes"], work["op_flops"]
    local_q = shapes.get("q_rows:attention")
    columns = shapes.get("kv_columns")
    rows_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "rank_traced": rec["rank_traced"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "attention_flops_per_device":
            ops.get("flash_attention", 0) + ops.get("aten.bmm", 0),
        "product_flops_per_device": ops.get("aten.mm", 0),
        "q_rows_local_q": local_q, "kv_columns_local": columns,
        "collectives": rec["collectives"], "trace_s": rec["lower_s"],
        "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(rows_row), flush=True)
    n = 16 // cfg.n_heads
    check(local_q == [[rows, sh.seq_len // n, 1, cfg.head_dim]],
          f"[dryrun] {arch}: the q-rows route's local q {local_q} is not "
          f"one head's {sh.seq_len // n} rows of the rank's {rows} rows")
    check(columns == [[cfg.d_model, cfg.n_kv_heads * cfg.head_dim // 16]],
          f"[dryrun] {arch}: the k/v projections' local {columns} are not "
          f"cut by columns over 16 ranks")

    arch, shape, mesh = DRYRUN_GROUPS_CELL
    rec, wall = runs["groups"]
    cfg, sh = get_config(arch), LM_SHAPES[shape]
    rows = sh.global_batch // TRAIN_GRAD_ACCUM // 16    # 16 data ranks
    work = rec[rec["cost"]["split"]]
    ops = work["op_flops"]
    local_q = work["kernel_shapes"].get("q_rows:flash attention")
    groups_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "rank_traced": rec["rank_traced"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "attention_flops_per_device":
            ops.get("flash_attention", 0) + ops.get("aten.bmm", 0),
        "flash_flops_per_device": ops.get("flash_attention", 0),
        "q_rows_local_q": local_q,
        "flash_local_q": work["kernel_shapes"].get("flash_attention"),
        "collectives": rec["collectives"], "trace_s": rec["lower_s"],
        "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(groups_row), flush=True)
    g = math.gcd(cfg.n_heads, 16)
    check(rec["rank_traced"] == 15 and local_q == [
        [rows, sh.seq_len * g // 16, cfg.n_heads // g, cfg.head_dim]],
          f"[dryrun] {arch}: rank {rec['rank_traced']}'s flash local q "
          f"{local_q} is not {cfg.n_heads // g} heads' "
          f"{sh.seq_len * g // 16} rows of the rank's {rows} rows")

    arch, shape, mesh = DRYRUN_RWKV_CELL
    rec, wall = runs["rwkv"]
    cfg, sh = get_config(arch), LM_SHAPES[shape]
    rows = sh.global_batch // TRAIN_GRAD_ACCUM // 16 * sh.seq_len
    work = rec[rec["cost"]["split"]]
    products = work["op_flops"].get("aten.mm", 0)
    rwkv_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "rank_traced": rec["rank_traced"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "product_flops_per_device": products,
        "reference_product_flops": DRYRUN_RWKV_REFERENCE_PRODUCTS,
        "largest_products": dict(list(work["product_shapes"].items())[:4]),
        **reductions(arch, rec), "collectives": rec["collectives"],
        "trace_s": rec["lower_s"], "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(rwkv_row), flush=True)
    check_reductions(rwkv_row)
    d = cfg.d_model
    check(0 < products <= DRYRUN_PRODUCTS_SLACK *
          DRYRUN_RWKV_REFERENCE_PRODUCTS,
          f"[dryrun] {arch}: {products} product flops a device against the "
          f"reference's {DRYRUN_RWKV_REFERENCE_PRODUCTS}")
    check(f"{rows // 16}x{d} @ {d}x{d}" in work["product_shapes"],
          f"[dryrun] {arch}: no d x d product on the rank's {rows // 16} "
          f"rows: {list(work['product_shapes'])}")

    arch, shape, mesh = DRYRUN_WHISPER_CELL
    rec, wall = runs["whisper"]
    work = rec[rec["cost"]["split"]]
    products = work["op_flops"].get("aten.mm", 0)
    shapes = work["product_shapes"]
    whisper_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "rank_traced": rec["rank_traced"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "product_flops_per_device": products,
        "reference_product_flops": DRYRUN_WHISPER_REFERENCE_PRODUCTS,
        "largest_products": dict(list(shapes.items())[:4]),
        "collectives": rec["collectives"], "trace_s": rec["lower_s"],
        "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(whisper_row), flush=True)
    check(rec["rank_traced"] == 15 and 0 < products <=
          DRYRUN_PRODUCTS_SLACK * DRYRUN_WHISPER_REFERENCE_PRODUCTS,
          f"[dryrun] {arch}: rank {rec['rank_traced']}'s {products} product "
          f"flops a device against the reference's "
          f"{DRYRUN_WHISPER_REFERENCE_PRODUCTS}")
    decode_row = dryrun_decode_row(DRYRUN_DECODE_CELL, runs["decode"],
                                   DRYRUN_DECODE_REFERENCE_PRODUCTS, card)
    rwkv_decode_row = dryrun_decode_row(
        DRYRUN_RWKV_DECODE_CELL, runs["rwkv_decode"],
        DRYRUN_RWKV_DECODE_REFERENCE_PRODUCTS, card,
        DRYRUN_RWKV_DECODE_REFERENCE_ATTENTION)

    arch, shape, mesh = DRYRUN_MULTIPOD_CELL
    rec, wall = runs["multipod"]
    multipod_row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        **multipod_reductions(rec), "collectives": rec["collectives"],
        "trace_s": rec["lower_s"], "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(multipod_row), flush=True)
    check(multipod_row["all_reduce_over_pod_alone"] == 0 and
          multipod_row["flattened_reductions"] ==
          multipod_row["parameters"] + multipod_row["grad_accum"],
          f"[dryrun] {arch} on {mesh}: {multipod_row['flattened_reductions']}"
          f" reductions over pod and data flattened for "
          f"{multipod_row['parameters']} parameters and "
          f"{multipod_row['grad_accum']} token counts, "
          f"{multipod_row['all_reduce_over_pod_alone']} all-reduces over "
          f"pod alone")
    return {"dryrun": row, "heads": heads_row, "rows": rows_row,
            "groups": groups_row, "rwkv": rwkv_row, "whisper": whisper_row,
            "decode": decode_row, "rwkv_decode": rwkv_decode_row,
            "multipod": multipod_row}


def dryrun_decode_row(cell, run, reference_products: int, card,
                      reference_attention: int = 0) -> dict:
    """A ``[dryrun]`` decode cell's line: the traced rank's products (and,
    where ``reference_attention`` is given, its attention: ``bmm`` and
    flash) a device beside the reference's and their largest shapes; fails
    unless the products are within ``DRYRUN_PRODUCTS_SLACK`` of the
    reference's and the attention within ``DRYRUN_ATTENTION_SLACK``."""
    arch, shape, mesh = cell
    rec, wall = run
    work = rec[rec["cost"]["split"]]
    ops = work["op_flops"]
    products = ops.get("aten.mm", 0)
    attention = ops.get("aten.bmm", 0) + ops.get("flash_attention", 0)
    row = {
        "cell": f"{arch} {shape} {mesh}", "layers": rec["layers"],
        "rank_traced": rec["rank_traced"],
        "flops_per_device": rec["cost"]["flops_per_device"],
        "product_flops_per_device": products,
        "reference_product_flops": reference_products,
        "attention_flops_per_device": attention,
        "reference_attention_flops": reference_attention or None,
        "largest_products": dict(list(work["product_shapes"].items())[:4]),
        "collectives": rec["collectives"], "trace_s": rec["lower_s"],
        "wall_s": wall, "card": card}
    print("[dryrun] " + json.dumps(row), flush=True)
    check(0 < products <= DRYRUN_PRODUCTS_SLACK * reference_products,
          f"[dryrun] {arch} {shape}: {products} product flops a device "
          f"against the reference's {reference_products}")
    check(not reference_attention or 0 < attention <=
          DRYRUN_ATTENTION_SLACK * reference_attention,
          f"[dryrun] {arch} {shape}: {attention} attention flops a device "
          f"against the reference's {reference_attention}")
    return row


def multipod_reductions(rec) -> dict:
    """A ``multipod`` train record's reductions (C15): the collectives over
    ``pod`` and ``data`` flattened (32 ranks, or 512 with ``model``: one a
    parameter's gradient and one a microbatch's token count), the
    parameters of the cell's model, and the count and bytes of each kind
    over ``pod`` alone (2 ranks)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import TRAIN_GRAD_ACCUM
    from repro_torch.models import init_params
    groups = rec[rec["cost"]["split"]]["collective_groups"]
    cfg = dataclasses.replace(get_config(rec["arch"]),
                              n_layers=rec["layers"])
    pod = {kind: by["2"] for kind, by in groups.items() if "2" in by}
    return {"grad_accum": TRAIN_GRAD_ACCUM,
            "parameters": len(list(init_params(cfg, None,
                                               device="meta").parameters())),
            "flattened_reductions": sum(
                groups.get(kind, {}).get(n, {"count": 0})["count"]
                for kind in ("all-reduce", "reduce-scatter")
                for n in ("32", "512")),
            "all_reduce_over_pod_alone":
                pod.get("all-reduce", {"count": 0})["count"],
            "over_pod_alone": pod}


def reductions(arch: str, rec) -> dict:
    """A [dryrun] record's reduce-scatter and all-reduce operand bytes at
    the dry-run's grad_accum, beside the CPU trace's at a grad_accum of 1
    (``DRYRUN_ACCUM1_BYTES``)."""
    from repro_torch.launch.dryrun import TRAIN_GRAD_ACCUM
    return {"grad_accum": TRAIN_GRAD_ACCUM,
            "reduce_scatter_bytes":
                rec["collectives"]["reduce-scatter"]["operand_bytes"],
            "all_reduce_bytes":
                rec["collectives"]["all-reduce"]["operand_bytes"],
            "accum1_cpu_bytes": DRYRUN_ACCUM1_BYTES[arch]}


def check_reductions(row):
    """C8: fails unless the reduce-scatter at the dry-run's grad_accum is
    within ``DRYRUN_REDUCE_SLACK`` of the CPU trace's at 1 (a gradient
    reduced in every microbatch's backward would add its bytes three
    times over)."""
    want = row["accum1_cpu_bytes"]["reduce-scatter"]
    check(0 < row["reduce_scatter_bytes"] <= DRYRUN_REDUCE_SLACK * want,
          f"[dryrun] {row['cell']}: {row['reduce_scatter_bytes']} "
          f"reduce-scatter bytes at grad_accum {row['grad_accum']} against "
          f"{want} at 1")


def multirank_worker():
    """tests/torch_dist_worker.py, which holds the cells, the inputs'
    layout and the unsharded port they are held to (no JAX)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_dist_worker
    return torch_dist_worker


def multirank_inputs(width: str | None = "full") -> dict:
    """The ranks' INPUTS (``torch_dist_worker.build_inputs``) on the
    port's own weights: each cell's model and rwkv6-7b's mixes from
    ``seeded_model`` (a seeded ``torch.Generator``, the zero leaves given
    numpy draws), the attention layers' and MoEs' weights from the port's
    ``init_attention`` / ``init_moe``, whisper's and paligemma's batches
    from ``data.SyntheticTokens``; with ``width``, ``MULTIRANK_FULL_CELL``
    at that width (``"full"`` or ``"smoke"``), its weights drawn by each
    rank from its seed.  Imports no JAX and nothing of the reference."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import attention as tattn
    from repro_torch.models import moe as tmoe
    worker = multirank_worker()
    cpu = torch.device("cpu")

    def attention(i, tag):
        cfg = worker.group_layer_config(tag, get_smoke_config)
        p = tattn.init_attention(cfg, torch.Generator().manual_seed(30 + i),
                                 cpu)
        return {n: t.detach().numpy() for n, t in p.named_parameters()}

    def moe(i, arch):
        cfg = worker.moe_dense_config(arch, get_smoke_config)
        p = tmoe.init_moe(cfg, torch.Generator().manual_seed(i), cpu)
        return {n.replace(".", "/"): t.detach().numpy()
                for n, t in p.named_parameters()}
    inp = worker.build_inputs(types.SimpleNamespace(
        cell=lambda cell: worker.seeded_model(worker.table_config(cell), 0),
        batch=lambda cell: SyntheticTokens(
            worker.table_config(cell), worker.B, worker.S,
            seed=0).batch_for_step(0),
        rwkv=lambda tag: worker.seeded_model(
            worker.rwkv_config(tag, get_smoke_config), 5),
        attention=attention, moe=moe))
    if width:
        cell, arch, layers = MULTIRANK_FULL_CELL
        base = get_config if width == "full" else get_smoke_config
        inp["cells"] = np.array(f"{inp['cells']},{cell}")
        inp.update({f"{cell}/{k}": np.array(v) for k, v in (
            ("arch", arch), ("kinds", "prefill,decode"), ("kv_quant", False),
            ("accum", 0), ("width", width), ("seed", SEED),
            ("config", json.dumps({"n_layers": layers})))})
        inp[f"{cell}/tokens"] = np.random.default_rng(SEED).integers(
            2, base(arch).vocab_size, (worker.B, worker.S + 1))
    return inp


def multirank_compare(np, res, want, inp) -> list:
    """Rank 0's results (``res``) against the unsharded port's (``want``,
    ``torch_dist_worker.unsharded``), by tests/test_torch_sharded.py's
    rules: every output, cache leaf, parameter, gradient, loss and grad
    norm to ``DIST_F32_TOL`` relative (an int8 cache leaf at most one step
    off in under 1e-3 of its elements; AdamW's m and v to
    ``torch_dist_worker.GRAD_TOL`` where it names the cell, each new weight
    to 1e-5 of itself plus lr times the two runs' step directions'
    difference); the vocab-parallel loss and the reductions to 1e-6;
    ``_microbatch``'s rows and the all-to-all's shard exactly.  -> one row
    a cell or part: its largest relative error, the quantity, how many
    were held, and what failed."""
    worker = multirank_worker()

    def rel(g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            return math.inf
        return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))

    rows = []

    def row(part, pairs, tol=DIST_F32_TOL, failed=(), **extra):
        errs = {k: rel(g, w) for k, (g, w) in pairs.items()}
        worst = max(errs, key=errs.get)
        rows.append({"part": part, "max_rel_err": errs[worst], "tol": tol,
                     "worst": worst, "held": len(errs), **extra,
                     "failed": [*(k for k, e in errs.items()
                                  if not e <= tol), *failed]})

    for cell in str(inp["cells"]).split(","):
        kinds = str(inp[f"{cell}/kinds"])
        w = want[cell]
        if kinds != "train":
            pairs, int8, failed = {}, [], []
            for kind in kinds.split(","):
                n = sum(1 for k in res if k.startswith(f"{cell}/{kind}/cache"))
                got = [res[f"{cell}/{kind}/logits"]] + [
                    res[f"{cell}/{kind}/cache{i}"] for i in range(n)]
                if len(got) != len(w[kind]):
                    failed.append(f"{kind}: {len(got)} outputs, the port "
                                  f"{len(w[kind])}")
                for i, (g, x) in enumerate(zip(got, w[kind])):
                    if x.dtype == np.int8:
                        off = np.abs(g.astype(np.int32) - x)
                        int8.append(float((g != x).mean()))
                        if g.shape != x.shape or off.max() > 1 or \
                                int8[-1] >= 1e-3:
                            failed.append(f"{kind}/cache{i - 1} (int8)")
                    else:
                        name = "logits" if i == 0 else f"cache{i - 1}"
                        pairs[f"{kind}/{name}"] = (g, x)
            row(cell, pairs, kinds=kinds, failed=failed,
                **({"int8_mismatch_share": max(int8)} if int8 else {}))
            continue
        pairs = {k: (res[f"{cell}/{k}"], w[k]) for k in ("loss", "grad_norm")}
        failed, extra = [], {"kinds": kinds}
        if "m" not in w:
            pairs.update({f"new/{n}": (res[f"{cell}/new/{n}"], x)
                          for n, x in w["new"].items()})
        else:
            tol = worker.GRAD_TOL.get(cell, DIST_F32_TOL)
            mv = {f"{k}/{n}": rel(res[f"{cell}/{k}/{n}"], w[k][n])
                  for n in w["new"] for k in ("m", "v")}
            failed += sorted(k for k, e in mv.items() if not e <= tol)
            extra.update({"m_v_max_rel_err": max(mv.values()),
                          "m_v_tol": tol})
            if tol == DIST_F32_TOL:
                pairs.update({k: (res[f"{cell}/{k}"], w[k[0]][k[2:]])
                              for k in mv})
            lr = worker.LR
            params = []
            for n, x in w["new"].items():
                moved = lr * np.abs(
                    worker.adamw_ratio(res[f"{cell}/m/{n}"],
                                       res[f"{cell}/v/{n}"])
                    - worker.adamw_ratio(w["m"][n], w["v"][n]))
                got = res[f"{cell}/new/{n}"].astype(np.float64)
                if not np.all(np.abs(got - x) <= DIST_F32_TOL * np.abs(x) +
                              moved + 1e-9):
                    failed.append(f"new/{n}")
                params.append(rel(got, x))
            extra["adamw_params_max_rel_err"] = max(params)
        row(cell, pairs, failed=failed, **extra)
    for part in ("kernels", "layers", "rwkv", "moed"):
        row(part, {k: (res[k], x) for k, x in want[part].items()})
    row("loss", {k: (res[k], want["xent"][k])
                 for k in ("xent/loss", "xent/grad")}, tol=1e-6,
        failed=[] if int(res["xent/n"]) == int(want["xent"]["xent/n"])
        else ["xent/n"])
    g = inp["reduce/g"].astype(np.float64)
    pairs = {}
    for case, (held, _) in worker.REDUCE_CASES.items():
        total = g.sum(0) if held[2] == "P" else g[:4].sum(0)
        for how in ("flat", "steps"):
            pairs[f"reduce/{case}/{how}"] = (res[f"reduce/{case}/{how}"],
                                             total)
    row("reduce", pairs, tol=1e-6)
    rows_of = np.arange(64 * 4).reshape(4, 16, 4)
    exact = {f"mb/{i}": (res[f"mb/{i}"], rows_of[i]) for i in range(4)}
    exact["a2a/local"] = (res["a2a/local"], np.arange(
        8 * 12, dtype=np.float32).reshape(8, 12)[:, :6])
    row("microbatch, all-to-all", exact, tol=0.0)
    return rows


def multirank_path(card, beside=None, width: str = "full") -> dict:
    """Phase 13, a host check like ``[dryrun]`` (no card, and no fallback
    for one): ``MULTIRANK_WORLD`` gloo ranks of ``tests/torch_dist_worker.py
    ... sharded`` on the host's CPU under this machine's torch, a (2, 4)
    ("data", "model") mesh from a FileStore in a temp dir, one thread
    each, run every cell of tests/test_torch_sharded.py (the smoke configs
    in f32) and ``MULTIRANK_FULL_CELL`` at ``width``, and every part whose
    oracle is the unsharded port (the kernels' DTensor routes, the
    head-group layers, rwkv6-7b's mixes on the rows, the reductions, the
    vocab-parallel loss, the MoE fallback, ``_microbatch`` and the
    all-to-all) on ``multirank_inputs``; meanwhile this process runs
    ``beside`` (the ``[dryrun]`` phase) in a thread and computes the
    unsharded port on the same inputs (``torch_dist_worker.unsharded``,
    the ranks' attention hook), then joins the ranks under
    ``MULTIRANK_TIMEOUT_S``.  One ``[multirank]`` line a cell or part
    (``multirank_compare``), one JSON line with the torch version, the
    backend, the world, the mesh, each one's largest relative error and
    the phase's wall seconds; fails on a rank's non-zero exit, the limit,
    or any mismatch.  -> (the JSON line's object, ``beside``'s result)."""
    import concurrent.futures
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as tattn
    worker = multirank_worker()
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        inp = multirank_inputs(width)
        np.savez(d / "inputs.npz", **inp)
        env = dict(os.environ, PYTHONPATH=str(root / "src"),
                   OMP_NUM_THREADS="1")
        logs = [open(d / f"log{r}.txt", "w+") for r in
                range(MULTIRANK_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, str(root / "tests" / "torch_dist_worker.py"),
             str(r), str(MULTIRANK_WORLD), str(d / "store"),
             str(d / "inputs.npz"), str(d / f"out{r}.npz"), "sharded"],
            cwd=root, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(MULTIRANK_WORLD)]
        deadline = time.monotonic() + MULTIRANK_TIMEOUT_S
        try:
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                side = pool.submit(beside) if beside else None
                threads, hook = torch.get_num_threads(), tattn._ATTN_IMPL
                torch.set_num_threads(1)
                tattn.set_attention_impl(flash_attention)
                try:
                    want = worker.unsharded(inp)
                finally:
                    torch.set_num_threads(threads)
                    tattn.set_attention_impl(hook)
                beside_out = side.result() if side else None
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    check(False, f"[multirank] the {MULTIRANK_WORLD} gloo "
                          f"ranks did not finish in {MULTIRANK_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        bad = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            if p.returncode != 0:
                bad.append(f"rank {r} exited {p.returncode}: "
                           f"{log.read()[-3000:]}")
            log.close()
        check(not bad, "[multirank] " + "\n".join(bad[:2]))
        res = dict(np.load(d / "out0.npz"))
    rows = multirank_compare(np, res, want, inp)
    host = ("a host check like [dryrun]: gloo ranks on the host's CPU, "
            "no card")
    for row in rows:
        print("[multirank] " + json.dumps({**row, "check": host}),
              flush=True)
    out = {"check": host, "torch": torch.__version__, "backend": "gloo",
           "device": "cpu", "world": MULTIRANK_WORLD, "mesh": [2, 4],
           "full_cell": f"{MULTIRANK_FULL_CELL[1]} at {width} width, "
                        f"{MULTIRANK_FULL_CELL[2]} layer, prefill "
                        f"{worker.B} x {worker.S} and one decode step",
           "max_rel_err": {r["part"]: r["max_rel_err"] for r in rows},
           "failed": {r["part"]: r["failed"] for r in rows if r["failed"]},
           "wall_s": wall, "card": card}
    print(json.dumps({"multirank": out}), flush=True)
    check(not out["failed"], f"[multirank] against the unsharded port: "
          f"{out['failed']}")
    return out, beside_out


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
    t_start = time.perf_counter()
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
    serving = {}
    for arch in PATHS:
        launches[arch], serving[arch] = serve_path(torch, np, dev, arch)
        torch.cuda.empty_cache()
    launches["gemma3-1b kv_quant"], serving["gemma3-1b kv_quant"] = \
        kv_quant_path(torch, np, dev)
    torch.cuda.empty_cache()
    print(json.dumps({"serving": serving}))

    # ---- 6b. the full-width cells against the reference's outputs -------
    print(json.dumps({"golden": golden_path(torch, dev, card)}))

    # ---- 7. the Databelt workflow path -----------------------------------
    print(json.dumps({"workflow": workflow_path(torch, dev)}))

    # ---- 8. the front door's last pieces ---------------------------------
    frontdoor, launches["serve_pipeline"] = frontdoor_path(torch, dev, card)
    print(json.dumps({"frontdoor": frontdoor}))

    # ---- 9. the training path --------------------------------------------
    train_by_path, train_out = train_path(torch, np, dev, card)
    launches.update(train_by_path)
    print(json.dumps({"train": train_out}))

    # ---- 10. the distribution layer --------------------------------------
    print(json.dumps({"distributed": distributed_path(torch, np, dev, card)}))

    # ---- 10b. the sharded model ------------------------------------------
    sharded_by_path, sharded = sharded_path(torch, np, dev, card)
    launches.update(sharded_by_path)
    print(json.dumps({"sharded": sharded}))

    # ---- 11. every timed step against its roofline -----------------------
    roofline_path(torch, roofline_steps(serving, train_out), card)

    # ---- 12, 13. the dry-run records, beside the multi-rank cells --------
    multirank_path(card, beside=lambda: dryrun_path(card))

    def path_launches(name):
        by_path = {arch: n.get(name, 0) for arch, n in launches.items()
                   if name in n or name in PATHS.get(arch, ())}
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
    print(f"[wall] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          f"to its last phase on {card}")
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "variant": g["variant"],
        "source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": n_flash, "launches_by_path": flash_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows.values()),
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "library_causal": g["library_causal"],
        "shape": g["shape"], "earlier_design": {
            **g["earlier_design"], "source":
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"},
        **{label: r for label, r in flash_rows.items() if label != "global"},
        "train_shape": train_out["flash_train_shape"],
        "sweep_max_abs_err": flash_sweep,
        "grad_sweep_max_abs_err": {
            k.split(" ", 1)[1]: v for k, v in grad_err.items()
            if k.startswith("flash")},
        "launches_per_train_step": {
            "h2o-danube-1.8b": train_out["h2o-danube-1.8b"][
                "flash_launches_per_step"],
            **{a: r["flash_launches_per_step"]
               for a, r in train_out["train_moe"].items()}},
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
