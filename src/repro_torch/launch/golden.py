"""The port at full width against the reference's own outputs.

    PYTHONPATH=src python -m repro_torch.launch.golden [--device cuda|cpu]
        [--cells gemma3-1b,whisper-small@4x1024 |
         --cells timed|moe|train|train_steps] [--golden PATH]
    PYTHONPATH=src python -m repro_torch.launch.golden --int8-flips PATH

Runs each serving cell through the port's prefill and 8 teacher-forced
decode steps (and, for a cell with an engine record, the f32 serving
engine), each train cell through its train steps and a forward pass after
them, and holds what it computes to the records that
``tests/reference_golden.py`` writes from the JAX reference on the same
weights and inputs.  One line a cell; exit 1 where a cell is out of its
tolerance.  Five files:

* ``tests/golden/full_width.npz``: ``CELLS``, a published config at every
  published width, cut only in depth, and the MoEs in experts; batch 1.
* ``tests/golden/timed.npz``: ``TIMED``, the serving paths ``chip_smoke.py``
  times, at the shape it times them: full width and full depth, batch 4,
  1024 positions (whisper-small: 1024 frames and 256 decoder tokens;
  paligemma-3b: 256 patches and 768 tokens), f32 and bf16: gemma3-1b (past
  its 512 window: the ring cache), recurrentgemma-2b, rwkv6-7b,
  whisper-small, paligemma-3b, and gemma3-1b with the int8 KV cache
  (``options``: ``kv_quant``); and one cell cut in depth,
  ``rwkv6-7b@4x1024@2L`` (``cut``: 2 of 32 layers): with random weights
  rwkv6-7b's stack amplifies a rounding difference about twofold every
  2.5 layers, so that at full depth it is held only to the limits measured
  for it (``TOL_CELL``), and at 2 layers, where the reference's own spread
  under one ulp is under a tenth of rwkv6-7b's 1e-3, to the standard ones.
  Each arch also has an f32 engine record (``ENGINE``: ``chip_smoke.py``'s
  own serving engine, 4 slots, ``max_len`` 128, 4 requests of 3-8 prompt
  tokens from ``engine_prompts``, 8 new tokens each).  Every position is
  kept.
* ``tests/golden/timed_moe.npz``: ``MOE_TIMED``, the MoE serving paths at
  their timed shape and depth (4 x 1024; qwen3-moe-235b-a22b at 8 layers,
  arctic-480b at 2), f32, no engine record, their experts cut as
  ``CELLS`` cuts them (``cut``: 16 and 8 of 128; all 128 hold ~20 B and
  ~27 B values, past what the reference holds on a 62 GB host).
* ``tests/golden/train.npz``: ``TRAIN``, the train steps ``chip_smoke.py``
  times, at their shape and depth: h2o-danube-1.8b (24 layers, 4 x 2048),
  recurrentgemma-2b and rwkv6-7b at one superblock (``cut``: 3 and 1
  layers), whisper-small (1024 frames, 256 tokens) and paligemma-3b (256
  patches, 768 tokens) at full depth, each 4 x 1024, AdamW, f32 and bf16;
  qwen3-moe-235b-a22b at 4 layers and arctic-480b at 1, Adafactor, f32,
  their experts cut (16 and 8 of 128); and ``REGENERATED_TRAIN``
  (whisper-small at 1 + 1 layers, 4 x 256), which the CPU test writes
  again through the reference.  Each record is one step of the config's
  optimizer at ``LR`` on batch 0 (``train_batch``: ``SyntheticTokens``'
  for h2o-danube-1.8b and the recurrent pair, else numpy draws of
  ``TRAIN_INPUT_SEED``, the arch's name and the step; the file keeps a
  synthetic cell's tokens): its loss, aux and
  grad norm; each parameter's grad as the update takes it (clipped to
  the global norm ``MAX_GRAD_NORM``), its norm and its values at ``K``
  indices (``train_indices``: drawn from ``INDEX_SEED`` and the port's
  parameter name), and its update (new - old; AdamW's f32 master) there;
  and the loss of batch 1 on the updated weights (``SCALARS``).
  ``compare_train`` holds a run to it (``train_tolerance``: each scalar,
  each leaf's grad norm and samples, the update: AdamW's by its sign rule,
  Adafactor's in norm; a bf16 record's limits widened to ``SPREAD`` times
  the reference's own distance from its f32 record); a bf16 run's grads
  also lie from the f32 record within ``DRIFT_RATIO`` of the reference's
  own bf16 (``train_drift``).  rwkv6-7b's records are the reference under
  ``EXACT_BF16`` (``TrainCell.xla_flags``).
* ``tests/golden/train_steps.npz``: ``TRAIN_STEPS``, the cells of ``TRAIN``
  (``steps_name``: "@train" read "@steps") over ``STEPS`` steps from one
  optimizer state carried from step to step, on batches 0, 1 and 2, the
  loss after on batch 3 (``chip_smoke.py`` times steps past the first):
  each step as ``train.npz``'s (whose step 1 it is, bit for bit), and the
  optimizer's state after the last at the same indices (AdamW's m and v;
  Adafactor's ``vr`` and ``vc`` at the sampled indices' rows and columns,
  ``state_indices``, its ``v`` of a leaf of one dim) and its count.
  ``compare_train_steps`` holds step 1 by ``compare_train`` and each later
  step by ``compare_later_step`` (the scalars and grads alike; every
  update in relative norm, AdamW's where the reference's sqrt(v_hat)
  clears ``CLEAR_EPS`` eps, within 2 lr (1 + wd |p|) below it), the state
  by ``compare_state``; a bf16 record's limits widen, and each step's
  drift is held, against the f32 record as above.

The weights are the port's own (``model``): ``init_params`` drawing from a
``BlockDraws`` seeded with ``SEED``, then the leaves the reference
initialises to zeros or ones (``NORMAL``: norms, biases, the rwkv
interpolations) given further draws of ``NORMAL_SCALE``, so that each of
them matters.  The file holds each leaf's f64 sum and sum of squares
(``checksums``), and every consumer checks them before it compares
anything.  The inputs are numpy draws (``inputs``: ``INPUT_SEED`` with
the cell's arch's name, so that the variants of a timed cell share them;
the cells of the files differ in shape): a serving file holds the tokens;
whisper's frames and paligemma's patches are drawn again from the cell's
seed and checked against their sums, as are a train cell's batches.

What is kept of the logits (``summarize``), at every prefill position of
every row and every decode step of every row: their projection onto 16
fixed directions (numpy draws of ``DIRECTIONS_SEED``, N(0, 1) / sqrt(V)),
their logsumexp, their largest magnitude (``size``), their argmax and the
gap between the top two.  A run is held to the file (``compare``) at the
cell's limits (``tolerance``: the dtype's ``TOL`` for each measure of each
part, but where ``TOL_CELL`` sets one): the projections' error in norm
relative to the file's, at most the sketch limit; each logsumexp within
the logsumexp limit times the position's size; the argmax equal wherever
the file's top-two gap exceeds twice the argmax limit times the size.  A
bf16 run also lies from the f32 record within ``DRIFT_RATIO`` times, either
way, of the reference's own bf16 record's distance (``drift``).

The prefill is the one ``serving.steps.build_prefill_step`` runs
(``forward_prefill``), with the logits of every position
(``all_positions``); each decode step is ``forward_decode``, as
``build_decode_step`` runs it, fed the file's next tokens (one a row)
instead of the greedy ones, from the position right after the prompt
(``decode_start``).  The engine record (``EngineRecord``, a wrapper
around the engine's ``_decode``; the engine itself unchanged, driven by its
own ``run_until_done``) keeps, at each call (the prompt feed's and the
steps'), each active slot's call, slot, request, input token and position
beside the summary of its logits; ``compare_engine`` holds each request's
rows up to its first row whose reference gap is within twice the argmax
limit in sizes (the greedy token may then differ, and every later row
with it).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import forward_decode, forward_prefill, init_params
from repro_torch.models.modules import BlockDraws

GOLDEN = Path(__file__).resolve().parents[3] / "tests" / "golden" / \
    "full_width.npz"
TIMED_GOLDEN = GOLDEN.parent / "timed.npz"
MOE_GOLDEN = GOLDEN.parent / "timed_moe.npz"
TRAIN_GOLDEN = GOLDEN.parent / "train.npz"
TRAIN_STEPS_GOLDEN = GOLDEN.parent / "train_steps.npz"
SEED = 0                      # the weights' BlockDraws
DIRECTIONS_SEED = 1           # the 16 directions
INPUT_SEED = 2                # with the arch's name: a cell's inputs
ENGINE_SEED = 4               # with the arch's name: the engine's prompts
TRAIN_INPUT_SEED = 5          # with the arch's name and the step: a batch
INDEX_SEED = 6                # with a parameter's name: its sampled indices
N_DIRECTIONS = 16
DECODE_STEPS = 8
NORMAL_SCALE = 0.3
# the leaves the reference initialises to zeros or ones
NORMAL = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
          "k_norm", "lnx_b", "ba", "bi", "conv_b", "mu_x", "mu", "mu_k",
          "mu_r", "enc_norm", "ln_x"}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
PARTS = ("prefill", "decode", "engine")
MEASURES = ("sketch", "lse", "argmax")
# a cell's limits where they are not its dtype's ``TOL``: one number for
# every measure of every part, or {"<measure>" or "<part>:<measure>":
# limit}; an argmax limit of None leaves the argmax unchecked
TOL_CELL = {
    # rwkv6-7b's chunked wkv in f32 drifts from the sequential form by ~1e-4
    ("rwkv6-7b", "float32"): 1e-3,
    ("rwkv6-7b@4x1024@2L", "float32"): 1e-3,
    # the int8 cache in f32: after the prefill 5205 of its 31.5 M int8
    # values sit one step from the reference's on the CPU, 6768 on the card
    # (none more: the same f32 quantizer, f32 noise across a .5 boundary);
    # the decode steps' projections then lie 3.1e-4 (CPU) and 2.8e-4 (card)
    # from the record, and 2.2e-5 and 3.7e-5 when decoding from the
    # reference's cache instead (``int8_flips``); the prefill, which reads
    # no cache, stays at f32's 2e-4 (it reads 4.1e-6 and 5.3e-6)
    ("gemma3-1b+int8@4x1024", "float32"): {"decode:sketch": 1e-3},
    # rwkv6-7b at full depth: with random weights its stack amplifies a
    # rounding difference about twofold every 2.5 layers (one f32 ulp of
    # the reference's embedding moves it 7.4e-5 at 2 layers, 0.069 at 32:
    # ``tests/reference_golden.py --sensitivity``).  The port lies 0.105
    # (prefill) and 0.124-0.127 (decode) from the record on the CPU and
    # the card, its logsumexp 2.3e-3-2.8e-3 sizes; its argmax differs at
    # 799 of 4096 positions, up to a gap of 0.146 sizes, where the
    # reference's own bf16 run differs from its f32 one at 3868, up to
    # 0.26: no argmax limit holds there (the 2-layer cell holds it).  The
    # engine's rows (short prompts) lie 5.6e-3 (CPU, 79 of 83 rows) and
    # 1.5e-2 (card, all 83) from the record while their tokens agree, their
    # logsumexp 4.8e-5 and 3.4e-4 sizes
    ("rwkv6-7b@4x1024", "float32"): {"sketch": 0.2, "lse": 5e-3,
                                     "argmax": None, "engine:sketch": 2e-2,
                                     "engine:lse": 1e-3},
    # and in bf16 the reference's own bf16 lies 0.744 from its f32, the
    # port 0.696-0.699 (prefill) and 0.648-0.662 (decode) from the
    # reference's bf16 on the CPU and the card (logsumexp within the
    # default 5e-2: 9.0e-3; ``drift`` 0.96-1.00)
    ("rwkv6-7b@4x1024", "bfloat16"): {"sketch": 0.75, "argmax": None},
    # a train cell's: {"scalars", "grad", "update"}
    # (``train_tolerance``).  rwkv6-7b's step at full width: the
    # reference's own chunked wkv lies 3.94e-3 from its exact sequential
    # one at its worst leaf (``tests/reference_golden.py --sensitivity
    # rwkv6-7b@train --layers 1``: exact_vs_reference; median 8.0e-5), one
    # f32 ulp of its embedding moves it 8.6e-4; the port lies 3.92e-3 (CPU)
    # and 3.94e-3 (card) from the chunked record and 8.4e-4 (CPU) and
    # 2.4e-4 (card) from the exact form; its AdamW update 1.9e-3, its grad
    # norm 2.5e-4 (CPU) and 2.3e-4 (card)
    ("rwkv6-7b@train", "float32"): {"scalars": 1e-3, "grad": 1e-2,
                                    "update": 5e-3},
    # qwen3-moe at 4 x 1024: one route of 16384 (layer 2, token 1817) has
    # its 8th and 9th probabilities 2.2e-5 apart (relative), and on the card
    # the f32 hidden states, 3.4e-6 from the CPU's, order them the other way
    # (``python -m repro_torch.launch.golden --routes``); that token's other
    # expert moves every grad leaf 1e-3-7e-3 from the record and Adafactor's
    # update of the experts it feeds up to 2.4e-2; on the CPU, where the
    # routes are the reference's, 6.0e-6 and 6.4e-5
    ("qwen3-moe-235b-a22b@train@16E", "float32"): {"grad": 1e-2,
                                                   "update": 5e-2},
    # a ``TRAIN_STEPS`` cell's: its steps past the first and its state
    # (step 1 keeps its ``TRAIN`` cell's; a tuple: step 2's, step 3's).
    # rwkv6-7b, a record of the reference's exact sequential wkv: after
    # AdamW's first step its loss jumps 11.90 -> 16.90, and from there a
    # difference at step 1 grows 150-200 times by step 2.  One f32 ulp of
    # the reference's embedding, 6.7e-5 at step 1, moves its grads 0.013
    # and 0.059 at steps 2 and 3 (updates 0.022, 0.053; state 0.046); the
    # port's chunked wkv, 8.4e-4 from the exact form at step 1 on the CPU
    # (2.4e-4 on the card), lies 0.118 and 0.205 from it (updates 0.142,
    # 0.136; state 0.161; scalars 1.0e-3, 1.7e-2): ``tests/
    # reference_golden.py --sensitivity rwkv6-7b@steps --layers 1``,
    # "held"; on the card 0.163 and 0.327, state 0.288 (``chip_smoke.py``)
    ("rwkv6-7b@steps", "float32"): {"scalars": (5e-3, 5e-2),
                                    "grad": (0.25, 0.4),
                                    "update": 0.3, "state": 0.3},
    # qwen3-moe: the route the card orders the other way at step 1 (above)
    # moves its expert's grads at step 1 (layer 2's experts, 6.8e-3), and
    # from there every layer at steps 2 and 3 (card: grads 0.031 / 0.072,
    # updates 0.038 / 0.070 at all 256 indices, 0.038 / 0.136 and 0.050 /
    # 0.077 at every second (``THIN``); state 0.040 at ``vc``, scalars
    # 2.8e-4; the CPU, on the reference's routes, 6.0e-6 at step 1, not
    # measured past it)
    # paligemma-3b's AdamW update at step 2 (its step launches no kernel):
    # on the card its grads lie 5.3e-5 from the record and
    # layers.8.mlp.w_up's update 3.5e-4 (2.5e-4 at all 256 indices), its
    # steps 1 and 3 4.0e-5 and 8.3e-5.  The update, a ratio of moments,
    # takes each index's grad error over its sqrt(v_hat): one f32 ulp of
    # the port's embedding moves its own step-2 grads 3.2e-5 and update
    # 7.8e-5 on the card at full depth (``python -m
    # repro_torch.launch.golden --spread``), the reference's 6.2e-6 and
    # 7.1e-6 at 9 layers on the CPU, where the port lies 1.1e-5 and 1.7e-5
    # (``--sensitivity paligemma-3b@steps --layers 9``): a spread of 3.5e-4
    # at that leaf is not shown; the same AdamW holds the later updates of
    # h2o-danube-1.8b, recurrentgemma-2b and whisper-small in f32 within
    # 3.1e-5 on the card
    ("paligemma-3b@steps", "float32"): {"update": 5e-4},
    ("qwen3-moe-235b-a22b@steps@16E", "float32"): {"scalars": 1e-3,
                                                   "grad": 0.15,
                                                   "update": 0.15,
                                                   "state": 0.1},
}
# the ``TRAIN_STEPS`` records whose steps past the first and state are
# read and not held (``judge_train_steps``), with the measured cause
UNHELD = {
    # rwkv6-7b in bf16, from the dynamics of TOL_CELL's f32 entry: one bf16
    # ulp of the reference's embedding moves its own grads 0.58, 1.28 and
    # 1.12 at steps 1-3 (updates 0.71, 0.93, 1.01); the port on the CPU
    # lies 0.0115, 0.48 and 1.11 from it (updates 3.1e-3, 0.44, 0.63; state
    # 0.63): past step 1 no limit under 1, the distance of a zero grad,
    # tells the port from the reference's own spread (``tests/
    # reference_golden.py --sensitivity rwkv6-7b@steps --layers 1 --dtype
    # bfloat16``, "held")
    ("rwkv6-7b@steps", "bfloat16"):
        "past step 1 the reference's own bf16 spread (one ulp of its "
        "embedding: grads 1.28 at step 2) reaches the distance of a zero "
        "grad",
}
# a narrower train record's limits widen to this multiple of the
# reference's own distance from its f32 record (tests/test_torch_train_bf16.py)
SPREAD = 2
# a run in a narrower dtype lies from the f32 record within this factor,
# either way, of the reference's own run in that dtype (``drift``): no
# farther (a fault), and no nearer (a run in a wider dtype)
DRIFT_RATIO = 1.5
CHECKSUM_TOL = 1e-9           # relative; a different draw moves them ~1e-5


@dataclasses.dataclass(frozen=True)
class Cell:
    """``seq``: the prompt's tokens (whisper: its frames, the decoder taking
    seq / dec_len_ratio tokens; paligemma: its patches and tokens together).
    ``cut``: what differs from the published config besides ``param_dtype``
    (``n_layers``, and ``n_experts`` of the MoE).  ``options``: a config
    field the served path sets (``kv_quant``).  ``batch``: the prompts'
    rows; ``engine``: an f32 engine record too."""
    arch: str
    seq: int
    dtypes: tuple
    cut: dict
    options: dict = dataclasses.field(default_factory=dict)
    batch: int = 1
    engine: bool = False


CELLS = {
    "gemma3-1b": Cell("gemma3-1b", 640, ("float32", "bfloat16"),
                      {"n_layers": 6}),
    "h2o-danube-1.8b": Cell("h2o-danube-1.8b", 256, ("float32", "bfloat16"),
                            {"n_layers": 2}),
    "internlm2-20b": Cell("internlm2-20b", 256, ("float32",),
                          {"n_layers": 1}),
    "gemma2-9b": Cell("gemma2-9b", 256, ("float32",), {"n_layers": 2}),
    "recurrentgemma-2b": Cell("recurrentgemma-2b", 256,
                              ("float32", "bfloat16"), {"n_layers": 3}),
    "rwkv6-7b": Cell("rwkv6-7b", 512, ("float32",), {"n_layers": 1}),
    # f32 only: in bf16 a router's near-tie, moved by rounding, picks
    # another expert
    "qwen3-moe-235b-a22b": Cell("qwen3-moe-235b-a22b", 256, ("float32",),
                                {"n_layers": 1, "n_experts": 16}),
    "arctic-480b": Cell("arctic-480b", 256, ("float32",),
                        {"n_layers": 1, "n_experts": 8}),
    "whisper-small": Cell("whisper-small", 1024, ("float32",),
                          {"n_layers": 2}),
    "paligemma-3b": Cell("paligemma-3b", 512, ("float32",), {"n_layers": 1}),
}


def _timed(arch: str, dtypes=("float32", "bfloat16"), options=None,
           engine=True, cut=None) -> Cell:
    return Cell(arch, 1024, dtypes, cut or {}, options or {}, batch=4,
                engine=engine)


# chip_smoke.py's timed serving paths at their shape (its ``B, S``), full
# depth; and rwkv6-7b's cut to 2 layers, where rounding is not yet
# amplified past the standard tolerances (``TOL_CELL``)
TIMED = {
    "gemma3-1b@4x1024": _timed("gemma3-1b"),
    "recurrentgemma-2b@4x1024": _timed("recurrentgemma-2b"),
    "rwkv6-7b@4x1024": _timed("rwkv6-7b"),
    "rwkv6-7b@4x1024@2L": _timed("rwkv6-7b", cut={"n_layers": 2}),
    "whisper-small@4x1024": _timed("whisper-small"),
    "paligemma-3b@4x1024": _timed("paligemma-3b"),
    "gemma3-1b+int8@4x1024": _timed("gemma3-1b", options={"kv_quant": True},
                                    engine=False),
}
INT8_CELL = "gemma3-1b+int8@4x1024"
# the engine of chip_smoke.py's serving paths: 4 requests of 3-8 prompt
# tokens (``engine_prompts``), each answered with 8 new tokens
ENGINE = {"n_slots": 4, "max_len": 128, "requests": 4, "prompt_len": (3, 9),
          "max_new": 8}


# the MoE serving paths at chip_smoke.py's timed shape and depth (8 and 2
# layers, ``DEPTH``), f32, the experts cut as ``CELLS`` cuts them (all 128
# hold ~20 B and ~27 B values, past what the reference holds on a 62 GB
# host); ``tests/golden/timed_moe.npz``
MOE_TIMED = {
    "qwen3-moe-235b-a22b@4x1024@16E": _timed(
        "qwen3-moe-235b-a22b", ("float32",), engine=False,
        cut={"n_layers": 8, "n_experts": 16}),
    "arctic-480b@4x1024@8E": _timed("arctic-480b", ("float32",), engine=False,
                                    cut={"n_layers": 2, "n_experts": 8}),
}


@dataclasses.dataclass(frozen=True)
class TrainCell:
    """A train step's cell: ``seq`` positions a row as ``Cell``'s, ``cut``
    what differs from the published config besides ``param_dtype``;
    ``synthetic``: its batches are ``SyntheticTokens(cfg, batch, seq,
    seed=SEED)``'s (else ``train_batch``'s numpy draws); ``xla_flags``:
    the reference's XLA flags for its records (``tests/reference_golden.py``
    sets them in a process of the cell's own); ``seq_exact``: its records
    are of the reference's exact sequential wkv, not of its chunked one."""
    arch: str
    seq: int
    dtypes: tuple
    cut: dict
    batch: int = 4
    synthetic: bool = False
    options: dict = dataclasses.field(default_factory=dict)
    xla_flags: str = ""
    seq_exact: bool = False


F32_BF16 = ("float32", "bfloat16")
# XLA rounds a bf16 program's every op to bf16, as PyTorch does, where by
# default it may keep an intermediate wider: rwkv6-7b's backward, through
# the group norm of heads of small spread, then lies up to 1.72 (a leaf's
# samples; its norms 20% lower, median 0.018) from the same program
# rounded at each op, which the port lies 0.042 (median 0.011) from on the
# card (its f32 program is the same either way)
EXACT_BF16 = "--xla_allow_excess_precision=false"
# the train steps chip_smoke.py times, at their shape and depth (the
# recurrent archs at one superblock), the MoEs with their experts cut as
# ``CELLS`` cuts them and f32 only (in bf16 a router's near-tie, moved by
# rounding, picks another expert); and one small cell that the CPU test
# writes again through the reference (``REGENERATED_TRAIN``)
TRAIN = {
    "h2o-danube-1.8b@train": TrainCell("h2o-danube-1.8b", 2048, F32_BF16, {},
                                       synthetic=True),
    "recurrentgemma-2b@train": TrainCell("recurrentgemma-2b", 1024, F32_BF16,
                                         {"n_layers": 3}, synthetic=True),
    "rwkv6-7b@train": TrainCell("rwkv6-7b", 1024, F32_BF16, {"n_layers": 1},
                                synthetic=True, xla_flags=EXACT_BF16),
    "whisper-small@train": TrainCell("whisper-small", 1024, F32_BF16, {}),
    "paligemma-3b@train": TrainCell("paligemma-3b", 1024, F32_BF16, {}),
    "qwen3-moe-235b-a22b@train@16E": TrainCell(
        "qwen3-moe-235b-a22b", 1024, ("float32",),
        {"n_layers": 4, "n_experts": 16}),
    "arctic-480b@train@8E": TrainCell("arctic-480b", 1024, ("float32",),
                                      {"n_layers": 1, "n_experts": 8}),
    "whisper-small@train@1+1L": TrainCell(
        "whisper-small", 256, ("float32",),
        {"n_layers": 1, "n_enc_layers": 1}),
}
REGENERATED_TRAIN = "whisper-small@train@1+1L"


def steps_name(name: str) -> str:
    """The ``TRAIN_STEPS`` cell of the ``TRAIN`` cell ``name``."""
    return name.replace("@train", "@steps", 1)


def train_name(name: str) -> str:
    """The ``TRAIN`` cell of the ``TRAIN_STEPS`` cell ``name``."""
    return name.replace("@steps", "@train", 1)


# the same cells over ``STEPS`` steps from one carried optimizer state
# (``tests/golden/train_steps.npz``)
STEPS = 3
TRAIN_STEPS = {steps_name(n): c for n, c in TRAIN.items()}
# paligemma-3b's in f32 alone: the reference's bf16 run carrying its f32
# master, m and v (~30 GB) was killed past this 62 GB host in step 2 (65
# GB, in a process of its own); its bf16 step 1 stays ``train.npz``'s
TRAIN_STEPS["paligemma-3b@steps"] = dataclasses.replace(
    TRAIN["paligemma-3b@train"], dtypes=("float32",))
# rwkv6-7b's of the reference's exact sequential wkv: its loss jumps 11.90
# -> 16.90 after AdamW's first step, and from there its chunked wkv, 3.94e-3
# from the exact form at step 1, lies 0.57 and 1.25 from it at steps 2 and 3
# (``tests/reference_golden.py --sensitivity rwkv6-7b@steps``), farther
# than the port does (0.076 and 0.19): a record of it holds no port
TRAIN_STEPS["rwkv6-7b@steps"] = dataclasses.replace(
    TRAIN["rwkv6-7b@train"], seq_exact=True)
REGENERATED_STEPS = steps_name(REGENERATED_TRAIN)


# each table with the file of its records
FILES = ((CELLS, GOLDEN), (TIMED, TIMED_GOLDEN), (MOE_TIMED, MOE_GOLDEN),
         (TRAIN, TRAIN_GOLDEN), (TRAIN_STEPS, TRAIN_STEPS_GOLDEN))


def table_of(name: str) -> dict:
    for table, _ in FILES:
        if name in table:
            return table
    raise KeyError(name)


def cell(name: str):
    return table_of(name)[name]


def timed_name(arch: str, kv_quant: bool = False) -> str:
    """The ``TIMED`` cell of a serving path (full depth)."""
    return f"{arch}{'+int8' if kv_quant else ''}@4x1024"


def cut_cells(name: str) -> list:
    """The ``TIMED`` cells of the timed cell ``name``'s arch and options cut
    in depth (built apart from the timed model)."""
    c = TIMED[name]
    return [n for n, d in TIMED.items()
            if d.cut and (d.arch, d.options) == (c.arch, c.options)]


def runs(cells=None) -> list:
    """Every (cell, dtype) of ``cells`` (default: ``CELLS``, the full-width
    file's), in its order."""
    cells = CELLS if cells is None else cells
    return [(name, dt) for name, c in cells.items() for dt in c.dtypes]


def file_of(name: str) -> Path:
    return next(f for t, f in FILES if t is table_of(name))


def tolerance(name: str, dtype: str) -> dict:
    """The cell's limits in ``dtype``: {part: {measure: limit}}
    (``TOL_CELL`` where it sets them, else ``TOL[dtype]``)."""
    return limits(TOL_CELL.get((name, dtype), TOL[dtype]), TOL[dtype])


def limits(tol, default=None) -> dict:
    """{part: {measure: limit}} of ``tol``: one number for all, or
    ``TOL_CELL``'s form, ``default`` where it sets none."""
    if not isinstance(tol, dict):
        return {p: dict.fromkeys(MEASURES, tol) for p in PARTS}
    return {p: {m: tol.get(f"{p}:{m}", tol.get(m, default))
                for m in MEASURES} for p in PARTS}


def cell_config(name: str, dtype: str, configs=get_config):
    """The cell's config from ``configs`` (the port's ``get_config``, or the
    reference's, which has the same fields)."""
    c = cell(name)
    cut = dict(c.cut)
    cfg = configs(c.arch)
    if "n_experts" in cut:
        cut["moe"] = dataclasses.replace(cfg.moe, n_experts=cut.pop(
            "n_experts"))
    return dataclasses.replace(cfg, param_dtype=dtype, **cut, **c.options)


def model(cfg, seed: int = SEED, device="cpu"):
    """The port's model of ``cfg`` from a ``BlockDraws`` of ``seed``, the
    ``NORMAL`` leaves given further draws of the same source."""
    draws = BlockDraws(seed)
    m = init_params(cfg, draws, device=device)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.rpartition(".")[2] in NORMAL:
                p.add_(draws.normal(tuple(p.shape), NORMAL_SCALE, p.dtype,
                                    p.device))
    return m


def cast(m, cfg):
    """``model(cfg)`` from ``m``, the same cell's model in another dtype:
    each leaf cast to its dtype under ``cfg`` (a ``BlockDraws`` draws in
    f32 and casts, so the values are those ``model`` would draw)."""
    shell = init_params(cfg, None, device="meta")
    shell.load_state_dict({n: p.detach().to(q.dtype) for (n, p), (_, q) in
                           zip(m.named_parameters(),
                               shell.named_parameters())}, assign=True)
    return shell


def _host_sums(c: torch.Tensor) -> tuple:
    a = c.float().numpy()
    return (float(np.add.reduce(a, dtype=np.float64)),
            float(np.einsum("i,i->", a, a, dtype=np.float64)))


def _device_sums(c: torch.Tensor) -> tuple:
    c = c.double()
    return float(c.sum()), float(torch.dot(c, c))


def checksums(m) -> tuple[list, np.ndarray]:
    """(names, (n, 2) f64 array): each parameter's f64 sum and sum of
    squares, in ``named_parameters`` order, summed in chunks (on the host,
    by numpy on a thread pool)."""
    names, sums = [], []
    with torch.no_grad(), ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for n, p in m.named_parameters():
            flat = p.detach().reshape(-1)
            if flat.device.type == "cpu":
                parts = list(pool.map(_host_sums, flat.split(1 << 20)))
            else:
                parts = [_device_sums(c) for c in flat.split(1 << 24)]
            names.append(n)
            sums.append(tuple(map(sum, zip(*parts))))
    return names, np.asarray(sums, np.float64).reshape(-1, 2)


def checksum_mismatches(names, sums, want_names, want_sums,
                        sizes) -> list:
    """The leaves whose checksums differ from the file's beyond summation
    order (``CHECKSUM_TOL``); ``sizes``: each leaf's element count."""
    if list(names) != list(want_names):
        return [f"leaves {list(names)} != the file's {list(want_names)}"]
    bad = []
    for n, (s, q), (ws, wq), size in zip(names, sums, want_sums, sizes):
        scale = math.sqrt(max(size * wq, 1e-300))
        if abs(s - ws) > CHECKSUM_TOL * scale or \
                abs(q - wq) > CHECKSUM_TOL * max(wq, 1e-300):
            bad.append(f"{n}: sum {s!r} / {ws!r}, squares {q!r} / {wq!r}")
    return bad


def inputs(name: str, cfg) -> dict:
    """The cell's numpy inputs: ``tokens`` (B, n) int32, ``decode`` (8, B)
    int32 ((8,) at batch 1), and whisper's ``frames`` (B, seq, D) or
    paligemma's ``patches`` (B, P, D), f32; with an engine record, its
    ``prompts`` (``engine_prompts``)."""
    c = cell(name)
    rng = np.random.default_rng([INPUT_SEED, zlib.crc32(c.arch.encode())])
    seq, b = c.seq, c.batch
    out = {}
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal((b, seq, cfg.d_model),
                                            dtype=np.float32)
        n = seq // cfg.dec_len_ratio
    elif cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model), dtype=np.float32)
        n = seq - cfg.n_prefix_tokens
    else:
        n = seq
    out["tokens"] = rng.integers(0, cfg.vocab_size, (b, n), dtype=np.int32)
    out["decode"] = rng.integers(0, cfg.vocab_size, DECODE_STEPS if b == 1
                                 else (DECODE_STEPS, b), dtype=np.int32)
    if c.engine:
        out["prompts"] = engine_prompts(c.arch, cfg)
    return out


def engine_prompts(arch: str, cfg) -> list:
    """The engine's requests' prompts, drawn as ``chip_smoke.py`` drew them
    (lengths in ``ENGINE["prompt_len"]``, tokens from 2), from
    ``ENGINE_SEED`` and the arch's name."""
    rng = np.random.default_rng([ENGINE_SEED, zlib.crc32(arch.encode())])
    lo, hi = ENGINE["prompt_len"]
    return [rng.integers(2, cfg.vocab_size, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(ENGINE["requests"])]


def batch_of(inp: dict, device) -> dict:
    """The numpy inputs a prefill takes, as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in inp.items()
            if k not in ("decode", "prompts")}


def decode_start(cfg, inp: dict) -> int:
    """The position right after the prompt of ``inp`` (numpy inputs or a
    batch of tensors): the length of the prefill's self-attention cache."""
    n = inp["tokens"].shape[1]
    return n + cfg.n_prefix_tokens if cfg.frontend == "vision" else n


@functools.lru_cache(maxsize=2)
def directions(vocab: int) -> np.ndarray:
    """(V, 16) f32: N(0, 1) / sqrt(V), the same for every cell of a vocab
    (read-only)."""
    rng = np.random.default_rng(DIRECTIONS_SEED)
    d = rng.standard_normal((vocab, N_DIRECTIONS)) / math.sqrt(vocab)
    d = d.astype(np.float32)
    d.flags.writeable = False
    return d


def summarize(logits: torch.Tensor, dirs: torch.Tensor,
              rows: int = 64) -> dict:
    """logits (n, V) -> numpy {sketch (n, 16), lse, size, argmax, gap (n,)};
    ``dirs``: ``directions`` on the logits' device.  ``rows`` positions at
    a time, in f32 with the exponentials summed in f64; ``size`` is the
    largest |logit| (the logsumexp of a row is its largest logits'
    business, and rounds with them)."""
    parts = []
    for c in logits.split(rows):
        x = c.float()
        top = torch.topk(x, 2, dim=-1)
        m = top.values[:, :1]
        parts.append({
            "sketch": (x @ dirs).double(),
            "lse": m[:, 0].double() + torch.log(
                torch.exp(x - m).sum(dim=-1, dtype=torch.float64)),
            "size": x.abs().amax(dim=-1),
            "argmax": top.indices[:, 0].to(torch.int32),
            "gap": top.values[:, 0] - top.values[:, 1]})
    return {k: torch.cat([p[k] for p in parts]).cpu().numpy()
            for k in parts[0]}


def concat(summaries: list) -> dict:
    return {k: np.concatenate([s[k] for s in summaries])
            for k in summaries[0]}


def run(m, cfg, inp: dict, device) -> dict:
    """The port's prefill and decode steps on ``inp``: {"prefill": summary
    of the (B n) positions, row by row, "decode": summary of the (8 B)
    steps, step by step}; with ``inp["prompts"]``, also "engine"
    (``run_engine``)."""
    dev = torch.device(device)
    dirs = torch.tensor(directions(cfg.vocab_size), device=dev)
    with torch.no_grad():
        logits, cache = forward_prefill(m, cfg, batch_of(inp, dev),
                                        all_positions=True)
        prefill = summarize(logits.flatten(0, 1), dirs)
        del logits
        start, steps = decode_start(cfg, inp), []
        for i, t in enumerate(inp["decode"]):
            tok = torch.from_numpy(np.asarray(t, np.int32).reshape(-1, 1))
            logits, cache = forward_decode(m, cfg, cache, tok.to(dev),
                                           start + i)
            steps.append(summarize(logits[:, 0], dirs))
        del cache
    out = {"prefill": prefill, "decode": concat(steps)}
    if "prompts" in inp:
        out["engine"] = run_engine(m, cfg, inp["prompts"], dev)
    return out


def _part_errors(g: dict, w: dict, lim: dict) -> dict:
    """One part's errors against its ``lim`` ({measure: limit})."""
    sk = float(np.linalg.norm(g["sketch"] - w["sketch"]) /
               np.linalg.norm(w["sketch"]))
    lse = float(np.max(np.abs(g["lse"] - w["lse"]) / w["size"]))
    clear = _clear(w, lim)
    flips = int(np.sum(clear & (g["argmax"] != w["argmax"])))
    return {"sketch_rel": sk, "lse_in_sizes": lse, "argmax_differs": flips,
            "argmax_checked": int(clear.sum()),
            "ok": sk <= lim["sketch"] and lse <= lim["lse"] and flips == 0}


def _clear(w: dict, lim: dict) -> np.ndarray:
    """Where the file's top-two gap exceeds twice the argmax limit in
    sizes (nowhere if the argmax is unchecked)."""
    if lim["argmax"] is None:
        return np.zeros(len(w["gap"]), bool)
    return w["gap"] > 2 * lim["argmax"] * w["size"]


def compare(got: dict, want: dict, tol) -> dict:
    """Errors of ``got`` against ``want`` (the file's), each part at its
    limits (``tol``: one number, or ``tolerance``'s): the projections'
    relative error in norm, the largest logsumexp error in units of the
    position's size, the argmax mismatches where the gap exceeds twice the
    argmax limit in sizes (and how many positions had such a gap); the
    engine's by ``compare_engine`` where the file has one; ``ok``."""
    lim = tol if isinstance(tol, dict) else limits(tol)
    out, ok = {}, True
    for part in ("prefill", "decode"):
        e = _part_errors(got[part], want[part], lim[part])
        ok &= e.pop("ok")
        out[part] = e
    if "engine" in want:
        out["engine"] = compare_engine(got["engine"], want["engine"],
                                       lim["engine"])
        ok &= out["engine"]["ok"]
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# the engine record
# ---------------------------------------------------------------------------
ROW = ("call", "slot", "request", "token_in", "pos")


def _numpy_of(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class EngineRecord:
    """Wraps an engine's ``_decode`` (the port's method or the reference's
    jitted function: an attribute of the engine either way, replaced on
    the instance) and keeps, at every call the engine makes (its prompt
    feed and its steps), each active slot's ``ROW`` and ``summarize`` of
    its last logits (``dirs`` on the logits' device; the reference's
    logits come to the host in f32)."""

    def __init__(self, eng, dirs):
        self.eng, self.dirs, self.inner = eng, dirs, eng._decode
        self.rows, self.parts = [], []
        eng._decode = self

    def __call__(self, params, cache, tok, pos):
        logits, cache = self.inner(params, cache, tok, pos)
        active = [i for i, r in enumerate(self.eng.slots) if r is not None]
        x = logits[:, -1]
        x = x.float() if torch.is_tensor(x) else torch.from_numpy(
            np.asarray(x).astype(np.float32))
        toks = _numpy_of(tok).reshape(-1)
        p = int(_numpy_of(pos))
        for i in active:
            self.rows.append((len(self.parts), i, self.eng.slots[i].req_id,
                              int(toks[i]), p))
        self.parts.append(summarize(x[active], self.dirs))
        return logits, cache

    def record(self) -> dict:
        return {"rows": np.asarray(self.rows, np.int32).reshape(-1, len(ROW)),
                **concat(self.parts)}


def submit(eng, request_type, prompts: list):
    """The engine's requests: one a prompt, ``ENGINE["max_new"]`` new
    tokens each (``request_type``: the engine's own ``Request``)."""
    for i, p in enumerate(prompts):
        eng.submit(request_type(i, p, max_new=ENGINE["max_new"]))


def run_engine(m, cfg, prompts: list, device) -> dict:
    """The port's serving engine (``ENGINE``) on ``m`` answering
    ``prompts`` (its own ``run_until_done``): ``EngineRecord.record``.  The
    engine's cache is put in the weights' dtype (both engines make it
    bf16, and the reference's refuses f32 weights beside it)."""
    from repro_torch.models import init_cache
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, m, n_slots=ENGINE["n_slots"],
                        max_len=ENGINE["max_len"], device=device)
    eng.cache = init_cache(cfg, ENGINE["n_slots"], ENGINE["max_len"],
                           dtype=getattr(torch, cfg.param_dtype),
                           device=eng.device)
    rec = EngineRecord(eng, torch.tensor(directions(cfg.vocab_size),
                                         device=eng.device))
    submit(eng, Request, prompts)
    with torch.no_grad():
        eng.run_until_done()
    return rec.record()


def compare_engine(got: dict, want: dict, tol) -> dict:
    """Each request's rows in ``got`` against the file's, up to its first
    row whose reference gap is within twice the argmax limit in sizes (that
    row included, its argmax not checked): the rows' call, slot, input
    token and position equal, the argmax equal at every clear row, and the
    projections and logsumexps of the rows checked as in ``compare``
    (``tol``: one number or {measure: limit}).  With the argmax unchecked
    no near-tie can be named, and each request's rows are held as far as
    they agree with the file's (the greedy tokens fed back were the
    same).  ``steps_checked`` of the ``steps`` (rows) the file has."""
    lim = tol if isinstance(tol, dict) else dict.fromkeys(MEASURES, tol)
    gr, wr = got["rows"], want["rows"]
    keep_g, keep_w, differ = [], [], 0
    for req in np.unique(wr[:, 2]):
        wi = np.flatnonzero(wr[:, 2] == req)
        gi = np.flatnonzero(gr[:, 2] == req)
        if lim["argmax"] is None:
            m = min(len(wi), len(gi))
            agree = (gr[gi[:m]] == wr[wi[:m]]).all(axis=1)
            n = m if agree.all() else int(np.argmin(agree))
            keep_g += list(gi[:n])
            keep_w += list(wi[:n])
            continue
        clear = _clear({k: want[k][wi] for k in ("gap", "size")}, lim)
        n = len(wi) if clear.all() else int(np.argmin(clear)) + 1
        if len(gi) < n:
            differ += n - len(gi)
            n = len(gi)
        differ += int((gr[gi[:n]] != wr[wi[:n]]).any(axis=1).sum())
        keep_g += list(gi[:n])
        keep_w += list(wi[:n])
    if not keep_w:
        return {"steps_checked": 0, "steps": len(wr), "rows_differ": differ,
                "ok": False}
    e = _part_errors({k: got[k][keep_g] for k in STORED},
                     {k: want[k][keep_w] for k in STORED}, lim)
    e.update(rows_differ=differ, steps_checked=len(keep_w), steps=len(wr))
    e["ok"] = bool(e["ok"] and differ == 0)
    return e


# ---------------------------------------------------------------------------
# the file: "<cell>/<dtype>/<part>/<key>" summaries (part: prefill, decode,
# and engine with its "rows"), "<cell>/<dtype>/checksums" and "/names",
# "<cell>/tokens", "/decode", "/input_sums", "/prompts" and "/prompt_lens"
# (an engine's), "<cell>/cut", "<cell>/options" (a timed cell's), "meta"
# ---------------------------------------------------------------------------
STORED = {"sketch": np.float32, "lse": np.float64, "size": np.float32,
          "argmax": np.int32, "gap": np.float32}


def array_sums(a: np.ndarray) -> np.ndarray:
    """f64 sum and sum of squares of a numpy draw."""
    a = a.astype(np.float64)
    return np.array([a.sum(), (a * a).sum()])


def input_sums(inp: dict) -> np.ndarray:
    """``array_sums`` of the frames or patches (zeros if none)."""
    x = next((inp[k] for k in ("frames", "patches") if k in inp), None)
    return np.zeros(2) if x is None else array_sums(x)


def _json(d: dict) -> np.ndarray:
    return np.array(json.dumps(d, sort_keys=True))


def pack(records: dict, meta: dict) -> dict:
    """records: {(cell, dtype): {"names", "sums", "inputs", "prefill",
    "decode"[, "engine"]}} -> the file's arrays."""
    arrays = {"meta": _json(meta)}
    for (name, dt), r in records.items():
        inp = r["inputs"]
        arrays[f"{name}/tokens"] = inp["tokens"]
        arrays[f"{name}/decode"] = inp["decode"]
        arrays[f"{name}/input_sums"] = input_sums(inp)
        arrays[f"{name}/cut"] = _json(cell(name).cut)
        if name not in CELLS:
            arrays[f"{name}/options"] = _json(cell(name).options)
        if "prompts" in inp:
            arrays[f"{name}/prompts"] = np.concatenate(inp["prompts"])
            arrays[f"{name}/prompt_lens"] = np.array(
                [len(p) for p in inp["prompts"]], np.int32)
        arrays[f"{name}/{dt}/names"] = np.array(r["names"])
        arrays[f"{name}/{dt}/checksums"] = r["sums"]
        for part in ("prefill", "decode", "engine"):
            if part not in r:
                continue
            for k, kind in STORED.items():
                arrays[f"{name}/{dt}/{part}/{k}"] = \
                    np.asarray(r[part][k]).astype(kind)
        if "engine" in r:
            arrays[f"{name}/{dt}/engine/rows"] = r["engine"]["rows"]
    return arrays


def load(path=GOLDEN) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def stored(golden: dict, name: str, dtype: str) -> dict:
    """One run's records in the file: names, sums, and each part's
    summaries (f64; the engine's rows too)."""
    r = {"names": [str(n) for n in golden[f"{name}/{dtype}/names"]],
         "sums": golden[f"{name}/{dtype}/checksums"]}
    for part in ("prefill", "decode", "engine"):
        if f"{name}/{dtype}/{part}/sketch" not in golden:
            continue
        r[part] = {k: golden[f"{name}/{dtype}/{part}/{k}"].astype(
            np.int64 if k == "argmax" else np.float64) for k in STORED}
    if "engine" in r:
        r["engine"]["rows"] = golden[f"{name}/{dtype}/engine/rows"]
    return r


def check_inputs(golden: dict, name: str, inp: dict):
    """The cell's inputs as drawn here against the file's, and the
    directions' draw against the file's sums."""
    for k in ("tokens", "decode"):
        if not np.array_equal(inp[k], golden[f"{name}/{k}"]):
            raise ValueError(f"{name}: {k} drawn here differ from the file's")
    if "prompts" in inp and not (
            np.array_equal(np.concatenate(inp["prompts"]),
                           golden[f"{name}/prompts"]) and
            [len(p) for p in inp["prompts"]] ==
            golden[f"{name}/prompt_lens"].tolist()):
        raise ValueError(f"{name}: the engine's prompts drawn here differ "
                         f"from the file's")
    want = golden[f"{name}/input_sums"]
    if not np.allclose(input_sums(inp), want, rtol=1e-12, atol=1e-9):
        raise ValueError(f"{name}: frames or patches drawn here sum to "
                         f"{input_sums(inp)}, the file's to {want}")
    c = cell(name)
    for k in ("cut", "options"):           # the full-width file has no options
        key = f"{name}/{k}"
        there = json.loads(str(golden[key])) if key in golden else {}
        if there != getattr(c, k):
            raise ValueError(f"{name}: the file's {k} {there}, here "
                             f"{getattr(c, k)}")


def check_directions(golden: dict, vocab: int):
    meta = json.loads(str(golden["meta"]))
    got = array_sums(directions(vocab))
    want = meta["directions"][str(vocab)]
    if not np.allclose(got, want, rtol=1e-12, atol=1e-9):
        raise ValueError(f"directions of vocab {vocab} sum to {got}, the "
                         f"file's to {want}: numpy draws otherwise here")


def check_weights(m, name: str, dtype: str, want: dict):
    """Raises where ``m``'s checksums are not the file's (``want``:
    ``stored``)."""
    names, sums = checksums(m)
    sizes = [p.numel() for p in m.parameters()]
    bad = checksum_mismatches(names, sums, want["names"], want["sums"], sizes)
    if bad:
        raise ValueError(f"{name} {dtype}: the weights differ from the "
                         f"file's: " + "; ".join(bad[:5]))


def run_cell(name: str, dtype: str, device, golden: dict, m=None) -> dict:
    """Build the cell's weights on ``device`` (or take ``m``, built
    already), check their checksums and the inputs against the file, run
    the port and compare.  Raises on a weight or input mismatch; returns
    {"errors": compare(...), "tol", "weights_s", "run_s"}."""
    cfg = cell_config(name, dtype)
    inp = inputs(name, cfg)
    check_inputs(golden, name, inp)
    check_directions(golden, cfg.vocab_size)
    want = stored(golden, name, dtype)
    if "engine" not in want:
        inp.pop("prompts", None)
    t0 = time.perf_counter()  # repro: allow(DB001): the report's wall time
    if m is None:
        m = model(cfg, SEED, device)
    check_weights(m, name, dtype, want)
    t1 = time.perf_counter()  # repro: allow(DB001): as above
    got = run(m, cfg, inp, device)
    del m
    t2 = time.perf_counter()  # repro: allow(DB001): as above
    tol = tolerance(name, dtype)
    out = {"errors": compare(got, want, tol), "tol": tol,
           "weights_s": t1 - t0, "run_s": t2 - t1}
    if dtype != "float32" and f"{name}/float32/names" in golden:
        out["drift"] = d = drift(got, want, stored(golden, name, "float32"))
        out["errors"]["ok"] &= 1 / DRIFT_RATIO <= d["ratio"] <= DRIFT_RATIO
    return out


def drift(got: dict, want: dict, f32: dict) -> dict:
    """How far a run in a narrower dtype (``got``) and the file's record in
    it (``want``) each lie from the file's f32 record of the same cell:
    the projections' relative error in norm a part, and their ratio (port
    over reference; of the part where it lies farthest from 1), which
    ``run_cell`` holds within ``DRIFT_RATIO`` of 1:
    the port's error is then the dtype's rounding, neither a fault nor a
    wider dtype."""
    out = {"port_vs_f32": {}, "reference_vs_f32": {}}
    lim = dict.fromkeys(MEASURES, 1.0)
    for part in ("prefill", "decode"):
        out["port_vs_f32"][part] = _part_errors(got[part], f32[part],
                                                lim)["sketch_rel"]
        out["reference_vs_f32"][part] = _part_errors(want[part], f32[part],
                                                     lim)["sketch_rel"]
    out["ratio"] = max((out["port_vs_f32"][p] / out["reference_vs_f32"][p]
                        for p in ("prefill", "decode")),
                       key=lambda r: abs(math.log(r)))
    return out


def int8_flips(path, device, golden: dict) -> dict:
    """Where the int8 cell's f32 decode error comes from: its prefill's
    int8 cache on ``device`` against the reference's (``path``, written by
    ``tests/reference_golden.py --int8-cache``), the entries that differ
    (and by more than one step), the scales' largest relative difference;
    then its 8 decode steps against the file's from its own cache and
    from the reference's (int8 values and scales put in its place)."""
    name = INT8_CELL
    dev = torch.device(device)
    cfg = cell_config(name, "float32")
    inp = inputs(name, cfg)
    check_inputs(golden, name, inp)
    want = stored(golden, name, "float32")
    m = model(cfg, SEED, dev)
    check_weights(m, name, "float32", want)
    dirs = torch.tensor(directions(cfg.vocab_size), device=dev)
    with np.load(path) as f:
        theirs = {k: f[k] for k in f.files}
    with torch.no_grad():
        _, cache = forward_prefill(m, cfg, batch_of(inp, dev))
        total = differ = big = 0
        scale = 0.0
        swapped = {"blocks": [], "tail": []}
        for group in ("blocks", "tail"):
            for i, leaves in enumerate(cache[group]):
                swapped[group].append({})
                for leaf, t in leaves.items():
                    r = torch.from_numpy(theirs[f"{group}/{i}/{leaf}"]).to(dev)
                    if r.shape != t.shape or r.dtype != t.dtype:
                        raise ValueError(f"{group}/{i}/{leaf}: {r.shape} "
                                         f"{r.dtype} there, {t.shape} "
                                         f"{t.dtype} here")
                    swapped[group][i][leaf] = r
                    if t.dtype == torch.int8:
                        d = (t.int() - r.int()).abs()
                        total += d.numel()
                        differ += int((d > 0).sum())
                        big += int((d > 1).sum())
                    else:
                        scale = max(scale, float(((t - r).abs() / r.abs()
                                                  .clamp_min(1e-30)).max()))
        swapped = {k: tuple(v) for k, v in swapped.items()}
        lim = dict.fromkeys(MEASURES, 1.0)
        out = {"int8_entries": total, "differ": differ,
               "differ_by_more_than_one": big, "scales_rel": scale}
        for label, c in (("own_cache", cache), ("reference_cache", swapped)):
            start, steps = decode_start(cfg, inp), []
            for i, t in enumerate(inp["decode"]):
                tok = torch.from_numpy(np.asarray(t, np.int32).reshape(-1, 1))
                logits, c = forward_decode(m, cfg, c, tok.to(dev), start + i)
                steps.append(summarize(logits[:, 0], dirs))
            e = _part_errors(concat(steps), want["decode"], lim)
            out[f"decode_from_{label}"] = {k: e[k] for k in (
                "sketch_rel", "lse_in_sizes")}
    return out


# ---------------------------------------------------------------------------
# the train records (``TRAIN``, ``tests/golden/train.npz``):
# "<cell>/<dtype>/names" and "/checksums" (the weights), "/scalars"
# (``SCALARS``, f64), "/grad_norms" (f64, one a parameter), "/grad" and
# "/update" (f32, each parameter's samples one after another);
# "<cell>/input_sums" (each step's batch, its keys sorted), "/numels" and
# "/index_sums" (each parameter's), "<cell>/cut", a synthetic cell's
# "<cell>/tokens" (its two steps'), "meta"
# ---------------------------------------------------------------------------
K = 256                       # sampled elements a parameter (all, below K)
LR = 1e-4                     # chip_smoke.py's LR_TRAIN: a constant rate
WEIGHT_DECAY = 0.1            # AdamW's, in both packages
MAX_GRAD_NORM = 1.0           # both optimizers' clip, in both packages
SCALARS = ("loss", "aux", "grad_norm", "loss_after")
TRAIN_MEASURES = ("scalars", "grad", "update", "state")
# AdamW's first step is lr (g / (|g| + eps) + wd p): about lr sign(g) where
# |g| is well past eps, and linear in g below it
ADAMW_EPS = 1e-8
CLEAR_EPS = 10
# AdamW's first step in bf16 grads: (1 - b1) g and (1 - b2) g^2 round in
# bf16, which moves m / sqrt(v) up to 2^-7 past 1 (tests/test_torch_train.py)
BF16_STEP_SLACK = 2.0 ** -7


def train_batch(name: str, cfg, step: int, golden: dict | None = None
                ) -> dict:
    """The numpy batch of a train cell's ``step`` (0: the step held, 1: the
    forward after its update): ``SyntheticTokens``' where the cell says so
    (the reference's draws, bit for bit), else tokens (and whisper's frames
    or paligemma's patches) drawn from ``TRAIN_INPUT_SEED``, the arch's name
    and the step, labels as ``models.io.make_batch`` makes them.  Given
    the file (``golden``), a synthetic cell's tokens are the file's:
    ``SyntheticTokens`` draws from ``Generator.zipf``, which other numpy
    versions draw otherwise."""
    c = cell(name)
    if c.synthetic:
        if golden is not None:
            tok = golden[f"{name}/tokens"][step]
            return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
        from repro_torch.data import SyntheticTokens
        return SyntheticTokens(cfg, c.batch, c.seq,
                               seed=SEED).batch_for_step(step)
    rng = np.random.default_rng([TRAIN_INPUT_SEED,
                                 zlib.crc32(c.arch.encode()), step])
    b, out, prefix = c.batch, {}, 0
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal((b, c.seq, cfg.d_model),
                                            dtype=np.float32)
        n = c.seq // cfg.dec_len_ratio
    elif cfg.frontend == "vision":
        prefix = cfg.n_prefix_tokens
        out["patches"] = rng.standard_normal((b, prefix, cfg.d_model),
                                             dtype=np.float32)
        n = c.seq - prefix
    else:
        n = c.seq
    tok = rng.integers(0, cfg.vocab_size, (b, n), dtype=np.int32)
    out["tokens"] = tok
    out["labels"] = np.concatenate([np.full((b, prefix), -1, np.int32),
                                    np.roll(tok, -1, axis=1)], axis=1)
    return out


def batch_sums(batch: dict) -> np.ndarray:
    """(keys, 2): ``array_sums`` of each array of a batch, keys sorted."""
    return np.stack([array_sums(batch[k]) for k in sorted(batch)])


def train_indices(pname: str, numel: int) -> np.ndarray:
    """The flat indices sampled of parameter ``pname``: K drawn without
    replacement from ``INDEX_SEED`` and the name, sorted; all below K."""
    if numel <= K:
        return np.arange(numel, dtype=np.int64)
    rng = np.random.default_rng([INDEX_SEED, zlib.crc32(pname.encode())])
    return np.sort(rng.choice(numel, K, replace=False)).astype(np.int64)


def squares(t: torch.Tensor) -> float:
    """The f64 sum of squares of ``t`` (on the host by numpy in chunks on a
    thread pool, on a card in chunks)."""
    flat = t.detach().reshape(-1)
    if flat.device.type != "cpu":
        return sum(_device_sums(c)[1] for c in flat.split(1 << 24))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return sum(s for _, s in pool.map(_host_sums, flat.split(1 << 20)))


def _take(t: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    return t.detach().reshape(-1)[idx].double().cpu().numpy()


class TrainSampler:
    """What a record keeps of one train step of the port on the model of
    ``state`` (``train.steps.init_train_state``'s): built before the step,
    it samples each parameter's f32 base (AdamW's master copy where there
    is one, else the parameter) at its ``train_indices``; ``after`` the
    step, each parameter's grad (its norm and its samples: the grad the
    update took, clipped in place to the global norm ``MAX_GRAD_NORM``),
    the base's change (the update) and the step's metrics; each step past
    the first and the optimizer's state at every ``THIN``-th index
    (``thinned``)."""

    def __init__(self, state: dict):
        self.params = dict(state["params"].named_parameters())
        self.idx = {n: torch.from_numpy(train_indices(n, p.numel())).to(
            p.device) for n, p in self.params.items()}
        self.before = self.base(state)
        self.step = 0

    def base(self, state: dict) -> dict:
        master = state["opt"].get("master")
        return {n: _take(master[n] if master else p, self.idx[n])
                for n, p in self.params.items()}

    def after(self, state: dict, metrics: dict) -> dict:
        """The step's record; the base it leaves is the next step's."""
        now, at = self.base(state), self.step
        grads = {n: p.grad for n, p in self.params.items()}
        rec = {"names": list(self.params),
               "numels": [p.numel() for p in self.params.values()],
               "scalars": {k: float(metrics[k]) for k in SCALARS[:3]},
               "grad_norms": np.sqrt([squares(g) for g in grads.values()]),
               "grad": [thinned(_take(g, self.idx[n]), at, n)
                        for n, g in grads.items()],
               "update": [thinned(now[n] - self.before[n], at, n)
                          for n in self.params],
               "base": [thinned(self.before[n], at, n) for n in self.params]}
        self.before, self.step = now, at + 1
        return rec

    def state(self, state: dict, cfg) -> dict:
        """The optimizer's state at the sampled indices, under the
        reference's names (``thinned``): {"state": AdamW's {"m", "v"} or
        Adafactor's {"vr", "vc", "v"} (``state_indices`` of the
        layer-stacked moments ``st["vs"][leaf]``; None where a leaf has no
        such moment), each a list over the parameters, "count"}."""
        from repro_torch.models.weights import leaf_of
        st, out = state["opt"], {}
        for n, p in self.params.items():
            idx = thinned(self.idx[n], STEPS, n)
            if "m" in st:
                for k in ("m", "v"):
                    out.setdefault(k, []).append(_take(st[k][n], idx))
                continue
            key, r = leaf_of(n, cfg)
            ix = state_indices(tuple(p.shape), idx.cpu().numpy(), r)
            for k in ("vr", "vc", "v"):
                out.setdefault(k, []).append(
                    st["vs"][key][k][tuple(torch.from_numpy(a).to(p.device)
                                           for a in ix[k])].double().cpu(
                                               ).numpy() if k in ix else None)
        return {"state": out, "count": int(st["count"])}


def train_tolerance(name: str, dtype: str) -> dict:
    """{measure of ``TRAIN_MEASURES``: limit}: ``TOL_CELL``'s where it sets
    one (a ``TRAIN_STEPS`` cell's, which hold its steps past the first,
    else its ``TRAIN`` cell's; a tuple: one limit a step past the first,
    ``step_limits``), else ``TOL[dtype]``."""
    tol = TOL_CELL.get((name, dtype), TOL_CELL.get((train_name(name), dtype),
                                                   TOL[dtype]))
    if not isinstance(tol, dict):
        return dict.fromkeys(TRAIN_MEASURES, tol)
    out = {m: tol.get(m, TOL[dtype]) for m in TRAIN_MEASURES}
    out["state"] = tol.get("state", out["grad"])  # the moments of the grads
    return out


def rel(a, b) -> float:
    """||a - b|| / ||b|` (0 where both are 0, inf where only b is)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d, n = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
    return d / n if n else (0.0 if d == 0 else math.inf)


def _worst(errs: dict) -> dict:
    name = max(errs, key=errs.get) if errs else None
    return {"worst": errs.get(name, 0.0), "worst_leaf": name}


def leaf_errors(got: dict, want: dict) -> list:
    """Each parameter's grad error of ``got`` against ``want``: the larger
    of its norm's and its samples' relative error, both records
    ``unclipped`` (the clip's scale is the grad norm scalar's)."""
    norms = [np.asarray(r["grad_norms"]) * clip_scale(r) for r in (got, want)]
    return [max(rel(gn, wn), rel(g, w)) for g, w, gn, wn in
            zip(unclipped(got), unclipped(want), *norms)]


def sign_flips(got: dict, want: dict) -> float:
    """The largest |g| of ``want``'s, in units of its parameter's RMS grad,
    at an index where ``got``'s grad has the other sign."""
    out = 0.0
    for g, w, n, k in zip(got["grad"], want["grad"], want["grad_norms"],
                          want["numels"]):
        flipped = np.sign(g) != np.sign(w)
        if n and flipped.any():
            out = max(out, float(np.max(np.abs(w[flipped]))) /
                      (n / math.sqrt(k)))
    return out


def compare_train(got: dict, want: dict, lim: dict, adamw: bool,
                  dtype: str, f32: dict | None = None) -> dict:
    """Errors of a train record ``got`` against ``want`` (the file's) at
    ``lim`` (``train_tolerance``): each scalar relative to the file's; each
    parameter's grad (``leaf_errors``); its update's samples relative in
    norm (Adafactor, continuous in the grads), or, under AdamW, whose first
    step is about lr sign(g), relative in norm at the indices where the
    file's |g| exceeds "clear" (the grad limit) times the parameter's RMS
    grad and
    its clipped |g| exceeds ``CLEAR_EPS`` times AdamW's eps (below that the
    step is linear in g, g / eps, and a grad error within its limit moves
    it past any relative one), and within 2 lr (1 + wd |p|) elsewhere
    (``p``: ``got``'s base; 2^-7 more in bf16).  Given the file's f32
    record of the cell (``f32``, for a narrower ``want``), the reference's
    own rounding widens the limits as tests/test_torch_train_bf16.py's
    do: a parameter's grad limit is at least ``SPREAD`` times its ``want``
    - ``f32`` error, and "clear" at least ``SPREAD`` times the reference's
    own ``sign_flips`` against its f32 record (``sign_flip_in_rms``:
    ``got``'s against ``want``).  How many parameters and indices each
    measure checked; ``ok``."""
    if got["names"] != want["names"]:
        raise ValueError("the record's parameters are not the file's")
    names = want["names"]
    sc = {k: rel(got["scalars"][k], want["scalars"][k]) for k in SCALARS}
    errs = leaf_errors(got, want)
    own = leaf_errors(want, f32) if f32 else [0.0] * len(names)
    limits = [max(lim["grad"], SPREAD * s) for s in own]
    clear_at = max(lim["grad"], SPREAD * sign_flips(want, f32)) \
        if f32 and adamw else lim["grad"]
    update, held, excess, cleared, n_idx = {}, 0, 0.0, 0, 0
    slack = 1 + (BF16_STEP_SLACK if dtype == "bfloat16" else 0.0)
    want_g = unclipped(want)
    for i, n in enumerate(names):
        gu, wu = got["update"][i], want["update"][i]
        n_idx += len(wu)
        if not adamw:
            update[n] = rel(gu, wu)
            continue
        rms = want["grad_norms"][i] * clip_scale(want) / math.sqrt(
            want["numels"][i])
        clear = (np.abs(want_g[i]) > clear_at * rms) & \
            (np.abs(want["grad"][i]) > CLEAR_EPS * ADAMW_EPS)
        cleared += int(clear.sum())
        if clear.any():
            update[n] = rel(gu[clear], wu[clear])
        if (~clear).any():
            bound = 2 * LR * (1 + WEIGHT_DECAY * np.abs(got["base"][i]))
            excess = max(excess, float(np.max((np.abs(gu - wu) / (
                bound * slack))[~clear])))
            held += int((~clear).sum())
    over = [e / m for e, m in zip(errs, limits)]
    worst = int(np.argmax(over))
    out = {"scalars": sc,
           "grad": {"worst": errs[worst], "worst_leaf": names[worst],
                    "worst_limit": limits[worst], "largest_error":
                    max(errs), "limits_widened": sum(m > lim["grad"]
                                                     for m in limits)},
           "update": _worst(update), "leaves": len(names), "indices": n_idx}
    if adamw:
        out["update"].update(clear=clear_at, indices_cleared=cleared,
                             indices_bounded=held, bound_used=excess,
                             sign_flip_in_rms=sign_flips(got, want))
    out["ok"] = bool(max(sc.values()) <= lim["scalars"] and
                     over[worst] <= 1.0 and
                     out["update"]["worst"] <= lim["update"] and
                     excess <= 1.0)
    return out


def clip_scale(r: dict) -> float:
    """The factor that undoes a record's clip: its grad norm over
    ``MAX_GRAD_NORM``, at least 1."""
    return max(r["scalars"]["grad_norm"], MAX_GRAD_NORM) / MAX_GRAD_NORM


def unclipped(r: dict) -> list:
    """A record's grad samples before the clip (``clip_scale``), so that a
    leaf is compared apart from the global norm every leaf was divided
    by, which the grad norm scalar holds."""
    s = clip_scale(r)
    return [g * s for g in r["grad"]]


def train_drift(got: dict, want: dict, f32: dict) -> dict:
    """How far a bf16 train record (``got``, the port's) and the file's
    bf16 record (``want``) each lie from the file's f32 record of the same
    cell: the grad samples' (``unclipped``) relative distance in norm a
    parameter, their root mean square over the parameters, and the ratio,
    port over reference, which ``judge_train`` holds within
    ``DRIFT_RATIO`` of 1."""
    base = unclipped(f32)

    def dist(r):
        return float(np.sqrt(np.mean([rel(a, b) ** 2 for a, b in
                                      zip(unclipped(r), base)])))
    port, ref = dist(got), dist(want)
    return {"port_vs_f32": port, "reference_vs_f32": ref,
            "ratio": port / ref}


def stored_train(golden: dict, name: str, dtype: str) -> dict:
    """One train record in the file, each parameter's samples apart."""
    pre = f"{name}/{dtype}"
    names = [str(n) for n in golden[f"{pre}/names"]]
    numels = golden[f"{name}/numels"].tolist()
    cuts = np.cumsum([min(n, K) for n in numels])[:-1]
    return {"names": names, "numels": numels,
            "sums": golden[f"{pre}/checksums"],
            "scalars": dict(zip(SCALARS, golden[f"{pre}/scalars"].tolist())),
            "grad_norms": golden[f"{pre}/grad_norms"],
            "grad": np.split(golden[f"{pre}/grad"].astype(np.float64), cuts),
            "update": np.split(golden[f"{pre}/update"].astype(np.float64),
                               cuts)}


def pack_train(records: dict, meta: dict) -> dict:
    """records: {(cell, dtype): {"names", "sums", "numels", "batches" (the
    two steps' numpy batches), "scalars", "grad_norms", "grad", "update"}}
    -> the file's arrays."""
    arrays = {"meta": _json(meta)}
    for (name, dt), r in records.items():
        arrays.update(_train_cell_arrays(name, r))
        pre = f"{name}/{dt}"
        arrays[f"{pre}/names"] = np.array(r["names"])
        arrays[f"{pre}/checksums"] = r["sums"]
        arrays[f"{pre}/scalars"] = np.array([r["scalars"][k]
                                             for k in SCALARS], np.float64)
        arrays[f"{pre}/grad_norms"] = np.asarray(r["grad_norms"], np.float64)
        for k in ("grad", "update"):
            arrays[f"{pre}/{k}"] = np.concatenate(r[k]).astype(np.float32)
    return arrays


def _train_cell_arrays(name: str, r: dict) -> dict:
    """A train cell's arrays of either file: its batches' sums, parameter
    sizes and index sums, cut, XLA flags, a synthetic cell's tokens."""
    arrays = {f"{name}/input_sums": np.stack([batch_sums(b)
                                              for b in r["batches"]]),
              f"{name}/numels": np.asarray(r["numels"], np.int64),
              f"{name}/index_sums": np.array(
                  [train_indices(n, k).sum() for n, k in
                   zip(r["names"], r["numels"])], np.int64),
              f"{name}/cut": _json(cell(name).cut),
              f"{name}/xla_flags": np.array(cell(name).xla_flags)}
    if cell(name).synthetic:
        arrays[f"{name}/tokens"] = np.stack([b["tokens"]
                                             for b in r["batches"]])
    return arrays


def check_train_inputs(golden: dict, name: str, batches: list,
                       names=None, numels=None):
    """A train cell's batches, cut, and (given the model's parameter names
    and sizes) its parameters' sizes and index sets against the file's."""
    want = golden[f"{name}/input_sums"]
    got = np.stack([batch_sums(b) for b in batches])
    if got.shape != want.shape or not np.allclose(got, want, rtol=1e-12,
                                                  atol=1e-9):
        raise ValueError(f"{name}: the batches drawn here sum to {got}, the "
                         f"file's to {want}")
    there = json.loads(str(golden[f"{name}/cut"]))
    if there != cell(name).cut:
        raise ValueError(f"{name}: the file's cut {there}, here "
                         f"{cell(name).cut}")
    if str(golden[f"{name}/xla_flags"]) != cell(name).xla_flags:
        raise ValueError(f"{name}: the file's reference ran under XLA flags "
                         f"{golden[f'{name}/xla_flags']!r}, here "
                         f"{cell(name).xla_flags!r}")
    if bool(golden.get(f"{name}/seq_exact", False)) != cell(name).seq_exact:
        raise ValueError(f"{name}: the file's wkv is not the form here "
                         f"(seq_exact {cell(name).seq_exact})")
    if numels is not None:
        if list(numels) != golden[f"{name}/numels"].tolist():
            raise ValueError(f"{name}: parameter sizes differ from the file's")
        sums = [train_indices(n, k).sum() for n, k in zip(names, numels)]
        if sums != golden[f"{name}/index_sums"].tolist():
            raise ValueError(f"{name}: index sets differ from the file's")


def judge_train(name: str, dtype: str, got: dict, golden: dict) -> dict:
    """``got`` (``TrainSampler.after``'s record, its "loss_after" set)
    against the file's: {"errors": compare_train(...), "tol"[, "drift"]}."""
    want = stored_train(golden, name, dtype)
    tol = train_tolerance(name, dtype)
    cfg = cell_config(name, dtype)
    f32 = stored_train(golden, name, "float32") if dtype != "float32" and \
        f"{name}/float32/names" in golden else None
    out = {"errors": compare_train(got, want, tol, cfg.optimizer == "adamw",
                                   dtype, f32), "tol": tol}
    if f32 is not None:
        out["drift"] = d = train_drift(got, want, f32)
        out["errors"]["ok"] &= 1 / DRIFT_RATIO <= d["ratio"] <= DRIFT_RATIO
    return out


def train_model(name: str, dtype: str, device):
    """A train cell's model in ``dtype`` on ``device``: its f32 draw
    (``model``), cast where ``dtype`` is narrower."""
    m = model(cell_config(name, "float32"), SEED, device)
    return m if dtype == "float32" else cast(m, cell_config(name, dtype))


def run_train_cell(name: str, dtype: str, device, golden: dict,
                   m=None) -> dict:
    """Build a train cell's model on ``device`` (or take ``m``), check its
    checksums and its batches against the file, take the port's step
    (``train_steps_record``' one step) and compare (``judge_train``).
    Raises on a weight or input mismatch; returns {"errors", "tol"[,
    "drift"], "weights_s", "run_s"}."""
    cfg = cell_config(name, dtype)
    batches = [train_batch(name, cfg, s, golden) for s in (0, 1)]
    t0 = time.perf_counter()  # repro: allow(DB001): the report's wall time
    if m is None:
        m = train_model(name, dtype, device)
    want = {"names": [str(n) for n in golden[f"{name}/{dtype}/names"]],
            "sums": golden[f"{name}/{dtype}/checksums"]}
    check_weights(m, name, dtype, want)
    check_train_inputs(golden, name, batches,
                       *zip(*[(n, p.numel()) for n, p in
                              m.named_parameters()]))
    t1 = time.perf_counter()  # repro: allow(DB001): as above
    got = train_steps_record(m, cfg, batches, device, 1)["steps"][0]
    del m
    t2 = time.perf_counter()  # repro: allow(DB001): as above
    return {**judge_train(name, dtype, got, golden), "weights_s": t1 - t0,
            "run_s": t2 - t1}


# ---------------------------------------------------------------------------
# the train records over ``STEPS`` steps (``TRAIN_STEPS``,
# ``tests/golden/train_steps.npz``): "<cell>/<dtype>/names" and
# "/checksums", "/scalars" ((S, 3) f64: each step's ``STEP_SCALARS``),
# "/loss_after" (batch S's loss after the last step), "/grad_norms" ((S, P)
# f64), "/grad" and "/update" (f32: each step's samples, step 1's at every
# sampled index, the later steps' at every ``THIN``-th), "/count" (the
# optimizer's after the last step), "/state/<k>" (f32: AdamW's "m" and
# "v", or Adafactor's ``state_indices``' samples of "vr" and "vc" of each
# factored leaf and of "v" of the others, at every ``THIN``-th sampled
# index) with Adafactor's "/factored" (one a parameter).
# "<cell>/input_sums", "/numels", "/index_sums", "/cut", "/xla_flags" as in
# ``train.npz``, "<cell>/steps", "/seq_exact", a synthetic cell's "/tokens"
# (its S + 1 batches'), "meta"
# ---------------------------------------------------------------------------
STEP_SCALARS = SCALARS[:3]
ADAMW_B1, ADAMW_B2 = 0.9, 0.95
# the steps past the first and the state keep every THIN-th of a
# parameter's sampled indices (the file's size: all of them ~8.9 MB), but
# the token embedding's (``UNTHINNED``), whose grad is nonzero only at the
# rows of the batch's tokens: 3-9 of its 256 samples (qwen3-moe's at step
# 3: 8, of which 3 at every second index, where the card's grads read
# 0.287 from the record, its norm 8.0e-5)
THIN = 2
UNTHINNED = ("embed",)


def thinned(samples, step: int, pname: str):
    """Parameter ``pname``'s samples (at its ``train_indices``) as a record
    keeps them at ``step`` (from 0; ``STEPS``: the state): all at step 0
    and of an ``UNTHINNED`` parameter, else every ``THIN``-th."""
    return samples if step == 0 or pname in UNTHINNED else samples[::THIN]


def sample_sizes(names: list, numels: list, step: int) -> list:
    """How many samples a record keeps of each parameter at ``step``."""
    return [len(thinned(np.empty(min(k, K)), step, n))
            for n, k in zip(names, numels)]


def state_indices(shape: tuple, idx: np.ndarray, r: int | None) -> dict:
    """Where the flat indices ``idx`` of a layer tensor of ``shape`` (layer
    ``r`` of a stacked leaf, else ``r`` None) fall in Adafactor's moments of
    its leaf: {"vr": its rows, "vc": its columns} (tuples of index arrays)
    where the leaf has two dims or more, else {"v": the elements}."""
    at = tuple(np.unravel_index(np.asarray(idx), tuple(shape)))
    if r is not None:
        at = (np.full(len(idx), r, np.int64),) + at
    if len(at) < 2:
        return {"v": at}
    return {"vr": at[:-1], "vc": at[:-2] + at[-1:]}


def _split(flat: np.ndarray, sizes: list) -> list:
    return [a.astype(np.float64) for a in
            np.split(flat, np.cumsum(sizes)[:-1])]


def pack_train_steps(records: dict, meta: dict) -> dict:
    """records: {(cell, dtype): ``tests/reference_golden.py``'s
    ``reference_train_steps``: {"names", "sums", "numels", "batches" (S +
    1), "steps" (each {"scalars", "grad_norms", "grad", "update"}, its
    samples ``thinned``), "loss_after", "state" (``thinned``), "count"}}
    -> the file's arrays."""
    arrays = {"meta": _json(meta)}
    f32 = np.float32

    def flat(xs):
        return np.concatenate([x for x in xs if x is not None] or
                              [[]]).astype(f32)
    for (name, dt), r in records.items():
        arrays.update(_train_cell_arrays(name, r))
        steps, st = r["steps"], r["state"]
        arrays[f"{name}/steps"] = np.int64(len(steps))
        arrays[f"{name}/seq_exact"] = np.bool_(cell(name).seq_exact)
        pre = f"{name}/{dt}"
        arrays[f"{pre}/names"] = np.array(r["names"])
        arrays[f"{pre}/checksums"] = r["sums"]
        arrays[f"{pre}/scalars"] = np.array(
            [[s["scalars"][k] for k in STEP_SCALARS] for s in steps],
            np.float64)
        arrays[f"{pre}/loss_after"] = np.float64(r["loss_after"])
        arrays[f"{pre}/grad_norms"] = np.array([s["grad_norms"]
                                                for s in steps], np.float64)
        for k in ("grad", "update"):
            arrays[f"{pre}/{k}"] = np.concatenate([flat(s[k])
                                                   for s in steps])
        arrays[f"{pre}/count"] = np.int64(r["count"])
        for k, xs in st.items():
            arrays[f"{pre}/state/{k}"] = flat(xs)
        if "vr" in st:
            arrays[f"{pre}/factored"] = np.array([x is not None
                                                  for x in st["vr"]])
    return arrays


def stored_train_steps(golden: dict, name: str, dtype: str) -> dict:
    """One record of ``train_steps.npz``: {"names", "numels", "sums",
    "steps" (each step as ``compare_train`` takes a record: its scalars
    with the next step's loss as "loss_after", each parameter's grad norm,
    grad and update samples), "state" ({key: each parameter's samples,
    None where its leaf has none}), "count"}, the samples ``thinned``."""
    pre = f"{name}/{dtype}"
    names = [str(n) for n in golden[f"{pre}/names"]]
    numels = golden[f"{name}/numels"].tolist()
    sc = golden[f"{pre}/scalars"]
    n_steps = len(sc)
    sizes = [sample_sizes(names, numels, k) for k in range(n_steps + 1)]
    cuts = np.cumsum([sum(s) for s in sizes[:n_steps]])[:-1]
    grads, updates = (np.split(golden[f"{pre}/{k}"], cuts)
                      for k in ("grad", "update"))
    every = np.ones(len(names), bool)
    fac = golden.get(f"{pre}/factored", ~every)   # Adafactor's, else none
    state = {}
    for k, has in (("m", every), ("v", ~fac), ("vr", fac), ("vc", fac)):
        if f"{pre}/state/{k}" in golden:
            parts = iter(_split(golden[f"{pre}/state/{k}"], [
                s for s, h in zip(sizes[n_steps], has) if h]))
            state[k] = [next(parts) if h else None for h in has]
    after = [float(s[0]) for s in sc[1:]] + [
        float(golden[f"{pre}/loss_after"])]
    steps = [{"names": names, "numels": numels,
              "scalars": {**dict(zip(STEP_SCALARS, sc[i].tolist())),
                          "loss_after": after[i]},
              "grad_norms": golden[f"{pre}/grad_norms"][i],
              "grad": _split(grads[i], sizes[i]),
              "update": _split(updates[i], sizes[i])}
             for i in range(n_steps)]
    return {"names": names, "numels": numels,
            "sums": golden[f"{pre}/checksums"], "steps": steps,
            "state": state, "count": int(golden[f"{pre}/count"])}


def train_steps_record(m, cfg, batches: list, device, steps: int = STEPS
                       ) -> dict:
    """``steps`` train steps of the port (``build_train_step``, the
    config's optimizer, ``LR``) on model ``m`` from one fresh state, on
    batches 0..steps-1, then the loss of a forward pass on batch ``steps``:
    {"names", "numels", "steps" (``TrainSampler``'s record of each, its
    "loss_after" the next step's loss), "state", "count"
    (``TrainSampler.state`` after the last)}."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import steps as tsteps
    opt = make_optimizer(cfg.optimizer, cfg=cfg)
    state = tsteps.init_train_state(None, cfg, opt, params=m)
    dev = torch.device(device)
    bs = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
          for b in batches]
    step = tsteps.build_train_step(cfg, opt, lambda s: LR)
    sampler, out = TrainSampler(state), []
    for b in bs[:steps]:
        state, metrics = step(state, b)
        out.append(sampler.after(state, metrics))
    rec = {"names": out[0]["names"], "numels": out[0]["numels"],
           "steps": out, **sampler.state(state, cfg)}
    del state, sampler
    return with_losses_after(rec, forward_loss(m, cfg, bs[steps]))


def forward_loss(m, cfg, batch: dict) -> float:
    """The loss of a forward pass of ``m`` on ``batch`` (its grads freed
    first), reduced as the train step reduces: the loss after a step."""
    from repro_torch.train import steps as tsteps
    for p in m.parameters():
        p.grad = None
    with torch.no_grad(), tsteps.full_bf16_reductions():
        return float(tsteps.loss_fn(m, cfg, batch)[1]["loss"])


def with_losses_after(rec: dict, last: float) -> dict:
    """Each step's "loss_after": the next step's loss, ``last`` after the
    last step."""
    after = [s["scalars"]["loss"] for s in rec["steps"][1:]] + [last]
    for s, a in zip(rec["steps"], after):
        s["scalars"]["loss_after"] = a
    return rec


def adamw_v_hat(grads: list) -> list:
    """AdamW's bias-corrected second moment after each step, f64, from
    each step's clipped grad samples (a parameter's)."""
    v, out = 0.0, []
    for k, g in enumerate(grads, 1):
        v = ADAMW_B2 * v + (1 - ADAMW_B2) * np.square(g)
        out.append(v / (1 - ADAMW_B2 ** k))
    return out


def compare_later_step(got: dict, want: dict, lim: dict, adamw: bool,
                       dtype: str, v_hat: list, f32: dict | None = None
                       ) -> dict:
    """A step past the first (whose update is not about lr sign(g) any more)
    of a train record ``got`` against ``want``: the scalars and each leaf's
    grad as ``compare_train`` holds them (a leaf's grad limit widened to
    ``SPREAD`` times the reference's own error from ``f32``); each leaf's
    update in relative norm, AdamW's where the reference's sqrt(v_hat)
    (``v_hat``: each parameter's samples at this step) exceeds
    ``CLEAR_EPS`` eps, and within 2 lr (1 + wd |p|) elsewhere, where the
    step is linear in the grad; beside ``f32`` a leaf's update limit is at
    least ``SPREAD`` times the reference's own distance from it there.  An
    update is the difference of two f32 values of the weight (AdamW's f32
    master): each index's difference counts past one f32 spacing of the
    new weight (``ulp_excess``), the rounding of two steps that differ in
    their last bits."""
    names = want["names"]
    first = compare_train(got, want, lim, False, dtype, f32)
    slack = 1 + (BF16_STEP_SLACK if dtype == "bfloat16" else 0.0)
    errs, limits, excess, cleared, held = [], [], 0.0, 0, 0
    for i in range(len(names)):
        gu, wu = got["update"][i], want["update"][i]
        clear = np.sqrt(v_hat[i]) > CLEAR_EPS * ADAMW_EPS if adamw else \
            np.ones(len(wu), bool)
        cleared += int(clear.sum())
        new = got["base"][i] + gu
        errs.append(ulp_excess(gu[clear], wu[clear], new[clear])
                    if clear.any() else 0.0)
        own = ulp_excess(wu[clear], f32["update"][i][clear], new[clear]) \
            if f32 and clear.any() else 0.0
        limits.append(max(lim["update"], SPREAD * own))
        if (~clear).any():
            bound = 2 * LR * (1 + WEIGHT_DECAY * np.abs(got["base"][i]))
            excess = max(excess, float(np.max((np.abs(gu - wu) / (
                bound * slack))[~clear])))
            held += int((~clear).sum())
    over = [e / m for e, m in zip(errs, limits)]
    worst = int(np.argmax(over))
    update = {"worst": errs[worst], "worst_leaf": names[worst],
              "worst_limit": limits[worst], "largest_error": max(errs),
              "limits_widened": sum(m > lim["update"] for m in limits)}
    if adamw:
        update.update(indices_cleared=cleared, indices_bounded=held,
                      bound_used=excess)
    ok = bool(max(first["scalars"].values()) <= lim["scalars"] and
              first["grad"]["worst"] <= first["grad"]["worst_limit"] and
              over[worst] <= 1.0 and excess <= 1.0)
    return {**first, "update": update, "ok": ok}


def ulp_excess(a: np.ndarray, b: np.ndarray, at: np.ndarray) -> float:
    """``rel(a, b)`` of two updates of a weight of values ``at``, each
    index's difference less one f32 spacing of its weight (0 at most):
    what is left past the rounding of the f32 weight the update is the
    change of."""
    b = np.asarray(b, np.float64)
    d = np.maximum(np.abs(np.asarray(a, np.float64) - b) - np.spacing(
        np.abs(np.asarray(at, np.float32))).astype(np.float64), 0.0)
    n = float(np.linalg.norm(b))
    return float(np.linalg.norm(d)) / n if n else (
        0.0 if not d.any() else math.inf)


def compare_state(got: dict, want: dict, lim: float,
                  f32: dict | None = None) -> dict:
    """The optimizer's state after the last step: each parameter's samples
    of each moment in relative norm within ``lim`` (beside ``f32``'s state
    at least ``SPREAD`` times the reference's own distance from it), and
    the same count."""
    errs, limits, where = [], [], []
    for k in sorted(want["state"]):
        for i, w in enumerate(want["state"][k]):
            if w is None:
                continue
            errs.append(rel(got["state"][k][i], w))
            own = rel(w, f32["state"][k][i]) if f32 else 0.0
            limits.append(max(lim, SPREAD * own))
            where.append(f"{k}:{want['names'][i]}")
    over = [e / m for e, m in zip(errs, limits)]
    worst = int(np.argmax(over))
    return {"worst": errs[worst], "worst_leaf": where[worst],
            "worst_limit": limits[worst], "largest_error": max(errs),
            "count": got["count"], "want_count": want["count"],
            "ok": bool(over[worst] <= 1.0 and got["count"] == want["count"])}


def compare_train_steps(got: dict, want: dict, lim: dict, adamw: bool,
                        dtype: str, f32: dict | None = None,
                        later: dict | None = None) -> dict:
    """A record over several steps (``train_steps_record``) against the
    file's (``stored_train_steps``): step 1 by ``compare_train`` at
    ``lim``, each later step by ``compare_later_step`` (AdamW's sqrt(v_hat)
    from the file's grads) and the state after the last by
    ``compare_state``, both at ``later`` (default ``lim``); ``f32`` (the
    file's f32 record of the cell, for a narrower ``want``) widens each
    step's limits as there.  {"steps": each step's errors, "state",
    "ok"}."""
    later = later or lim
    if len(got["steps"]) != len(want["steps"]):
        raise ValueError(f"{len(got['steps'])} steps, the file's "
                         f"{len(want['steps'])}")
    # each later step's sqrt(v_hat) at its indices: step 1's grads thinned
    grads = [[thinned(x, 1, n) for x, n in zip(s["grad"], want["names"])]
             if k == 0 else s["grad"] for k, s in enumerate(want["steps"])]
    v_hat = list(zip(*[adamw_v_hat(g) for g in zip(*grads)])) if adamw \
        else None
    out = []
    for k, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        f = f32["steps"][k] if f32 else None
        out.append(compare_train(g, w, lim, adamw, dtype, f) if k == 0 else
                   compare_later_step(g, w, step_limits(later, k), adamw,
                                      dtype, v_hat[k] if adamw else None, f))
    state = compare_state(got, want, later["state"], f32)
    return {"steps": out, "state": state,
            "ok": all(e["ok"] for e in out) and state["ok"]}


def step_limits(lim: dict, k: int) -> dict:
    """The limits of step ``k`` (from 0, past the first) of a
    ``train_tolerance``: a measure's limit, or its ``k``-th of a tuple
    (one a step past the first)."""
    return {m: v[k - 1] if isinstance(v, tuple) else v
            for m, v in lim.items()}


def judge_train_steps(name: str, dtype: str, got: dict, golden: dict
                      ) -> dict:
    """``got`` (``train_steps_record``'s) against the file's record:
    {"errors": compare_train_steps(...), "tol" (step 1's: its ``TRAIN``
    cell's), "later_tol" (the later steps' and the state's: the cell's
    own where ``TOL_CELL`` sets them)[, "drift": each step's][, "unheld":
    why]}; a bf16 step whose ``train_drift`` lies outside ``DRIFT_RATIO``
    fails.  An ``UNHELD`` record's "ok" holds its step 1 and the count
    alone."""
    want = stored_train_steps(golden, name, dtype)
    tol = train_tolerance(train_name(name), dtype)
    later = train_tolerance(name, dtype)
    adamw = cell_config(name, dtype).optimizer == "adamw"
    f32 = stored_train_steps(golden, name, "float32") if dtype != \
        "float32" and f"{name}/float32/names" in golden else None
    out = {"errors": compare_train_steps(got, want, tol, adamw, dtype, f32,
                                         later),
           "tol": tol, "later_tol": later}
    e, unheld = out["errors"], UNHELD.get((name, dtype))
    held = e["steps"][:1] if unheld else e["steps"]
    ok = all(s["ok"] for s in held) and (
        e["state"]["count"] == e["state"]["want_count"] if unheld else
        e["state"]["ok"])
    if f32 is not None:
        out["drift"] = [train_drift(g, w, f) for g, w, f in zip(
            got["steps"], want["steps"], f32["steps"])]
        ok &= all(1 / DRIFT_RATIO <= d["ratio"] <= DRIFT_RATIO
                  for d in out["drift"][:len(held)])
    e["ok"] = ok
    if unheld:
        out["unheld"] = unheld
    return out


def run_train_steps_cell(name: str, dtype: str, device, golden: dict,
                         m=None) -> dict:
    """``run_train_cell`` over the record's steps: the model built on
    ``device`` (or ``m``), its checksums and batches checked against the
    file, ``train_steps_record``, ``judge_train_steps``."""
    cfg = cell_config(name, dtype)
    n_steps = int(golden[f"{name}/steps"])
    batches = [train_batch(name, cfg, s, golden) for s in range(n_steps + 1)]
    t0 = time.perf_counter()  # repro: allow(DB001): the report's wall time
    if m is None:
        m = train_model(name, dtype, device)
    check_weights(m, name, dtype, {
        "names": [str(n) for n in golden[f"{name}/{dtype}/names"]],
        "sums": golden[f"{name}/{dtype}/checksums"]})
    check_train_inputs(golden, name, batches,
                       *zip(*[(n, p.numel()) for n, p in
                              m.named_parameters()]))
    t1 = time.perf_counter()  # repro: allow(DB001): as above
    got = train_steps_record(m, cfg, batches, device, n_steps)
    del m
    t2 = time.perf_counter()  # repro: allow(DB001): as above
    return {**judge_train_steps(name, dtype, got, golden),
            "weights_s": t1 - t0, "run_s": t2 - t1}


def port_spread(name: str, dtype: str, device, golden: dict) -> dict:
    """How far one ulp of the embedding moves the port's own steps of a
    ``TRAIN_STEPS`` cell on ``device`` (``tests/reference_golden.py
    --sensitivity`` reads the reference's so): the port's record with its
    embedding moved one ulp of its dtype against its own record, by
    ``compare_train_steps`` at the cell's limits."""
    cfg = cell_config(name, dtype)
    n_steps = int(golden[f"{name}/steps"])
    batches = [train_batch(name, cfg, s, golden) for s in range(n_steps + 1)]
    recs = []
    for nudge in (False, True):
        m = train_model(name, dtype, device)
        if nudge:
            with torch.no_grad():
                w = dict(m.named_parameters())["embed"]
                w.mul_(1 + torch.finfo(w.dtype).eps)
        recs.append(train_steps_record(m, cfg, batches, device, n_steps))
        del m
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return compare_train_steps(
        recs[1], recs[0], train_tolerance(train_name(name), dtype),
        cfg.optimizer == "adamw", dtype, None, train_tolerance(name, dtype))


def routes(name: str, device, golden: dict) -> dict:
    """A MoE train cell's routing in the forward pass of its batch 0 on
    ``device`` (its model in f32): each MoE call's expert set of each
    token, sorted ("<call>/experts"), and the gap between the token's k-th
    and (k+1)-th probabilities relative to the k-th ("<call>/margin"): a
    route whose margin is within the devices' rounding may differ from
    another device's, or from the reference's."""
    from repro_torch.models import moe
    from repro_torch.train import steps as tsteps
    cfg = cell_config(name, "float32")
    dev = torch.device(device)
    b0 = {k: torch.from_numpy(v).to(dev)
          for k, v in train_batch(name, cfg, 0, golden).items()}
    m = train_model(name, "float32", dev)
    route, out = moe._route, {}

    def recorded(x, router, k):
        gate, idx, probs = route(x, router, k)
        p = probs.detach().sort(dim=-1, descending=True).values
        i = len(out) // 2
        out[f"{i}/experts"] = idx.sort(dim=-1).values.cpu().numpy()
        out[f"{i}/margin"] = ((p[:, k - 1] - p[:, k]) / p[:, k - 1]).cpu(
            ).numpy()
        return gate, idx, probs
    moe._route = recorded
    try:
        with torch.no_grad():
            tsteps.loss_fn(m, cfg, b0)
    finally:
        moe._route = route
    return out


def compare_routes(here: dict, there: dict) -> dict:
    """The (call, token) routes whose expert sets differ between two
    ``routes`` records, with their margins in each, and the smallest
    margin of each call here."""
    calls = sorted({int(k.split("/")[0]) for k in here})
    differ = []
    for c in calls:
        a, b = here[f"{c}/experts"], there[f"{c}/experts"]
        for t in np.flatnonzero((a != b).any(axis=1)):
            differ.append({"call": c, "token": int(t), "margin_here": float(
                here[f"{c}/margin"][t]), "margin_there": float(
                there[f"{c}/margin"][t])})
    return {"routes": int(sum(len(here[f"{c}/margin"]) for c in calls)),
            "differ": differ, "smallest_margin": [
                float(here[f"{c}/margin"].min()) for c in calls]}


GROUPS = {"timed": TIMED, "moe": MOE_TIMED, "train": TRAIN,
          "train_steps": TRAIN_STEPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="cells of CELLS, TIMED, MOE_TIMED, TRAIN and "
                         "TRAIN_STEPS, comma-separated; 'timed', 'moe', "
                         "'train' or 'train_steps' for all of one table")
    ap.add_argument("--golden", default=None,
                    help="the records' file (default: each cell's own)")
    ap.add_argument("--int8-flips", metavar="PATH", default=None,
                    help="compare the int8 cell's cache with the "
                         "reference's in PATH instead (int8_flips)")
    ap.add_argument("--spread", action="store_true",
                    help="print how far one ulp of the embedding moves the "
                         "port's own steps of each TRAIN_STEPS cell of "
                         "--cells instead (port_spread)")
    ap.add_argument("--routes", metavar="PATH", default=None,
                    help="write the MoE train cell's (--cells) routes on "
                         "this device to PATH instead (routes)")
    ap.add_argument("--routes-against", metavar="PATH", default=None,
                    help="compare the MoE train cell's routes on this "
                         "device with those in PATH instead")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":           # the f32 tolerance is full f32's
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.routes or args.routes_against:
        here = routes(args.cells, device, load(TRAIN_GOLDEN))
        if args.routes:
            Path(args.routes).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(args.routes, **here)
        if args.routes_against:
            print("[golden] routes: " + json.dumps(compare_routes(
                here, load(args.routes_against))), flush=True)
        return 0
    if args.int8_flips:
        r = int8_flips(args.int8_flips, device,
                       load(args.golden or TIMED_GOLDEN))
        print("[golden] int8 flips: " + json.dumps(r), flush=True)
        return 0
    names = list(GROUPS[args.cells]) if args.cells in GROUPS \
        else args.cells.split(",")
    if args.spread:
        for name in names:
            for dt in cell(name).dtypes:
                e = port_spread(name, dt, device, load(args.golden or
                                                       file_of(name)))
                print(f"[golden] {name} {dt} spread: " + json.dumps(e),
                      flush=True)
        return 0
    files, ok = {}, True
    for name in names:
        path = args.golden or file_of(name)
        if path not in files:
            files[path] = load(path)
        for dt in cell(name).dtypes:
            r = (run_train_steps_cell if name in TRAIN_STEPS else
                 run_train_cell if name in TRAIN else run_cell)(
                name, dt, device, files[path])
            ok &= r["errors"]["ok"]
            print(f"[golden] {name} {dt}: " + json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
