"""The port at full width against the reference's own outputs.

    PYTHONPATH=src python -m repro_torch.launch.golden [--device cuda|cpu]
        [--cells gemma3-1b,whisper-small@4x1024 | --cells timed] [--golden PATH]
    PYTHONPATH=src python -m repro_torch.launch.golden --int8-flips PATH

Runs each cell through the port's prefill and 8 teacher-forced decode
steps (and, for a cell with an engine record, the f32 serving engine),
and holds what it computes to the records that ``tests/reference_golden.py``
writes from the JAX reference on the same weights and inputs.  One line a
cell; exit 1 where a cell is out of its tolerance.  Two files:

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

The weights are the port's own (``model``): ``init_params`` drawing from a
``BlockDraws`` seeded with ``SEED``, then the leaves the reference
initialises to zeros or ones (``NORMAL``: norms, biases, the rwkv
interpolations) given further draws of ``NORMAL_SCALE``, so that each of
them matters.  The file holds each leaf's f64 sum and sum of squares
(``checksums``), and every consumer checks them before it compares
anything.  The inputs are numpy draws (``inputs``: ``INPUT_SEED`` with
the cell's arch's name, so that the variants of a timed cell share them;
the cells of the two files differ in shape): the file holds the tokens; whisper's frames and paligemma's patches are drawn
again from the cell's seed and checked against their sums.

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
SEED = 0                      # the weights' BlockDraws
DIRECTIONS_SEED = 1           # the 16 directions
INPUT_SEED = 2                # with the arch's name: a cell's inputs
ENGINE_SEED = 4               # with the arch's name: the engine's prompts
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
}
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


def cell(name: str) -> Cell:
    return CELLS[name] if name in CELLS else TIMED[name]


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
    return GOLDEN if name in CELLS else TIMED_GOLDEN


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
        if name in TIMED:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="cells of CELLS and TIMED, comma-separated; "
                         "'timed' for all of TIMED")
    ap.add_argument("--golden", default=None,
                    help="the records' file (default: each cell's own)")
    ap.add_argument("--int8-flips", metavar="PATH", default=None,
                    help="compare the int8 cell's cache with the "
                         "reference's in PATH instead (int8_flips)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":           # the f32 tolerance is full f32's
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.int8_flips:
        r = int8_flips(args.int8_flips, device,
                       load(args.golden or TIMED_GOLDEN))
        print("[golden] int8 flips: " + json.dumps(r), flush=True)
        return 0
    names = list(TIMED) if args.cells == "timed" else args.cells.split(",")
    files, ok = {}, True
    for name in names:
        path = args.golden or file_of(name)
        if path not in files:
            files[path] = load(path)
        for dt in cell(name).dtypes:
            r = run_cell(name, dt, device, files[path])
            ok &= r["errors"]["ok"]
            print(f"[golden] {name} {dt}: " + json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
