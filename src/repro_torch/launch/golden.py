"""The port at full width against the reference's own outputs.

    PYTHONPATH=src python -m repro_torch.launch.golden [--device cuda|cpu]
        [--cells gemma3-1b,whisper-small] [--golden PATH]

Runs each cell of ``CELLS`` (a published config at every published width,
cut only in depth, and the MoEs in experts; batch 1) through the port's
prefill and 8 teacher-forced decode steps, and holds what it computes to
``tests/golden/full_width.npz``, which ``tests/reference_golden.py`` writes
from the JAX reference on the same weights and inputs.  One line a cell;
exit 1 where a cell is out of its tolerance.

The weights are the port's own (``model``): ``init_params`` drawing from a
``BlockDraws`` seeded with ``SEED``, then the leaves the reference
initialises to zeros or ones (``NORMAL``: norms, biases, the rwkv
interpolations) given further draws of ``NORMAL_SCALE``, so that each of
them matters.  The file holds each leaf's f64 sum and sum of squares
(``checksums``), and every consumer checks them before it compares
anything.  The inputs are numpy draws (``inputs``): the file holds the
tokens; whisper's frames and paligemma's patches are drawn again from the
cell's seed and checked against their sums.

What is kept of the logits (``summarize``), at every prefill position and
every decode step: their projection onto 16 fixed directions (numpy draws
of ``DIRECTIONS_SEED``, N(0, 1) / sqrt(V)), their logsumexp, their largest
magnitude (``size``), their argmax and the gap between the top two.  A run is held
to the file (``compare``) at the cell's tolerance ``tol`` (``tolerance``):
the projections' error in norm relative to the file's, at most ``tol``; each
logsumexp within ``tol`` times the position's size; the argmax equal
wherever the file's top-two gap exceeds ``2 tol`` times the size.

The prefill is the one ``serving.steps.build_prefill_step`` runs
(``forward_prefill``), with the logits of every position
(``all_positions``); each decode step is ``forward_decode``, as
``build_decode_step`` runs it, fed the file's next token instead of the
greedy one, from the position right after the prompt (``decode_start``).
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
SEED = 0                      # the weights' BlockDraws
DIRECTIONS_SEED = 1           # the 16 directions
INPUT_SEED = 2                # with the cell's name: its tokens, frames, patches
N_DIRECTIONS = 16
DECODE_STEPS = 8
NORMAL_SCALE = 0.3
# the leaves the reference initialises to zeros or ones
NORMAL = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
          "k_norm", "lnx_b", "ba", "bi", "conv_b", "mu_x", "mu", "mu_k",
          "mu_r", "enc_norm", "ln_x"}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# rwkv6-7b's chunked wkv in f32 drifts from the sequential form by ~1e-4
TOL_CELL = {("rwkv6-7b", "float32"): 1e-3}
CHECKSUM_TOL = 1e-9           # relative; a different draw moves them ~1e-5


@dataclasses.dataclass(frozen=True)
class Cell:
    """``seq``: the prompt's tokens (whisper: its frames, the decoder taking
    seq / dec_len_ratio tokens; paligemma: its patches and tokens together).
    ``cut``: what differs from the published config besides ``param_dtype``
    (``n_layers``, and ``n_experts`` of the MoE)."""
    arch: str
    seq: int
    dtypes: tuple
    cut: dict


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


def runs() -> list:
    """Every (cell, dtype) of the file, in ``CELLS``' order."""
    return [(name, dt) for name, c in CELLS.items() for dt in c.dtypes]


def tolerance(name: str, dtype: str) -> float:
    return TOL_CELL.get((name, dtype), TOL[dtype])


def cell_config(name: str, dtype: str, configs=get_config):
    """The cell's config from ``configs`` (the port's ``get_config``, or the
    reference's, which has the same fields)."""
    cut = dict(CELLS[name].cut)
    cfg = configs(CELLS[name].arch)
    if "n_experts" in cut:
        cut["moe"] = dataclasses.replace(cfg.moe, n_experts=cut.pop(
            "n_experts"))
    return dataclasses.replace(cfg, param_dtype=dtype, **cut)


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
    """The cell's numpy inputs: ``tokens`` (1, n) int32, ``decode`` (8,)
    int32, and whisper's ``frames`` (1, seq, D) or paligemma's ``patches``
    (1, P, D), f32."""
    rng = np.random.default_rng([INPUT_SEED, zlib.crc32(name.encode())])
    seq = CELLS[name].seq
    out = {}
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal((1, seq, cfg.d_model),
                                            dtype=np.float32)
        n = seq // cfg.dec_len_ratio
    elif cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (1, cfg.n_prefix_tokens, cfg.d_model), dtype=np.float32)
        n = seq - cfg.n_prefix_tokens
    else:
        n = seq
    out["tokens"] = rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32)
    out["decode"] = rng.integers(0, cfg.vocab_size, DECODE_STEPS,
                                 dtype=np.int32)
    return out


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
    """The port's prefill and decode steps on ``inp``: {"prefill": summary,
    "decode": summary}."""
    dev = torch.device(device)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()
             if k != "decode"}
    dirs = torch.tensor(directions(cfg.vocab_size), device=dev)
    with torch.no_grad():
        logits, cache = forward_prefill(m, cfg, batch, all_positions=True)
        prefill = summarize(logits[0], dirs)
        del logits
        start, steps = decode_start(cfg, inp), []
        for i, t in enumerate(inp["decode"]):
            tok = torch.tensor([[int(t)]], dtype=torch.int32, device=dev)
            logits, cache = forward_decode(m, cfg, cache, tok, start + i)
            steps.append(summarize(logits[0], dirs))
    return {"prefill": prefill, "decode": concat(steps)}


def compare(got: dict, want: dict, tol: float) -> dict:
    """Errors of ``got`` against ``want`` (the file's), each part: the
    projections' relative error in norm, the largest logsumexp error in
    units of the position's size, the argmax mismatches where the gap
    exceeds 2 tol sizes (and how many positions had such a gap); ``ok``."""
    out, ok = {}, True
    for part in ("prefill", "decode"):
        g, w = got[part], want[part]
        sk = float(np.linalg.norm(g["sketch"] - w["sketch"]) /
                   np.linalg.norm(w["sketch"]))
        lse = float(np.max(np.abs(g["lse"] - w["lse"]) / w["size"]))
        clear = w["gap"] > 2 * tol * w["size"]
        flips = int(np.sum(clear & (g["argmax"] != w["argmax"])))
        out[part] = {"sketch_rel": sk, "lse_in_sizes": lse,
                     "argmax_differs": flips, "argmax_checked": int(clear.sum())}
        ok &= sk <= tol and lse <= tol and flips == 0
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# the file: "<cell>/<dtype>/<part>/<key>" summaries, "<cell>/<dtype>/
# checksums" and "/names", "<cell>/tokens", "/decode", "/input_sums",
# "<cell>/cut", "meta"
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


def pack(records: dict, meta: dict) -> dict:
    """records: {(cell, dtype): {"names", "sums", "inputs", "prefill",
    "decode"}} -> the file's arrays."""
    arrays = {"meta": np.array(json.dumps(meta, sort_keys=True))}
    for (name, dt), r in records.items():
        inp = r["inputs"]
        arrays[f"{name}/tokens"] = inp["tokens"]
        arrays[f"{name}/decode"] = inp["decode"]
        arrays[f"{name}/input_sums"] = input_sums(inp)
        arrays[f"{name}/cut"] = np.array(json.dumps(CELLS[name].cut,
                                                    sort_keys=True))
        arrays[f"{name}/{dt}/names"] = np.array(r["names"])
        arrays[f"{name}/{dt}/checksums"] = r["sums"]
        for part in ("prefill", "decode"):
            for k, kind in STORED.items():
                arrays[f"{name}/{dt}/{part}/{k}"] = \
                    np.asarray(r[part][k]).astype(kind)
    return arrays


def load(path=GOLDEN) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def stored(golden: dict, name: str, dtype: str) -> dict:
    """One run's records in the file: names, sums, and the two parts'
    summaries (f64)."""
    r = {"names": [str(n) for n in golden[f"{name}/{dtype}/names"]],
         "sums": golden[f"{name}/{dtype}/checksums"]}
    for part in ("prefill", "decode"):
        r[part] = {k: golden[f"{name}/{dtype}/{part}/{k}"].astype(
            np.int64 if k == "argmax" else np.float64) for k in STORED}
    return r


def check_inputs(golden: dict, name: str, inp: dict):
    """The cell's inputs as drawn here against the file's, and the
    directions' draw against the file's sums."""
    for k in ("tokens", "decode"):
        if not np.array_equal(inp[k], golden[f"{name}/{k}"]):
            raise ValueError(f"{name}: {k} drawn here differ from the file's")
    want = golden[f"{name}/input_sums"]
    if not np.allclose(input_sums(inp), want, rtol=1e-12, atol=1e-9):
        raise ValueError(f"{name}: frames or patches drawn here sum to "
                         f"{input_sums(inp)}, the file's to {want}")
    cut = json.loads(str(golden[f"{name}/cut"]))
    if cut != CELLS[name].cut:
        raise ValueError(f"{name}: the file's cut {cut}, here {CELLS[name].cut}")


def check_directions(golden: dict, vocab: int):
    meta = json.loads(str(golden["meta"]))
    got = array_sums(directions(vocab))
    want = meta["directions"][str(vocab)]
    if not np.allclose(got, want, rtol=1e-12, atol=1e-9):
        raise ValueError(f"directions of vocab {vocab} sum to {got}, the "
                         f"file's to {want}: numpy draws otherwise here")


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
    t0 = time.perf_counter()  # repro: allow(DB001): the report's wall time
    if m is None:
        m = model(cfg, SEED, device)
    names, sums = checksums(m)
    sizes = [p.numel() for p in m.parameters()]
    bad = checksum_mismatches(names, sums, want["names"], want["sums"], sizes)
    if bad:
        raise ValueError(f"{name} {dtype}: the weights differ from the "
                         f"file's: " + "; ".join(bad[:5]))
    t1 = time.perf_counter()  # repro: allow(DB001): as above
    got = run(m, cfg, inp, device)
    del m
    t2 = time.perf_counter()  # repro: allow(DB001): as above
    tol = tolerance(name, dtype)
    return {"errors": compare(got, want, tol), "tol": tol,
            "weights_s": t1 - t0, "run_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--golden", default=str(GOLDEN))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":           # the f32 tolerance is full f32's
        torch.backends.cuda.matmul.allow_tf32 = False
    golden = load(args.golden)
    ok = True
    for name in args.cells.split(","):
        for dt in CELLS[name].dtypes:
            r = run_cell(name, dt, device, golden)
            ok &= r["errors"]["ok"]
            print(f"[golden] {name} {dt}: " + json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
