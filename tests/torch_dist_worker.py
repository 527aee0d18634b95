"""One rank of the multi-process checks in tests/test_torch_distributed.py
and tests/test_torch_sharded.py (not a test module: the tests spawn it).

    python tests/torch_dist_worker.py RANK WORLD STORE INPUTS OUT [sharded]

Joins a gloo group of WORLD ranks through the FileStore at STORE, builds a
(2, 4) mesh ("data", "model") and a (2, 4) mesh ("data", "pp") with
``repro_torch.launch.mesh.make_mesh``, runs the port's ``moe_sharded``
(three paths, f32 and bf16), ``pipeline_apply``, ``compressed_psum`` and
``constrain`` on the numpy inputs in INPUTS, and writes what it computed to
OUT.  Rank 0
writes the sharded outputs gathered back to full tensors.

With ``sharded`` it runs the sharded model instead (``sharded_main``): each
cell of INPUTS (its weights in the port's names, its tokens) as DTensors on
the (2, 4) ("data", "model") mesh, and writes each output in full; the
MoE whose experts do not split over ``model`` (``run_moe_dense``); the
kernels' DTensor routes (``run_kernels``), attention by head groups in the
layer (``run_group_layers``), rwkv6-7b's time mix and channel mix on the
residual stream's rows (``run_rwkv``), partial sums over two and three
mesh dims reduced in one collective (``run_reduce``) and the
vocab-parallel cross-entropy (``run_loss``); each cell's q-rows routes and the cut of its
k and v projections are noted as it runs (``seeing_q_rows``).  Then
what the dry-run's fake world is held against (``run_dryrun_checks``):
``train.steps._microbatch`` on a batch sharded over 8 data ranks, a
shard-to-shard ``redistribute`` under ``native_alltoall`` (gloo's
all-to-all, values and trace), and rank 0's ``OpTrace`` of one sharded
train step (``launch.dryrun.run_step`` on CPU tensors).  A cell with
``<cell>/seed`` and no weights in INPUTS draws them itself
(``seeded_model``), at full width where ``<cell>/width`` says so.

The module also holds what the sharded model's cells are and what they
are held to, without JAX, for tests/test_torch_sharded.py and for
``chip_smoke.py`` ``[multirank]``: the cell table (``CELLS``,
``CELL_BATCH``, ``CELL_CONFIG``, ``B``, ``S``, ``LR``), the layout of
INPUTS (``build_inputs``, given the weights), and the unsharded port on
the same INPUTS (``unsharded``: ``port_run`` a cell, ``kernel_plain``,
``xent_plain``, ``rwkv_port``, ``group_layer_port``, ``moe_dense_port``).
"""
import collections
import contextlib
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import LM_SHAPES, get_config, get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.layouts import choose_layout
from repro_torch.distributed.pipeline import pipeline_apply, pipeline_stages
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.modules import MLP

MOE_PATHS = {"prefill": ({"act_seq": None}, False), "sp": ({}, False),
             "decode": ({}, True)}


def gather_full(t, spec, mesh):
    for d, s in enumerate(spec):
        if s:
            t = coll.all_gather(t, s, d, mesh)
    return t


def moe_module(inp, arch, dtype, mesh, rules):
    """This rank's experts (experts over model, expert ff over data)."""
    def t(name):
        return torch.from_numpy(inp[f"{arch}/{name}"]).to(dtype)
    wg_spec = rules.spec(("experts", None, "moe_ff"))
    wd_spec = rules.spec(("experts", "moe_ff", None))
    p = {"router": torch.from_numpy(inp[f"{arch}/router"]),
         "w_gate": context.local_shard(t("w_gate"), wg_spec, mesh),
         "w_up": context.local_shard(t("w_up"), wg_spec, mesh),
         "w_down": context.local_shard(t("w_down"), wd_spec, mesh)}
    dense = None
    if f"{arch}/dense/w_gate" in inp:
        dense = MLP({n: t(f"dense/{n}") for n in ("w_gate", "w_up",
                                                   "w_down")})
    return tmoe.MoE(p, dense)


def main(rank, world, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    inp = dict(np.load(inputs))
    res = {}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = get_smoke_config(arch)
        for dtype in (torch.float32, torch.bfloat16):
            for path, (over, decode) in MOE_PATHS.items():
                rules = choose_layout(cfg, LM_SHAPES["train_4k"], mesh, over)
                p = moe_module(inp, arch, dtype, mesh, rules)
                x = torch.from_numpy(inp[f"{arch}/x"]).to(dtype)
                if decode:
                    x = x[:, :1]
                sp = not decode and rules.rules["act_seq"] == "model" and \
                    cfg.n_heads % 4 == 0
                spec = rules.spec(("batch", "act_seq" if sp else "seq",
                                   None))
                with context.use_rules(rules):
                    y, aux = tmoe.moe_layer(
                        p, context.local_shard(x, spec, mesh), cfg,
                        decode=decode)
                tag = f"{arch}/{str(dtype)[6:]}/{path}"
                res[f"{tag}/y"] = gather_full(y, spec, mesh).float().numpy()
                res[f"{tag}/aux"] = aux.numpy()
                res[f"{tag}/local_shape"] = np.array(y.shape)

    # GPipe over the pp axis; each data row runs its own pipeline
    pmesh = make_mesh((2, 4), ("data", "pp"), device="cpu")
    stages = pipeline_stages(torch.from_numpy(inp["pipe/w"]), 4)
    mine = stages[pmesh.get_local_rank("pp")]

    def stage_fn(wg, x):
        for i in range(wg.shape[0]):
            x = torch.tanh(x @ wg[i])
        return x
    res["pipe/out"] = pipeline_apply(mine, torch.from_numpy(inp["pipe/x"]),
                                     stage_fn, pmesh, "pp",
                                     microbatches=4).numpy()

    # constrain: a DTensor laid out by the rules, redistributed
    from torch.distributed.tensor import distribute_tensor
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rules = context.ShardingRules(mesh, {"batch": "data", "embed": "model"})
    dt = distribute_tensor(full, mesh, rules.placements(("batch", None)))
    with context.use_rules(rules):
        c = context.constrain(dt, ("batch", "embed"))
        res["constrain/plain"] = context.constrain(full, ("batch",
                                                          "embed")).numpy()
    res["constrain/placements"] = np.array(str(c.placements))
    res["constrain/local"] = c.to_local().numpy()
    res["constrain/want"] = context.local_shard(
        full, rules.spec(("batch", "embed")), mesh).numpy()
    res["constrain/full"] = c.full_tensor().numpy()
    res["local_mesh"] = np.array(make_local_mesh(device="cpu").shape)

    # int8 error-feedback psum over the model axis (4 ranks)
    mean, resid = compressed_psum(torch.from_numpy(inp[f"psum/g{rank}"]),
                                  mesh.get_group("model"),
                                  torch.from_numpy(inp[f"psum/r{rank}"]))
    res["psum/mean"], res["psum/residual"] = mean.numpy(), resid.numpy()
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded model's cells and their inputs
# ---------------------------------------------------------------------------
# The cells' global batch and sequence (the reference's TRAIN_LOWERS mesh
# test) and the train cells' learning rate
B, S = 8, 32
LR = 1e-3
# the leaves the reference initialises to zeros (norms, biases, the rwkv
# interpolations), given random values so that every one of them matters
NORMAL = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
          "k_norm", "lnx_b", "ba", "bi", "conv_b", "mu_x", "mu", "mu_k",
          "mu_r"}
# cell -> (arch, kinds, kv_quant, grad_accum)
CELLS = {
    "g2": ("gemma2-9b", "prefill,decode", False, 0),
    "g2q": ("gemma2-9b", "prefill,decode", True, 0),
    "g2t": ("gemma2-9b", "train", False, 2),
    "rg": ("recurrentgemma-2b", "prefill,decode", False, 0),
    "rgt": ("recurrentgemma-2b", "train", False, 1),
    "rw": ("rwkv6-7b", "prefill,decode", False, 0),
    "qw": ("qwen3-moe-235b-a22b", "train", False, 1),
    "pg": ("paligemma-3b", "prefill", False, 0),
    "pgt": ("paligemma-3b", "train", False, 1),
    "wh": ("whisper-small", "train", False, 1),
    "rg6t": ("recurrentgemma-2b", "train", False, 1),
    "wh6t": ("whisper-small", "train", False, 1),
    "whv": ("whisper-small", "train", False, 2),
    "rwt": ("rwkv6-7b", "train", False, 2),
    "rw2": ("rwkv6-7b", "prefill,decode", False, 0),
    # arctic-480b's step (Adafactor), its dense FFN beside the experts: the
    # gradient its output hands the FFN's product comes back cut on the
    # sequence unless the FFN's output is laid out as the experts' (C18)
    "art": ("arctic-480b", "train", False, 1),
}
# cell -> its global batch, where it is not B: ``rw2``'s decode step at 2
# rows a ``data`` rank, where DTensor left the LoRA's 160 columns cut over
# ``model`` and refused to view them as 5 groups of 32 (C17), as it did at
# the production meshes' 8 rows a rank over 16 ``model`` ranks
CELL_BATCH = {"rw2": 4}
# cell -> the config fields it replaces: the q-rows cells (C6, C7), whose
# 2 q heads spread over the 4 ``model`` ranks, each head's rows over 2;
# a q block of 8, so that paligemma's 32 positions take the prefix mask's
# q-block scan and whisper's 32 encoder positions the bidirectional scan
CELL_CONFIG = {
    "pg": {"n_heads": 2, "n_kv_heads": 1, "attn_q_block": 8},
    "pgt": {"n_heads": 2, "n_kv_heads": 1, "attn_q_block": 8},
    "wh": {"n_heads": 2, "n_kv_heads": 2, "attn_q_block": 8},
    # C10: 6 q heads on the 4 ``model`` ranks, 2 groups of 3, each group's
    # rows over 2: recurrentgemma-2b's one kv head (each group inside it),
    # its local attention through flash; whisper-small's 6 kv heads (each
    # group 3 whole ones), its encoder and cross-attention through the
    # plain dispatch, its decoder self-attention through flash
    "rg6t": {"n_heads": 6, "n_kv_heads": 1},
    "wh6t": {"n_heads": 6, "n_kv_heads": 6, "attn_q_block": 8},
    # C14: a vocab that the 4 ``model`` ranks do not divide, so the tied
    # table is whole on every rank and its head runs on each rank's rows
    "whv": {"vocab_size": 514},
}
# cell -> the relative tolerance of AdamW's m and v (the grads) against the
# unsharded port where it is not 1e-5: rwkv6-7b's two layers run the
# chunked wkv on each rank's batch and heads and the mixes' products on
# each rank's rows, which round in another order than the whole tensors'
# and which the per-head group norm amplifies (3.8e-5 at most, the same
# whether the gradients are reduced once a step or once a microbatch); the
# rwkv tests' f32 tolerance
GRAD_TOL = {"rwt": 1e-4}


def table_config(cell, base=get_smoke_config):
    """``CELLS[cell]``'s f32 config from ``base`` (a smoke config getter:
    the port's or the reference's), as ``cell_config`` reads it back."""
    arch, _, kv_quant, _ = CELLS[cell]
    return dataclasses.replace(base(arch), **{
        "param_dtype": "float32", "attn_q_block": 16, "kv_quant": kv_quant,
        **CELL_CONFIG.get(cell, {})})


def cell_tokens(cell) -> np.ndarray:
    """The cell's tokens, (batch, S + 1) int64: numpy draws."""
    return np.random.default_rng(list(CELLS).index(cell)).integers(
        2, table_config(cell).vocab_size,
        (CELL_BATCH.get(cell, B), S + 1)).astype(np.int64)


def seeded_model(cfg, seed: int):
    """The port's model of ``cfg`` on the CPU from a seeded
    ``torch.Generator``, each ``NORMAL`` leaf given numpy draws (the same
    on every process)."""
    from repro_torch.models import init_params
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.rpartition(".")[2] in NORMAL:
                p.add_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)) * 0.3).to(p.dtype))
    return model


KERNEL_SHAPES = {"q": (8, 16, 4, 2, 16), "k": (8, 16, 4, 16),
                 "v": (8, 16, 4, 16), "qf": (8, 16, 8, 16),
                 "kf": (8, 16, 2, 16), "vf": (8, 16, 2, 16),
                 "qr": (8, 16, 2, 16), "kr": (8, 16, 2, 16),
                 "vr": (8, 16, 2, 16),
                 "pq": (8, 16, 2, 16), "pk": (8, 16, 1, 16),
                 "pv": (8, 16, 1, 16), "bq": (8, 16, 2, 16),
                 "bk": (8, 16, 2, 16), "bv": (8, 16, 2, 16),
                 "xq": (8, 16, 2, 16), "xk": (8, 24, 2, 16),
                 "xv": (8, 24, 2, 16), "cq": (8, 16, 2, 16),
                 "ck": (8, 16, 2, 16), "cv": (8, 16, 2, 16),
                 "gq": (8, 16, 6, 16), "gk1": (8, 16, 1, 16),
                 "gv1": (8, 16, 1, 16), "gk6": (8, 16, 6, 16),
                 "gv6": (8, 16, 6, 16),
                 "hq": (8, 16, 2, 16), "hk": (8, 16, 1, 16),
                 "hv": (8, 16, 1, 16),
                 "a": (8, 16, 8), "b": (8, 16, 8),
                 "r": (8, 16, 4, 16), "wk": (8, 16, 4, 16),
                 "wv": (8, 16, 4, 16), "logw": (8, 16, 4, 16), "u": (4, 16)}


def kernel_inputs() -> dict:
    """``kern/*``: each kernel route's inputs and its outputs'
    cotangents (``kern/<tag>/ct<i>``), numpy draws."""
    rng = np.random.default_rng(7)
    inp = {f"kern/{n}": rng.standard_normal(s).astype(np.float32)
           for n, s in KERNEL_SHAPES.items()}
    inp["kern/a"] = rng.uniform(0.5, 1.0, KERNEL_SHAPES["a"]).astype(
        np.float32)
    inp["kern/logw"] = -rng.uniform(1e-3, 2.0, KERNEL_SHAPES["logw"]).astype(
        np.float32)
    for tag, shapes in (("flash", [KERNEL_SHAPES["q"]]),
                        ("flashq", [KERNEL_SHAPES["qf"]]),
                        ("flashr", [KERNEL_SHAPES["qr"]]),
                        ("plainp", [KERNEL_SHAPES["pq"]]),
                        ("plainb", [KERNEL_SHAPES["bq"]]),
                        ("plainx", [KERNEL_SHAPES["xq"]]),
                        ("plainc", [KERNEL_SHAPES["cq"]]),
                        ("scan", [KERNEL_SHAPES["a"]]),
                        ("wkv6", [KERNEL_SHAPES["r"], (8, 4, 16, 16)]),
                        ("plainh", [KERNEL_SHAPES["cq"]]),
                        *((tag, [KERNEL_SHAPES["gq"]])
                          for tag in GROUP_ROWS),
                        *((tag, [KERNEL_SHAPES["hq"]])
                          for tag in PLAIN_HEADS)):
        for i, shape in enumerate(shapes):
            inp[f"kern/{tag}/ct{i}"] = rng.standard_normal(shape).astype(
                np.float32)
    return inp


XENT_B, XENT_S, XENT_V = 8, 6, 512      # the vocab: 128 columns a rank


def xent_inputs() -> dict:
    """f32 logits and labels: every shard's first and last column among
    the labels, and ignored (-1) labels."""
    rng = np.random.default_rng(11)
    labels = rng.integers(0, XENT_V, (XENT_B, XENT_S))
    edges = [c for r in range(4) for c in (128 * r, 128 * r + 127)]
    labels.flat[:len(edges)] = edges
    labels.flat[-5:] = -1
    return {"xent/logits": 3 * rng.standard_normal(
        (XENT_B, XENT_S, XENT_V)).astype(np.float32),
            "xent/labels": labels}


def reduce_inputs() -> dict:
    """``reduce/g``: 8 blocks of partial sums (``run_reduce``)."""
    return {"reduce/g": np.random.default_rng(17).standard_normal(
        (8, 8, 6)).astype(np.float32)}


# arch -> an expert count that does not divide the 4 ``model`` ranks
MOE_DENSE = {"qwen3-moe-235b-a22b": 6, "arctic-480b": 6}


def moe_dense_config(arch, base):
    """``MOE_DENSE[arch]``'s f32 config from ``base`` (a smoke config
    getter: the port's or the reference's)."""
    cfg = dataclasses.replace(base(arch), param_dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=MOE_DENSE[arch]))


def build_inputs(weights) -> dict:
    """The ranks' INPUTS for ``sharded_main``: every cell of ``CELLS`` and
    every part's, numpy.  ``weights`` gives what differs between the
    reference's weights and the port's own: ``cell(cell)`` (the cell's
    model), ``batch(cell)`` (a ``CELL_CONFIG`` cell's synthetic train
    batch, numpy), ``rwkv(tag)`` (``RWKV_CONFIG[tag]``'s model),
    ``attention(i, tag)`` ({wq, wk, wv, wo} of ``GROUP_LAYERS[tag]``) and
    ``moe(i, arch)`` (``MOE_DENSE[arch]``'s MoE weights, the dense FFN's
    under ``dense/``); tokens, x and cotangents are numpy draws."""
    inp = {"cells": np.array(",".join(CELLS)), **kernel_inputs(),
           **xent_inputs(), **reduce_inputs()}
    for cell, (arch, kinds, kv_quant, accum) in CELLS.items():
        inp[f"{cell}/arch"] = np.array(arch)
        inp[f"{cell}/kinds"] = np.array(kinds)
        inp[f"{cell}/kv_quant"] = np.array(kv_quant)
        inp[f"{cell}/accum"] = np.array(accum)
        inp[f"{cell}/tokens"] = cell_tokens(cell)
        if cell in CELL_CONFIG:
            inp[f"{cell}/config"] = np.array(json.dumps(CELL_CONFIG[cell]))
            batch = weights.batch(cell)
            inp.update({f"{cell}/batch/{k}": v for k, v in batch.items()
                        if kinds == "train" or k != "labels"})
        for n, p in weights.cell(cell).named_parameters():
            inp[f"{cell}/p/{n}"] = p.detach().numpy()
    for i, tag in enumerate(RWKV_CONFIG):
        model = weights.rwkv(tag)
        inp.update({f"{tag}/p/{n}": p.detach().numpy()
                    for n, p in model.named_parameters()})
        rng = np.random.default_rng(13 + i)
        d = rwkv_config(tag, get_smoke_config).d_model
        for n in ("x_tm", "x_cm", "ct_tm", "ct_cm"):
            inp[f"{tag}/{n}"] = rng.standard_normal((B, S, d)).astype(
                np.float32)
    for i, tag in enumerate(GROUP_LAYERS):
        inp.update({f"{tag}/{n}": v
                    for n, v in weights.attention(i, tag).items()})
        rng = np.random.default_rng(30 + i)
        d = group_layer_config(tag, get_smoke_config).d_model
        for n in ("x", "ct"):
            inp[f"{tag}/{n}"] = rng.standard_normal((B, 16, d)).astype(
                np.float32)
    inp["moed/archs"] = np.array(",".join(MOE_DENSE))
    for i, arch in enumerate(MOE_DENSE):
        pre = f"moed/{arch}/"
        inp.update({pre + n: v for n, v in weights.moe(i, arch).items()})
        rng = np.random.default_rng(20 + i)
        d = moe_dense_config(arch, get_smoke_config).d_model
        inp[pre + "x"] = rng.standard_normal((B, S, d)).astype(np.float32)
        inp[pre + "ct"] = rng.standard_normal((B, S, d)).astype(np.float32)
        inp[pre + "ct_aux"] = np.array(rng.standard_normal(), np.float32)
        inp[pre + "experts"] = np.array(MOE_DENSE[arch])
    return inp


def cell_config(inp, cell):
    """The f32 config of a cell (``<cell>/arch``, ``<cell>/kv_quant``) with
    the reference's ``attn_q_block=16`` of TRAIN_LOWERS, and the fields
    ``<cell>/config`` (JSON) replaces, where the cell has it: the smoke
    config, or the full one where ``<cell>/width`` is ``full``."""
    arch = str(inp[f"{cell}/arch"])
    full = str(inp.get(f"{cell}/width", "smoke")) == "full"
    cfg = get_config(arch) if full else get_smoke_config(arch)
    over = json.loads(str(inp.get(f"{cell}/config", "{}")))
    return dataclasses.replace(cfg, **{
        "param_dtype": "float32", "attn_q_block": 16,
        "kv_quant": bool(inp[f"{cell}/kv_quant"]), **over})


def cell_batch(inp, cell, tokens, kind):
    """The cell's train or prefill batch: its ``<cell>/batch/*`` arrays
    where it has them (whisper's ``frames``, paligemma's ``patches``;
    prefill without ``labels``), else from its tokens."""
    pre = f"{cell}/batch/"
    given = {k[len(pre):]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith(pre) and (kind == "train" or
                                       not k.endswith("/labels"))}
    if given:
        return given
    if kind == "train":
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return {"tokens": tokens[:, :-1]}


def cell_model(inp, cell, cfg):
    """The port's model from (copies of) the cell's weights, keyed by
    parameter name, or, where INPUTS holds none, ``seeded_model`` of
    ``<cell>/seed``; a train step leaves INPUTS as they were."""
    from repro_torch.models import init_params
    pre = f"{cell}/p/"
    if f"{cell}/seed" in inp:
        return seeded_model(cfg, int(inp[f"{cell}/seed"]))
    model = init_params(cfg, None, device="meta")
    model.load_state_dict({k[len(pre):]: torch.from_numpy(v).clone()
                           for k, v in inp.items() if k.startswith(pre)},
                          assign=True)
    return model


def cell_shape(kind, B, S):
    return dataclasses.replace(
        LM_SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                   "decode": "decode_32k"}[kind]], seq_len=S, global_batch=B)


def full(t):
    """A copy of the whole tensor (decode writes into a cache in place)."""
    return (t.full_tensor() if context.is_dtensor(t) else t).clone()


def cache_leaves(cache):
    return [e[n] for part in ("blocks", "tail") for e in cache[part]
            for n in sorted(e)]


@contextlib.contextmanager
def seeing_q_rows(seen):
    """Note in the Counter ``seen`` each q-rows route the model takes, by
    kernel name (``heads.run_q_rows``: flash's and the plain dispatch's),
    and each k or v projection by its placement on ``model``
    (``kv_columns``), under ``kv/columns`` (cut by columns) or
    ``kv/whole``."""
    from repro_torch.distributed import heads
    from repro_torch.models import attention as tattn
    run, cols = heads.run_q_rows, tattn.kv_columns

    def route(kernel, *args):
        seen[kernel] += 1
        return run(kernel, *args)

    def columns(w, q):
        out = cols(w, q)
        cut = out.placements[1].is_shard(1)
        seen["kv/" + ("columns" if cut else "whole")] += 1
        return out
    heads.run_q_rows = route
    tattn.kv_columns = columns
    try:
        yield seen
    finally:
        heads.run_q_rows = run
        tattn.kv_columns = cols


def run_cell(inp, cell, mesh, res, grad_accum=2, lr=1e-3):
    """``run_cell_at`` under ``seeing_q_rows``; what it saw as JSON in
    ``<cell>/routes``."""
    with seeing_q_rows(collections.Counter()) as seen:
        run_cell_at(inp, cell, mesh, res, grad_accum, lr)
    res[f"{cell}/routes"] = np.array(json.dumps(seen))


def run_cell_at(inp, cell, mesh, res, grad_accum=2, lr=1e-3):
    """Prefill (and decode at the next position), or one train step with
    ``grad_shardings`` and ``update_constraint`` set (ZeRO, from
    ``opt_pspecs``), of the cell's sharded model; the outputs in full."""
    from repro_torch.distributed.layouts import (
        batch_pspecs, cache_pspecs, distribute_tree, opt_pspecs,
        param_placements, param_pspecs, shard_params)
    from repro_torch.models import forward_decode, forward_prefill
    from repro_torch.optim import make_optimizer
    from repro_torch.train import steps as tsteps
    cfg = cell_config(inp, cell)
    tokens = torch.from_numpy(inp[f"{cell}/tokens"])
    B, S = tokens.shape[0], tokens.shape[1] - 1
    kinds = str(inp[f"{cell}/kinds"]).split(",")
    model = cell_model(inp, cell, cfg)
    if "train" in kinds:
        rules = choose_layout(cfg, cell_shape("train", B, S), mesh)
        shard_params(model, cfg, rules, mesh)
        gshard = param_placements(
            model, cfg, opt_pspecs(param_pspecs(model, cfg, rules), model,
                                   cfg, mesh), mesh)
        opt = make_optimizer(cfg.optimizer, cfg=cfg, update_constraint=gshard)
        state = tsteps.init_train_state(None, cfg, opt, params=model)
        step = tsteps.build_train_step(cfg, opt, lambda s: lr,
                                       grad_accum=int(inp[f"{cell}/accum"]),
                                       grad_shardings=gshard)
        batch = cell_batch(inp, cell, tokens, "train")
        batch = distribute_tree(batch, batch_pspecs(batch, rules), mesh)
        with context.use_rules(rules):
            state, metrics = step(state, batch)
        for k in ("loss", "grad_norm"):
            res[f"{cell}/{k}"] = full(metrics[k]).numpy()
        for n, p in model.named_parameters():
            res[f"{cell}/new/{n}"] = full(p.detach()).numpy()
            for k in ("m", "v"):
                if k in state["opt"]:
                    res[f"{cell}/{k}/{n}"] = full(state["opt"][k][n]).numpy()
        res[f"{cell}/grad_placements"] = np.array(
            [str(gshard[n]) for n, _ in model.named_parameters()])
        return
    rules = choose_layout(cfg, cell_shape("prefill", B, S), mesh)
    shard_params(model, cfg, rules, mesh)
    batch = cell_batch(inp, cell, tokens, "prefill")
    batch = distribute_tree(batch, batch_pspecs(batch, rules), mesh)
    with context.use_rules(rules):
        logits, cache = forward_prefill(model, cfg, batch)
    res[f"{cell}/prefill/logits"] = full(logits).numpy()
    for i, t in enumerate(cache_leaves(cache)):
        res[f"{cell}/prefill/cache{i}"] = full(t).numpy()
    if "decode" not in kinds:
        return
    rules = choose_layout(cfg, cell_shape("decode", B, S), mesh)
    cache = distribute_tree(cache, cache_pspecs(cache, cfg, rules), mesh)
    res[f"{cell}/cache_placements"] = np.array(
        [str(t.placements) for t in cache_leaves(cache)])
    tok = {"tokens": tokens[:, -1:]}
    tok = distribute_tree(tok, batch_pspecs(tok, rules), mesh)["tokens"]
    with context.use_rules(rules):
        logits, cache = forward_decode(model, cfg, cache, tok, S)
    res[f"{cell}/decode/logits"] = full(logits).numpy()
    for i, t in enumerate(cache_leaves(cache)):
        res[f"{cell}/decode/cache{i}"] = full(t).numpy()


# the plain dispatch's q-rows route (``models.attention.attention_q_rows``)
# on flat q of 2 heads over the 4 ``model`` ranks, each head's 16 rows
# split 2 ways: tag -> (the inputs q, k, v, the route's keywords, the
# attention hook: None, or the name of one in ``models.attention``).  The
# prefix mask's 5 positions fill no row block (8) nor q block (4); cross
# attention's 24 keys are not q's 16 rows; the causal mask with a window
# of 6, with the hook off and with ``plain_attention`` as the hook (handed
# each rank's q0)
PLAIN_ROWS = {
    "plainp": (("pq", "pk", "pv"), {"mask_mode": "prefix", "prefix_len": 5},
               None),
    "plainb": (("bq", "bk", "bv"), {"mask_mode": "bidir"}, None),
    "plainx": (("xq", "xk", "xv"), {"mask_mode": "bidir", "cross": True},
               None),
    "plainc": (("cq", "ck", "cv"), {"mask_mode": "causal", "window": 6},
               None),
    "plainh": (("cq", "ck", "cv"), {"mask_mode": "causal", "window": 6},
               "plain_attention"),
}
PLAIN_ROWS_KW = {"scale": 0.25, "q_block": 4, "pack": True}
# the plain dispatch's q-heads route (C11, ``models.attention.
# attention_q_heads``): 2 flat q heads cut over the 2 ``data`` ranks (the
# batch over the 4 ``model`` ranks), 1 kv head whole there, which both
# read; the prefix mask over 5 positions and the bidirectional one, at
# ``PLAIN_ROWS_KW``: tag -> (the inputs q, k, v, the route's keywords)
PLAIN_HEADS = {
    "plainqp": (("hq", "hk", "hv"), {"mask_mode": "prefix",
                                     "prefix_len": 5}),
    "plainqb": (("hq", "hk", "hv"), {"mask_mode": "bidir"}),
}
# the q-rows route by head groups: tag -> its k and v inputs (q is ``gq``,
# 6 heads): flash under a causal mask with a window of 6, the plain
# dispatch under the bidirectional one (the rectangle scan at q blocks of
# 4), each with 1 kv head and with 6
GROUP_ROWS = {"flashg1": ("gk1", "gv1"), "flashg6": ("gk6", "gv6"),
              "plaing1": ("gk1", "gv1"), "plaing6": ("gk6", "gv6")}


def run_kernels(inp, mesh, res):
    """Each kernel wrapper on DTensors of the inputs ``kern/*`` placed so
    that some are cut locally (flash's k, the scan's b, the wkv6's u over
    ``model``) and some gradients are ``Partial`` (u over ``data``), and
    flash's q-heads route (flat q cut on its heads over ``model``, k and v
    whole there) and its q-rows route (flat q of fewer heads than ``model``
    ranks, whole there, each rank one block of one head's rows); the
    outputs, the input gradients of a random cotangent
    and the output placements, in full; and the plain dispatch's q-rows
    route (``PLAIN_ROWS``) and q-heads route (``PLAIN_HEADS``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_chunk import wkv6
    from repro_torch.models import attention as tattn

    def dt(name, *place):
        t = distribute_tensor(torch.from_numpy(inp[f"kern/{name}"]), mesh,
                              place)
        return t.requires_grad_()

    def record(tag, outs, ins):
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, [distribute_tensor(
            torch.from_numpy(inp[f"kern/{tag}/ct{i}"]), mesh, o.placements)
            for i, o in enumerate(outs)])
        for i, o in enumerate(outs):
            res[f"kern/{tag}/out{i}"] = full(o.detach()).numpy()
            res[f"kern/{tag}/place{i}"] = np.array(str(o.placements))
        for n, t in ins.items():
            res[f"kern/{tag}/grad/{n}"] = full(t.grad).numpy()
    ins = {"q": dt("q", Shard(0), Shard(2)),
           "k": dt("k", Shard(0), Replicate()),
           "v": dt("v", Replicate(), Shard(2))}
    record("flash", flash_attention(*ins.values(), scale=0.25, q_block=512, pack=True), ins)
    # the q-heads route: 8 flat q heads over 4 ranks, 2 kv heads whole
    ins = {"qf": dt("qf", Shard(0), Shard(2)),
           "kf": dt("kf", Shard(0), Replicate()),
           "vf": dt("vf", Replicate(), Replicate())}
    record("flashq", flash_attention(*ins.values(), scale=0.25, q_block=512, pack=True),
           ins)
    # the q-rows route: 2 flat q heads over 4 ranks, each head's 16 rows
    # split 2 ways, 2 kv heads whole; a window of 6
    ins = {"qr": dt("qr", Shard(0), Replicate()),
           "kr": dt("kr", Shard(0), Replicate()),
           "vr": dt("vr", Replicate(), Replicate())}
    record("flashr", flash_attention(*ins.values(), scale=0.25, window=6,
                                     q_block=512, pack=True), ins)
    # the q-rows route by head groups (C10): 6 flat q heads over 4 ranks,
    # 2 groups of 3, each group's 16 rows split 2 ways; 1 kv head (a group
    # inside it) or 6 (a group of 3 whole kv heads)
    for tag, kv in GROUP_ROWS.items():
        ins = {"gq": dt("gq", Shard(0), Replicate()),
               kv[0]: dt(kv[0], Shard(0), Replicate()),
               kv[1]: dt(kv[1], Replicate(), Replicate())}
        if tag.startswith("flash"):
            record(tag, flash_attention(*ins.values(), scale=0.25, window=6,
                                        q_block=512, pack=True), ins)
        else:
            record(tag, tattn.attention_q_rows(*ins.values(),
                                               mask_mode="bidir",
                                               **PLAIN_ROWS_KW), ins)
    hook = tattn._ATTN_IMPL
    try:
        for tag, (names, kw, use) in PLAIN_ROWS.items():
            tattn.set_attention_impl(use and getattr(tattn, use))
            ins = dict(zip(names, (dt(names[0], Shard(0), Replicate()),
                                   dt(names[1], Shard(0), Replicate()),
                                   dt(names[2], Replicate(), Replicate()))))
            record(tag, tattn.attention_q_rows(*ins.values(), **kw,
                                               **PLAIN_ROWS_KW), ins)
    finally:
        tattn.set_attention_impl(hook)
    for tag, (names, kw) in PLAIN_HEADS.items():
        ins = dict(zip(names, (dt(names[0], Shard(2), Shard(0)),
                               dt(names[1], Replicate(), Shard(0)),
                               dt(names[2], Replicate(), Replicate()))))
        record(tag, tattn.attention_q_heads(*ins.values(), **kw,
                                            **PLAIN_ROWS_KW), ins)
    ins = {"a": dt("a", Shard(0), Shard(2)), "b": dt("b", Replicate(),
                                                     Replicate())}
    record("scan", rglru_scan(*ins.values()), ins)
    ins = {n: dt(n, Shard(0), Shard(2)) for n in ("r", "wk", "wv", "logw")}
    ins["u"] = dt("u", Replicate(), Replicate())
    record("wkv6", wkv6(*ins.values()), ins)


# the q-rows route by head groups in the attention layer (C10): tag ->
# (arch, kv heads, the layer's kind, its mask); 6 q heads on the 4
# ``model`` ranks: recurrentgemma-2b's local attention (a window of 6)
# through flash, whisper-small's bidirectional encoder attention through
# the plain dispatch (the rectangle scan at q blocks of 4)
GROUP_LAYERS = {"attng1": ("recurrentgemma-2b", 1, "local", "causal"),
                "attng6": ("whisper-small", 6, "global", "bidir")}


def group_layer_config(tag, base):
    """``GROUP_LAYERS[tag]``'s f32 config from ``base`` (a smoke config
    getter: the port's or the reference's)."""
    arch, K, _, _ = GROUP_LAYERS[tag]
    return dataclasses.replace(base(arch), param_dtype="float32", n_heads=6,
                               n_kv_heads=K, window_size=6, attn_q_block=4)


def run_group_layers(inp, mesh, res):
    """``attention_seq`` of each ``GROUP_LAYERS`` cell on x (``<tag>/x``)
    as the layer hands it over (whole over ``model``), the projections
    placed by the rules (wq and wo split on ``heads_flat``, wk and wv
    whole: the kv heads do not split over 4); the output, reduced over
    ``model``, and the gradients of x and of each projection for the
    cotangent ``<tag>/ct``, in full."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import attention as tattn
    for tag, (_, _, kind, mask) in GROUP_LAYERS.items():
        cfg = group_layer_config(tag, get_smoke_config)
        x = torch.from_numpy(inp[f"{tag}/x"])
        rules = choose_layout(cfg, cell_shape("train", *x.shape[:2]), mesh)
        logical = {"wq": (None, "heads_flat"), "wk": (None, None),
                   "wv": (None, None), "wo": ("heads_flat", None)}
        p = tattn.Attention({
            n: distribute_tensor(torch.from_numpy(inp[f"{tag}/{n}"]), mesh,
                                 rules.placements(lg))
            for n, lg in logical.items()}).requires_grad_()
        rows = rules.placements(("batch", "seq", None))
        xd = distribute_tensor(x, mesh, rows).requires_grad_()
        ct = distribute_tensor(torch.from_numpy(inp[f"{tag}/ct"]), mesh, rows)
        pos = torch.arange(x.shape[1]).expand(x.shape[:2])
        with context.use_rules(rules), context.replicate_made_tensors(p.wq):
            o, _ = tattn.attention_seq(p, xd, cfg, kind, pos, mask)
            o = context.constrain(o, ("batch", "seq", None))
            o.backward(ct)
        res[f"{tag}/out"] = full(o.detach()).numpy()
        res[f"{tag}/grad/x"] = full(xd.grad).numpy()
        for n, t in p.named_parameters():
            res[f"{tag}/grad/{n}"] = full(t.grad).numpy()


# rwkv6-7b's one-layer smoke config: tag -> the fields it replaces.  Its 4
# heads split over the 4 ``model`` ranks (the wkv6 by heads, C9); with a
# head dim of 32, 2 heads do not (each rank's block of rows from a zero
# state, the state carried across the blocks, C13)
RWKV_CONFIG = {"rwkv": {}, "rwkv2": {"rwkv_head_dim": 32}}


def rwkv_config(tag, base):
    """``RWKV_CONFIG[tag]``'s f32 one-layer config from ``base`` (a smoke
    config getter: the port's or the reference's)."""
    return dataclasses.replace(base("rwkv6-7b"), n_layers=1,
                               param_dtype="float32", **RWKV_CONFIG[tag])


def run_rwkv(inp, mesh, res):
    """For each ``RWKV_CONFIG`` tag, rwkv6-7b's time mix and channel mix
    (its weights ``<tag>/p/*`` placed by the model's rules) on x
    (``<tag>/x_tm``, ``<tag>/x_cm``) laid out as the residual stream (rows
    cut over ``model``, C9): the outputs, the state and last rows, and the
    gradients of x and of every weight for the cotangents ``<tag>/ct_*``,
    in full; the operand shapes of the rank's products."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.layouts import shard_params
    from repro_torch.models import rwkv as trwkv
    from repro_torch.roofline.trace import OpTrace
    for tag in RWKV_CONFIG:
        cfg = rwkv_config(tag, get_smoke_config)
        model = cell_model(inp, tag, cfg)
        x_tm, x_cm = (torch.from_numpy(inp[f"{tag}/x_{n}"])
                      for n in ("tm", "cm"))
        rules = choose_layout(cfg, cell_shape("train", *x_tm.shape[:2]),
                              mesh)
        shard_params(model, cfg, rules, mesh)
        layer = model.layers[0].requires_grad_()
        rows = rules.placements(("batch", "act_seq", None))
        xs = [distribute_tensor(x, mesh, rows).requires_grad_()
              for x in (x_tm, x_cm)]
        cts = [distribute_tensor(torch.from_numpy(inp[f"{tag}/ct_{n}"]),
                                 mesh, rows) for n in ("tm", "cm")]
        with context.use_rules(rules), context.replicate_made_tensors(
                layer.tm.wr), context.native_alltoall(), \
                OpTrace() as trace:
            outs = (*trwkv.time_mix_seq(layer.tm, xs[0], cfg),
                    *trwkv.channel_mix(layer.cm, xs[1]))
            # the outputs at the residual stream's rows, as x
            torch.autograd.backward([outs[0], outs[3]], cts)
        for name, o in zip(("tm", "state", "tm_last", "cm", "cm_last"),
                           outs):
            res[f"{tag}/out/{name}"] = full(o.detach()).numpy()
        for n, x in zip(("tm", "cm"), xs):
            res[f"{tag}/grad/x_{n}"] = full(x.grad).numpy()
        for n, p in (*layer.tm.named_parameters(prefix="tm"),
                     *layer.cm.named_parameters(prefix="cm")):
            res[f"{tag}/grad/{n}"] = full(p.grad).numpy()
        res[f"{tag}/products"] = np.array(json.dumps(
            [op.operands for op in trace.ops if op.operands]))


# C15: partial sums over ``pod`` and ``data`` (2 x 2, and ``model`` 2 more)
# -> the placements each case reduces them to: tag -> (the partial sums'
# placements, the target's), on the (2, 2, 2) ("pod", "data", "model")
# mesh; "P" Partial, "R" Replicate, "S0"/"S1" Shard(0)/Shard(1)
REDUCE_CASES = {"rr": ("PPR", ("R", "R", "R")),
                "zero": ("PPR", ("R", "S0", "R")),
                "all": ("PPP", ("R", "S0", "S1"))}


def run_reduce(inp, res):
    """Each ``REDUCE_CASES`` case on the ranks' partial sums (``reduce/g``,
    (8, 6) f32 blocks: one a (pod, data) coordinate, or one a rank where
    ``model`` holds partial sums too): DTensor's own
    ``redistribute`` (one collective a mesh dim), every case first, then
    ``context.redistribute`` (one collective over the partial dims
    flattened, ``reduce_flat``; made second, since DTensor then takes a
    flattened mesh of its own accord); the results in full and each
    run's collectives as (kind, ranks) pairs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.roofline.trace import OpTrace
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    place = {"P": Partial(), "R": Replicate(), "S0": Shard(0),
             "S1": Shard(1)}

    def partial(tag):
        # the ranks' own blocks: one a (pod, data) coordinate where the
        # sums are whole over ``model``, else one a rank
        held = REDUCE_CASES[tag][0]
        n = 8 if held[2] == "P" else 4
        local = torch.from_numpy(inp["reduce/g"][dist.get_rank() * n // 8])
        return DTensor.from_local(local.clone(), mesh, tuple(
            place[c] for c in held), run_check=False)
    for how, fn in (("steps", lambda t, p: t.redistribute(mesh, p)),
                    ("flat", context.redistribute)):
        for tag, (_, target) in REDUCE_CASES.items():
            with OpTrace() as trace:
                out = fn(partial(tag), tuple(place[c] for c in target))
            res[f"reduce/{tag}/{how}"] = full(out).numpy()
            res[f"reduce/{tag}/{how}/collectives"] = np.array(json.dumps(
                [(c[0], c[4]) for c in trace.collectives]))


def run_loss(inp, mesh, res):
    """``softmax_xent`` of the logits ``xent/logits`` sharded on the vocab
    over ``model`` and on the batch over ``data`` (the labels on the batch):
    the loss, the token count and the logits' gradient in full, the
    gradient's placements, and the trace's collectives."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.losses import softmax_xent
    from repro_torch.roofline.trace import OpTrace, collective_stats
    logits = distribute_tensor(torch.from_numpy(inp["xent/logits"]), mesh,
                               (Shard(0), Shard(2))).requires_grad_()
    labels = distribute_tensor(torch.from_numpy(inp["xent/labels"]), mesh,
                               (Shard(0), Replicate()))
    with OpTrace() as trace:
        loss, n = softmax_xent(logits, labels)
        loss.backward()
    res["xent/loss"] = full(loss.detach()).numpy()
    res["xent/n"] = full(n).numpy()
    res["xent/grad"] = full(logits.grad).numpy()
    res["xent/grad_place"] = np.array(str(logits.grad.placements))
    res["xent/stats"] = np.array(json.dumps(collective_stats(trace)))


MOE_DENSE_LOGICAL = {"router": (None, None),
                     "w_gate": ("experts", None, "moe_ff"),
                     "w_up": ("experts", None, "moe_ff"),
                     "w_down": ("experts", "moe_ff", None),
                     "dense/w_gate": (None, "ff"), "dense/w_up": (None, "ff"),
                     "dense/w_down": ("ff", None)}


def run_moe_dense(inp, mesh, res):
    """``moe_layer`` in the DTensor model where the experts do not split
    over ``model`` (``moed/<arch>/*``: weights placed by the model's rules,
    x by ``("batch", "act_seq", None)``): y, aux and the gradients of x and
    every weight for the cotangents ``ct`` (y) and ``ct_aux`` (aux), in
    full."""
    from torch.distributed.tensor import distribute_tensor
    for arch in str(inp["moed/archs"]).split(","):
        pre = f"moed/{arch}/"
        cfg = dataclasses.replace(
            get_smoke_config(arch), param_dtype="float32")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=int(inp[pre + "experts"])))
        x = torch.from_numpy(inp[pre + "x"])
        rules = choose_layout(cfg, cell_shape("train", x.shape[0],
                                              x.shape[1]), mesh)

        def dt(t, logical):
            return distribute_tensor(t, mesh, rules.placements(logical))
        w = {n: dt(torch.from_numpy(inp[pre + n]), lg)
             for n, lg in MOE_DENSE_LOGICAL.items() if pre + n in inp}
        dense = {n[len("dense/"):]: t for n, t in w.items()
                 if n.startswith("dense/")}
        p = tmoe.MoE({n: w[n] for n in ("router", "w_gate", "w_up",
                                        "w_down")},
                     MLP(dense) if dense else None).requires_grad_()
        ins = {n.replace(".", "/"): t for n, t in p.named_parameters()}
        ins["x"] = dt(x, ("batch", "act_seq", None)).requires_grad_()
        with context.use_rules(rules):
            y, aux = tmoe.moe_layer(p, ins["x"], cfg)
        torch.autograd.backward(
            [y, aux], [distribute_tensor(torch.from_numpy(inp[pre + "ct"]),
                                         mesh, y.placements),
                       distribute_tensor(torch.from_numpy(inp[pre + "ct_aux"]),
                                         mesh, aux.placements)])
        res[pre + "y"] = full(y.detach()).numpy()
        res[pre + "aux"] = full(aux.detach()).numpy()
        for n, t in ins.items():
            res[f"{pre}grad/{n}"] = full(t.grad).numpy()


TRACE_ARCH, TRACE_B, TRACE_S, TRACE_ACCUM = "gemma2-9b", 8, 32, 2


def trace_summary(trace) -> dict:
    """What the fake world's trace is compared on: the op names and
    counts, the flops, ``collective_stats`` and the largest all-gather
    output."""
    from repro_torch.roofline.trace import collective_stats
    return {"ops": json.dumps(collections.Counter(op.name
                                                  for op in trace.ops)),
            "flops": np.array(trace.flops),
            "collectives": json.dumps(collective_stats(trace)),
            "largest_gather": np.array(max(
                (out for kind, _, out, _, _ in trace.collectives
                 if kind == "all-gather"), default=0))}


def traced_train_step(mesh):
    """Rank 0's trace of one sharded f32 smoke train step of
    ``TRACE_ARCH`` (``launch.dryrun.run_step`` on CPU tensors), and the
    shapes of the q its flash calls hand the kernel wrapper."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_smoke_config(TRACE_ARCH),
                              param_dtype="float32")
    seen, bkg = set(), ops.flash_attention_bkg

    def seeing(q, k, v, **kw):
        seen.add(tuple(q.shape))
        return bkg(q, k, v, **kw)
    ops.flash_attention_bkg = seeing
    try:
        trace, _ = dryrun.run_step(cfg, ShapeConfig("s", "train", TRACE_S,
                                                    TRACE_B),
                                   mesh, grad_accum=TRACE_ACCUM, device="cpu")
    finally:
        ops.flash_attention_bkg = bkg
    return {**trace_summary(trace), "flash_q": json.dumps(sorted(seen))}


def run_dryrun_checks(mesh, res):
    """``_microbatch`` at ``grad_accum`` 4 on 8 data ranks (rows in full);
    Shard(0) -> Shard(1) over ``data`` under ``native_alltoall`` (rank 0's
    shard and the trace's collectives); rank 0's trace of a train step."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.roofline.trace import OpTrace, collective_stats
    from repro_torch.train import steps as tsteps
    full = torch.arange(64 * 4).reshape(64, 4)
    data8 = make_mesh((8,), ("data",), device="cpu")
    rows = distribute_tensor(full, data8, (Shard(0),))
    with context.use_rules(context.ShardingRules(data8, {"batch": "data"})):
        for i in range(4):
            mb = tsteps._microbatch(rows, 4, i)
            res[f"mb/{i}"] = mb.full_tensor().numpy()
            res[f"mb/place{i}"] = np.array(str(mb.placements))
    x = distribute_tensor(torch.arange(8 * 12, dtype=torch.float32).reshape(
        8, 12), mesh, (Shard(0), Replicate()))
    with context.native_alltoall(), OpTrace() as trace:
        y = x.redistribute(mesh, (Shard(1), Replicate()))
    res["a2a/local"] = y.to_local().numpy()
    res["a2a/stats"] = np.array(json.dumps(collective_stats(trace)))
    with context.native_alltoall():
        for k, v in traced_train_step(mesh).items():
            res[f"trace/{k}"] = np.array(v)


# ---------------------------------------------------------------------------
# the unsharded port, which the ranks' results are held to
# ---------------------------------------------------------------------------
def adamw_ratio(m, v, count=1, b1=0.9, b2=0.95, eps=1e-8):
    """AdamW's step direction from its state (optimizers.adamw), f64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - b1 ** count)) / (np.sqrt(v / (1 - b2 ** count)) + eps)


def split(batch, n=2):
    """The data shards of a (micro)batch: n contiguous row blocks."""
    return [{k: v[i * len(v) // n:(i + 1) * len(v) // n]
             for k, v in batch.items()} for i in range(n)]


def per_shard_step(cfg, model, opt, batch, grad_accum, lr=LR):
    """One step of the port, plain, with the sharded MoE's semantics: each
    data shard's rows through the model on their own, one cross-entropy
    over their logits, the aux the shards' mean."""
    from repro_torch.models import forward_train
    from repro_torch.models.losses import softmax_xent
    from repro_torch.train import steps as tsteps
    state = tsteps.init_train_state(None, cfg, opt, params=model)
    params = dict(model.named_parameters())
    loss = 0.0
    for mb in split(batch, grad_accum):
        outs = [forward_train(model, cfg, {"tokens": s["tokens"]})
                for s in split(mb)]
        xent, _ = softmax_xent(torch.cat([o[0] for o in outs]), mb["labels"])
        (xent + tsteps.AUX_COEF * (outs[0][1] + outs[1][1]) / 2).backward()
        loss = loss + xent.detach() / grad_accum
    for p in params.values():
        p.grad.div_(grad_accum)
    _, _, gn = opt.update({n: p.grad for n, p in params.items()},
                          state["opt"], params, torch.tensor(lr))
    return {"loss": loss, "grad_norm": gn}


def port_outputs(cfg, model, kinds, accum, tokens, batch_of, lr=LR):
    """The unsharded port's outputs of a cell, keyed as ``run_cell``'s:
    prefill (and decode at the next position) -> {"prefill": [logits,
    *cache leaves], "decode": [...]}; or one train step (the MoE's with
    ``per_shard_step``) -> loss, grad norm, the new parameters and AdamW's
    m and v.  ``tokens``: (batch, S + 1); ``batch_of(kind)``: the train
    or prefill batch, tensors."""
    from repro_torch.models import forward_decode, forward_prefill
    from repro_torch.optim import make_optimizer
    from repro_torch.train import steps as tsteps
    out = {}
    if kinds == "train":
        batch = batch_of("train")
        opt = make_optimizer(cfg.optimizer, cfg=cfg)
        if cfg.moe is not None:
            metrics = per_shard_step(cfg, model, opt, batch, accum, lr)
        else:
            state = tsteps.init_train_state(None, cfg, opt, params=model)
            step = tsteps.build_train_step(cfg, opt, lambda s: lr,
                                           grad_accum=accum)
            _, metrics = step(state, batch)
        out.update({k: float(metrics[k]) for k in ("loss", "grad_norm")})
        out["new"] = {n: p.detach().numpy()
                      for n, p in model.named_parameters()}
        if opt.name == "adamw":
            for k in ("m", "v"):
                out[k] = {n: t.numpy() for n, t in state["opt"][k].items()}
        return out
    logits, cache = forward_prefill(model, cfg, batch_of("prefill"))
    # copies: decode writes into the cache in place
    out["prefill"] = [logits.numpy()] + [t.numpy().copy()
                                         for t in cache_leaves(cache)]
    if "decode" in kinds:
        logits, cache = forward_decode(model, cfg, cache, tokens[:, -1:],
                                       tokens.shape[1] - 1)
        out["decode"] = [logits.numpy()] + [t.numpy() for t in
                                            cache_leaves(cache)]
    return out


def port_run(inp, cell):
    """``port_outputs`` of a cell of INPUTS: its config, weights, tokens
    and batches as the ranks read them."""
    cfg = cell_config(inp, cell)
    tokens = torch.from_numpy(inp[f"{cell}/tokens"])
    return port_outputs(cfg, cell_model(inp, cell, cfg),
                        str(inp[f"{cell}/kinds"]), int(inp[f"{cell}/accum"]),
                        tokens, lambda kind: cell_batch(inp, cell, tokens,
                                                        kind))


def whole_rows_case(attn, xp, tag, q, k, v):
    """The dispatch branch that ``tag`` of ``PLAIN_ROWS`` (or of
    ``PLAIN_HEADS``, the same masks) takes, on whole tensors: flat q
    (B,S,H,hd) -> (B,S,H,hd) through ``attn``'s ``_qblock_scan`` under the
    prefix mask, ``_rect_scan``, ``_sdpa`` (cross) or ``_qblock_scan``
    under the causal mask with its window (no packing with a window) at q
    blocks of 4, or with ``plain_attention`` as the hook, ``_sdpa`` under
    that mask; ``attn``, ``xp``: the port's attention module and torch, or
    the reference's and ``jax.numpy``."""
    kw = {**PLAIN_ROWS, **PLAIN_HEADS}[tag][1]
    B_, S_, H, hd = q.shape
    Kh = k.shape[2]
    q5 = q.reshape(B_, S_, Kh, H // Kh, hd)
    qb, scale = PLAIN_ROWS_KW["q_block"], PLAIN_ROWS_KW["scale"]
    if tag in ("plainp", "plainqp"):
        o = attn._qblock_scan(q5, k, v, attn.make_mask_fn(
            "prefix", 0, kw["prefix_len"]), 0.0, scale, qb, 0)
    elif tag in ("plainb", "plainqb"):
        o = attn._rect_scan(q5, k, v, 0.0, scale, qb)[0]
    elif tag == "plainc":
        o = attn._qblock_scan(q5, k, v, attn.make_mask_fn(
            "causal", kw["window"]), 0.0, scale, qb, kw["window"])
    elif tag == "plainh":
        mask = attn.make_mask_fn("causal", kw["window"])(xp.arange(S_),
                                                         xp.arange(S_))
        o = attn._sdpa(q5, k, v, mask, 0.0, scale)
    else:
        mask = attn.make_mask_fn("bidir")(xp.arange(S_),
                                          xp.arange(k.shape[1]))
        o = attn._sdpa(q5, k, v, mask, 0.0, scale)
    return o.reshape(B_, S_, H, hd)


def whole_group_case(attn, xp, tag, q, k, v):
    """What ``tag`` of ``GROUP_ROWS`` computes, on whole tensors: flat q
    (B,S,6,hd) -> (B,S,6,hd) under the causal mask with a window of 6
    (``_sdpa``: the flash tags) or the bidirectional one (``_rect_scan``
    at q blocks of 4: the plain dispatch's branch); ``attn``, ``xp``: the
    port's attention module and torch, or the reference's and
    ``jax.numpy``."""
    B_, S_, H, hd = q.shape
    q5 = q.reshape(B_, S_, k.shape[2], H // k.shape[2], hd)
    scale = PLAIN_ROWS_KW["scale"]
    if tag.startswith("flash"):
        mask = attn.make_mask_fn("causal", 6)(xp.arange(S_), xp.arange(S_))
        o = attn._sdpa(q5, k, v, mask, 0.0, scale)
    else:
        o = attn._rect_scan(q5, k, v, 0.0, scale,
                            PLAIN_ROWS_KW["q_block"])[0]
    return o.reshape(B_, S_, H, hd)


def flash_groups(q, k, v):
    """Flash's plain version on whole tensors: flat q (B,S,6,hd) folded
    over k's kv heads, a window of 6."""
    from repro_torch.kernels.flash_attention import flash_attention
    K = k.shape[2]
    return flash_attention(q.unflatten(2, (K, q.shape[2] // K)), k, v,
                           scale=0.25, window=6, q_block=512,
                           pack=True).flatten(2, 3)


def kernel_plain(inp):
    """Each kernel wrapper on plain tensors: outputs and input grads; and
    the plain dispatch's branches on whole tensors (``run_kernels``'
    keys)."""
    import functools

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_chunk import wkv6
    from repro_torch.models import attention as tattn

    def flat_q(qf, kf, vf):         # 8 q heads, 2 kv heads: G = 4
        return flash_attention(qf.unflatten(2, (2, 4)), kf, vf, scale=0.25,
                               q_block=512, pack=True).flatten(2, 3)

    def flat_r(qr, kr, vr):         # 2 q heads, 2 kv heads: G = 1
        return flash_attention(qr.unflatten(2, (2, 1)), kr, vr, scale=0.25,
                               window=6, q_block=512, pack=True).flatten(2, 3)
    out = {}
    for tag, fn, names in (
            ("flash", functools.partial(flash_attention, scale=0.25,
                                        q_block=512, pack=True), "qkv"),
            ("flashq", flat_q, ("qf", "kf", "vf")),
            ("flashr", flat_r, ("qr", "kr", "vr")),
            *((tag, functools.partial(whole_rows_case, tattn, torch, tag),
               names) for tag, (names, *_) in (*PLAIN_ROWS.items(),
                                               *PLAIN_HEADS.items())),
            *((tag, flash_groups if tag.startswith("flash") else
               functools.partial(whole_group_case, tattn, torch, tag),
               ("gq", *kv)) for tag, kv in GROUP_ROWS.items()),
            ("scan", rglru_scan, "ab"),
            ("wkv6", wkv6, ("r", "wk", "wv", "logw", "u"))):
        ins = {n: torch.from_numpy(inp[f"kern/{n}"]).requires_grad_()
               for n in names}
        outs = fn(*ins.values())
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, [torch.from_numpy(
            inp[f"kern/{tag}/ct{i}"]) for i in range(len(outs))])
        for i, o in enumerate(outs):
            out[f"kern/{tag}/out{i}"] = o.detach().numpy()
        for n, t in ins.items():
            out[f"kern/{tag}/grad/{n}"] = t.grad.numpy()
    return out


def xent_plain(inp):
    """``softmax_xent`` on the full plain logits: loss, count, gradient."""
    from repro_torch.models.losses import softmax_xent
    logits = torch.from_numpy(inp["xent/logits"]).requires_grad_()
    loss, n = softmax_xent(logits, torch.from_numpy(inp["xent/labels"]))
    loss.backward()
    return {"xent/loss": loss.detach().numpy(), "xent/n": n.numpy(),
            "xent/grad": logits.grad.numpy()}


def rwkv_port(inp):
    """The unsharded port's time mix and channel mix: outputs and
    gradients, keyed as ``run_rwkv``'s."""
    from repro_torch.models import rwkv as trwkv
    out = {}
    for tag in RWKV_CONFIG:
        cfg = rwkv_config(tag, get_smoke_config)
        layer = cell_model(inp, tag, cfg).layers[0].requires_grad_()
        xs = [torch.from_numpy(inp[f"{tag}/x_{n}"]).requires_grad_()
              for n in ("tm", "cm")]
        outs = (*trwkv.time_mix_seq(layer.tm, xs[0], cfg),
                *trwkv.channel_mix(layer.cm, xs[1]))
        torch.autograd.backward([outs[0], outs[3]], [
            torch.from_numpy(inp[f"{tag}/ct_{n}"]) for n in ("tm", "cm")])
        out.update({f"{tag}/out/{n}": o.detach().numpy() for n, o in zip(
            ("tm", "state", "tm_last", "cm", "cm_last"), outs)})
        out.update({f"{tag}/grad/x_{n}": x.grad.numpy()
                    for n, x in zip(("tm", "cm"), xs)})
        out.update({f"{tag}/grad/{n}": p.grad.numpy() for n, p in (
            *layer.tm.named_parameters(prefix="tm"),
            *layer.cm.named_parameters(prefix="cm"))})
    return out


def group_layer_port(inp):
    """The unsharded port's ``attention_seq``: outputs and gradients,
    keyed as ``run_group_layers``'s."""
    from repro_torch.models import attention as tattn
    out = {}
    for tag, (_, _, kind, mask) in GROUP_LAYERS.items():
        cfg = group_layer_config(tag, get_smoke_config)
        p = tattn.Attention({n: torch.from_numpy(inp[f"{tag}/{n}"])
                             for n in ("wq", "wk", "wv", "wo")})
        p.requires_grad_()
        x = torch.from_numpy(inp[f"{tag}/x"]).requires_grad_()
        pos = torch.arange(x.shape[1]).expand(x.shape[:2])
        o, _ = tattn.attention_seq(p, x, cfg, kind, pos, mask)
        o.backward(torch.from_numpy(inp[f"{tag}/ct"]))
        out[f"{tag}/out"] = o.detach().numpy()
        out[f"{tag}/grad/x"] = x.grad.numpy()
        out.update({f"{tag}/grad/{n}": t.grad.numpy()
                    for n, t in p.named_parameters()})
    return out


def moe_dense_weights(inp, pre):
    """The MoE weights under ``pre`` (``moed/<arch>/``), by name."""
    return {n[len(pre):]: v for n, v in inp.items() if n.startswith(pre)
            and n[len(pre):] not in ("x", "ct", "ct_aux", "experts")}


def moe_dense_port(inp):
    """The unsharded port's ``moe_dense``: y, aux, the gradients, keyed as
    ``run_moe_dense``'s."""
    out = {}
    for arch in MOE_DENSE:
        cfg = moe_dense_config(arch, get_smoke_config)
        pre = f"moed/{arch}/"
        w = {n: torch.from_numpy(v)
             for n, v in moe_dense_weights(inp, pre).items()}
        dense = {n[len("dense/"):]: t for n, t in w.items()
                 if n.startswith("dense/")}
        p = tmoe.MoE({n: w[n] for n in ("router", "w_gate", "w_up",
                                        "w_down")},
                     MLP(dense) if dense else None).requires_grad_()
        ins = {n.replace(".", "/"): t for n, t in p.named_parameters()}
        ins["x"] = torch.from_numpy(inp[pre + "x"]).requires_grad_()
        y, aux = tmoe.moe_dense(p, ins["x"], cfg)
        torch.autograd.backward([y, aux], [
            torch.from_numpy(inp[pre + "ct"]),
            torch.from_numpy(inp[pre + "ct_aux"])])
        out[pre + "y"], out[pre + "aux"] = y.detach().numpy(), \
            aux.detach().numpy()
        out.update({f"{pre}grad/{n}": t.grad.numpy()
                    for n, t in ins.items()})
    return out


def unsharded(inp) -> dict:
    """Everything ``sharded_main`` runs on INPUTS that the unsharded port
    computes: {cell: ``port_run``} for each of ``cells``, and
    ``kernel_plain``, ``xent_plain``, ``rwkv_port``, ``group_layer_port``
    and ``moe_dense_port`` under ``kernels``, ``xent``, ``rwkv``,
    ``layers`` and ``moed``."""
    want = {c: port_run(inp, c) for c in str(inp["cells"]).split(",")}
    for name, fn in (("kernels", kernel_plain), ("xent", xent_plain),
                     ("rwkv", rwkv_port), ("layers", group_layer_port),
                     ("moed", moe_dense_port)):
        want[name] = fn(inp)
    return want


def sharded_main(rank, world, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    inp = dict(np.load(inputs))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    res = {}
    for cell in str(inp["cells"]).split(","):
        run_cell(inp, cell, mesh, res)
    run_kernels(inp, mesh, res)
    run_group_layers(inp, mesh, res)
    run_rwkv(inp, mesh, res)
    run_reduce(inp, res)
    run_loss(inp, mesh, res)
    run_moe_dense(inp, mesh, res)
    run_dryrun_checks(mesh, res)
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inputs, out = sys.argv[1:6]
    (sharded_main if sys.argv[6:] == ["sharded"] else main)(
        int(r), int(w), store, inputs, out)
