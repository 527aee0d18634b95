"""The port's sharded model (DTensor parameters placed by
``distributed.layouts.shard_params``, the reference's ``constrain`` sites,
``grad_shardings`` and ``update_constraint``, the kernels under
``local_map``, ``moe_sharded`` inside the DTensor model) against the
unsharded port and the JAX reference, on the CPU.

The multi-rank cells run in 8 processes joined in one gloo group, spawned
once for the module by ``tests/torch_dist_worker.py`` (its ``sharded``
mode) from a FileStore in the test's temp dir and joined under a time
limit, as tests/test_torch_distributed.py does.  The mesh is the
reference's TRAIN_LOWERS one (tests/test_distributed.py): 2 x 4
``("data", "model")``, smoke configs in f32 with ``attn_q_block=16``,
sequence 32, global batch 8.  The cells:

* ``g2``: gemma2-9b prefill, then decode at the next position on the
  cache laid out by ``cache_pspecs`` (``kv_seq`` over ``model``: ring and
  full caches); ``g2q`` the same with the int8 cache;
* ``g2t``: gemma2-9b, one train step, ``grad_accum=2`` (TRAIN_LOWERS),
  AdamW with ``grad_shardings`` and ``update_constraint`` from
  ``opt_pspecs`` (ZeRO);
* ``rg``: recurrentgemma-2b prefill (the RG-LRU's ``constrain`` and the
  scan under ``local_map``), then decode; ``rgt`` its train step
  (``grad_accum=1``);
* ``rw``: rwkv6-7b prefill (the wkv6 under ``local_map``), then decode;
  ``rw2`` the same at a global batch of 4 (``CELL_BATCH``), whose decode
  DTensor could not run until the LoRAs ran on each rank's block of the
  model dim and the recurrence under ``local_map`` (C17);
* ``qw``: qwen3-moe-235b-a22b, one train step with Adafactor and
  ``moe_sharded`` inside the DTensor model; ``art`` arctic-480b's, its
  dense FFN beside the experts, whose output is laid out as theirs before
  the sum, so that the FFN's products take rows whole over the sequence
  in the backward too (C18: torch 2.11 refused the view otherwise);
* ``pg``: paligemma-3b prefill and ``pgt`` its train step, with 2 q heads
  and 1 kv head; ``wh``: whisper-small's train step, with 2 q heads and 2
  kv heads (``CELL_CONFIG``; the reference's synthetic batches, with
  ``patches`` and ``frames``).  2 heads on the 4 ``model`` ranks take the
  q-rows route (C6): the prefix mask, the bidirectional encoder and
  cross-attention each rank's block of one head's rows, the k and v
  projections cut by columns (C7), whisper's decoder self-attention
  through flash's q-rows route in the same layer;
* ``rg6t`` and ``wh6t``: the train steps of recurrentgemma-2b (1 kv head)
  and whisper-small (6 kv heads) with 6 q heads, which 4 ``model`` ranks
  split by head groups and row blocks (C10: 2 groups of 3 heads, each
  group's rows over 2 ranks);
* ``whv``: whisper-small's train step with a vocab of 514, which the 4
  ``model`` ranks do not divide (C14: the tied table whole on every rank,
  its lookup and its head on each rank's rows, the logits and the loss
  there), and ``rwt``: rwkv6-7b's train step (its mixes' weights gathered
  whole onto each rank's rows), each at ``grad_accum=2``: every
  parameter's gradient is reduced once a step, after the microbatches'
  are summed (C8), as in ``g2t`` (the tied table's vocab-parallel
  lookup).

On this mesh gemma2-9b's 4 q heads split over ``model`` and its 2 kv
heads do not: flash runs on each rank's own q head (the q-heads route,
C3) and the loss of the vocab-sharded logits is vocab-parallel (C4), in
``g2``, ``g2t`` and the traced step; both are also held alone (flash's
routes beside the other kernels', the loss against the full logits), and
``head_split`` over every arch at 4 and 16 ``model`` ranks.

Beside the cells: C10's route alone (flash and the plain dispatch, 1 and 6
kv heads) and in ``attention_seq`` (the gradients of the projections);
C11's q-heads route of the plain dispatch (2 q heads on 2 ranks, 1 kv
head; the prefix and bidirectional masks); C9's rwkv6-7b time mix and
channel mix on the residual stream's rows, and C13's with 2 heads that
the 4 ``model`` ranks do not divide (each rank's block of rows, the state
carried across the blocks), against the unsharded port and the
reference's ``wkv_chunked`` and ``channel_mix`` (``jax.vjp``), and the
shapes of the rank's products; C15's partial sums over ``pod`` and
``data`` reduced in one collective, on a (2, 2, 2) mesh of the 8 ranks.

Beside the cells, ``moe_layer`` on DTensors where the experts do not split
over ``model`` (qwen3-moe and arctic smoke MoEs with 6 experts on 4
ranks): it falls back to ``moe_dense`` on every token, as the reference's
``moe_sharded`` does, and its y, aux and gradients are held to the
unsharded port's and the reference's ``moe_dense`` (``jax.vjp``).

Weights are the reference's own (``init_params``, every norm and zero
vector given random values, as tests/test_torch_train.py does), carried
across by ``params_from_jax``; tokens are numpy draws.  The cells, the
inputs' layout (``worker.build_inputs``) and the unsharded port's runs
(``worker.unsharded``) are the worker's, which ``chip_smoke.py``
``[multirank]`` runs on the port's own weights without JAX; this module
checks that its ``multirank_inputs`` writes the same inputs and that the
shared oracle gives ``_port_run``'s outputs bit for bit.

The sharded MoE routes each data shard's tokens with a capacity of its
own, and its aux loss is the mean of the shards' (the reference's
``moe_sharded`` does the same), so the unsharded run it is held to
computes the same semantics: each data shard's rows through the unsharded
model on their own, the logits joined for one cross-entropy, the aux the
shards' mean (``worker.per_shard_step``), in the port and in the
reference alike.

Tolerances, with reasons:
* against the unsharded port: 1e-5 relative (each output, cache leaf and
  parameter in relative norm, the loss and grad norm as numbers), the
  tolerance of the sharded-vs-dense MoE (``chip_smoke.DIST_F32_TOL``):
  only the order of the sums changes;
* against the reference: those of tests/test_torch_model.py (2e-4 on
  prefill and decode outputs) and tests/test_torch_train.py (loss 1e-5,
  grad norm 1e-4; AdamW's weights within 2 lr (1 + wd |p|) elementwise;
  Adafactor's step per leaf 1e-4 in relative norm).  The reference runs
  its plain attention (f32, so its cast of the probabilities changes
  nothing).  The int8 cell ``g2q`` is held to the unsharded port only: the
  port's int8 values sit one step from the reference's at rounding ties
  (one element a leaf here, with or without sharding), which moves its
  decode logits by 2.2e-4, past 2e-4; the int8 cache against the
  reference is tests/test_torch_encdec_vision.py's.

The same 8 ranks also run what the dry-run's fake world
(``launch.mesh.fake_mesh``, tests/test_torch_dryrun_mesh.py) is held
against: ``train.steps._microbatch`` at ``grad_accum`` 4 on 8 data ranks
(the reference's rows), a shard-to-shard ``redistribute`` as gloo's
all-to-all under ``context.native_alltoall``, and rank 0's ``OpTrace`` of
one sharded smoke train step, which rank 0 of a fake 2 x 4 world traced in
this process must equal: op names and counts, flops, ``collective_stats``.

One process: a 1 x 1 mesh (a gloo group of one) must give bit-identical
outputs with and without ``shard_params`` on every path; a kernel wrapper
given a DTensor it cannot split raises; C2's collectives copy nothing on a
one-rank group.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as worker  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.losses import softmax_xent as jax_xent  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs.base import (LM_SHAPES, get_config,  # noqa: E402
                                      get_smoke_config)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import context  # noqa: E402
from repro_torch.distributed import layouts  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_mesh  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                init_params)
from repro_torch.models.weights import (params_from_jax,  # noqa: E402
                                        params_to_numpy)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
# the 8 ranks' time limit: under the tier-1 run's 6 xdist workers the
# spawn and the unsharded runs beside it took 227 s of 240, and 305 s of
# 360 once the ``whv`` and ``rwt`` train cells were in
JOIN_S = 480
# the cells, their inputs and the unsharded port they are held to are the
# worker's, which ``chip_smoke.py`` ``[multirank]`` runs on the card
# machine's host without JAX
B, S = worker.B, worker.S
LR = worker.LR
DIST_F32_TOL = 1e-5
MODEL_TOL = 2e-4
LOSS_TOL, GNORM_TOL = 1e-5, 1e-4
NORMAL = worker.NORMAL
CELLS, CELL_BATCH, CELL_CONFIG = worker.CELLS, worker.CELL_BATCH, \
    worker.CELL_CONFIG
TRAIN = [c for c, v in CELLS.items() if v[1] == "train"]
SERVE = [c for c, v in CELLS.items() if v[1] != "train"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(t, j) -> float:
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30))


def _cfgs(cell):
    return worker.table_config(cell, jax_smoke), worker.table_config(cell)


def _heads(cell) -> tuple:
    """The cell's replacements of the fields that shape its weights
    (n_heads, n_kv_heads, vocab_size), as items."""
    return tuple((k, v) for k, v in CELL_CONFIG.get(cell, {}).items()
                 if k in ("n_heads", "n_kv_heads", "vocab_size"))


@functools.cache
def _jax_params(arch, seed=0, heads=()):
    jc = dataclasses.replace(jax_smoke(arch), param_dtype="float32",
                             **dict(heads))
    params = jtf.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in NORMAL:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.3, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


_tokens = worker.cell_tokens


def _batch(cell, kind) -> dict:
    """The cell's train or prefill batch, numpy: the reference's synthetic
    batch (with whisper's ``frames`` or paligemma's ``patches``; prefill
    without ``labels``) for a ``CELL_CONFIG`` cell, else its tokens."""
    if cell in CELL_CONFIG:
        from repro.data import SyntheticTokens
        batch = SyntheticTokens(_cfgs(cell)[0], B, S, seed=0) \
            .batch_for_step(0)
        return batch if kind == "train" else \
            {k: v for k, v in batch.items() if k != "labels"}
    tokens = _tokens(cell)
    if kind == "train":
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return {"tokens": tokens[:, :-1]}


def _port_model(cell):
    jc, tc = _cfgs(cell)
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(
        CELLS[cell][0], heads=_heads(cell))), tc, device="cpu")


KERNEL_SHAPES = worker.KERNEL_SHAPES
_kernel_inputs = worker.kernel_inputs
_whole_rows_case = worker.whole_rows_case
_whole_group_case = worker.whole_group_case
# the q-rows route by head groups (``worker.GROUP_ROWS``)
GROUP_TAGS = ["flashg1", "flashg6", "plaing1", "plaing6"]
# the plain dispatch's q-heads route (``worker.PLAIN_HEADS``)
HEAD_TAGS = ["plainqp", "plainqb"]


def _group_layer_weights(i, tag):
    """``worker.GROUP_LAYERS[tag]``'s weights: the reference's
    ``init_attention``."""
    from repro.models import attention as jattn
    jc = worker.group_layer_config(tag, jax_smoke)
    return {n: np.array(v) for n, v in
            jattn.init_attention(jax.random.PRNGKey(30 + i), jc).items()}


def _group_layer_jax(inp):
    """The reference's ``attention_seq`` (its plain dispatch, f32) and its
    ``jax.vjp``, keyed as ``worker.group_layer_port``'s."""
    from repro.models import attention as jattn
    out = {}
    for tag, (_, _, kind, mask) in worker.GROUP_LAYERS.items():
        jc = worker.group_layer_config(tag, jax_smoke)
        params = {n: jnp.asarray(inp[f"{tag}/{n}"])
                  for n in ("wq", "wk", "wv", "wo")}
        x = jnp.asarray(inp[f"{tag}/x"])
        pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])

        @jax.jit
        def with_grads(params, x, ct):
            o, vjp = jax.vjp(lambda p, x: jattn.attention_seq(
                p, x, jc, kind, pos, mask)[0], params, x)
            return o, vjp(ct)
        o, (gp, gx) = with_grads(params, x, jnp.asarray(inp[f"{tag}/ct"]))
        out[f"{tag}/out"] = np.asarray(o)
        out[f"{tag}/grad/x"] = np.asarray(gx)
        out.update({f"{tag}/grad/{n}": np.asarray(g) for n, g in gp.items()})
    return out


# rwkv6-7b's mixes on the residual stream's rows: the smoke config's one
# layer in f32 (C9), and with 2 heads, which the 4 ``model`` ranks do not
# divide (C13; ``worker.RWKV_CONFIG``), the reference's weights
RWKV_TAGS = ["rwkv", "rwkv2"]


def _rwkv_cfgs(tag):
    return tuple(worker.rwkv_config(tag, base)
                 for base in (jax_smoke, get_smoke_config))


def _rwkv_params(tag):
    """The reference's weights of ``tag``'s config (its fields that shape
    them given as ``heads``)."""
    return _jax_params("rwkv6-7b", seed=5, heads=(
        ("n_layers", 1), *worker.RWKV_CONFIG[tag].items()))


def _rwkv_model(tag):
    """The port's one-layer model of ``tag`` from the reference's
    weights."""
    return params_from_jax(jax.tree.map(np.asarray, _rwkv_params(tag)),
                           _rwkv_cfgs(tag)[1], device="cpu")


def _rwkv_jax(inp):
    """The reference's ``wkv_chunked`` and ``channel_mix`` on the same
    weights and x, and their ``jax.vjp``: keyed as ``worker.rwkv_port``'s."""
    from repro.models import rwkv as jrwkv
    out = {}
    for tag in RWKV_TAGS:
        jc, _ = _rwkv_cfgs(tag)
        block = _rwkv_params(tag)["blocks"][0]
        tm, cm = ({n: v[0] for n, v in block[m].items()}
                  for m in ("tm", "cm"))

        def mixes(tm, cm, x_tm, x_cm, jc=jc):
            return (*jrwkv.wkv_chunked(tm, x_tm, jc),
                    *jrwkv.channel_mix(cm, x_cm))

        @jax.jit
        def with_grads(tm, cm, x_tm, x_cm, ct_tm, ct_cm, mixes=mixes):
            outs, vjp = jax.vjp(mixes, tm, cm, x_tm, x_cm)
            cts = [jnp.zeros_like(o) for o in outs]
            cts[0], cts[3] = ct_tm, ct_cm
            return outs, vjp(tuple(cts))
        outs, (g_tm, g_cm, g_xtm, g_xcm) = with_grads(
            tm, cm, *(jnp.asarray(inp[f"{tag}/{n}"])
                      for n in ("x_tm", "x_cm", "ct_tm", "ct_cm")))
        out.update({f"{tag}/out/{n}": np.asarray(o) for n, o in zip(
            ("tm", "state", "tm_last", "cm", "cm_last"), outs)})
        out.update({f"{tag}/grad/x_tm": np.asarray(g_xtm),
                    f"{tag}/grad/x_cm": np.asarray(g_xcm)})
        for m, g in (("tm", g_tm), ("cm", g_cm)):
            out.update({f"{tag}/grad/{m}.{n}": np.asarray(v)
                        for n, v in g.items()})
    return out


XENT_B, XENT_S, XENT_V = worker.XENT_B, worker.XENT_S, worker.XENT_V
_xent_inputs = worker.xent_inputs
# arch -> an expert count that does not divide the 4 ``model`` ranks
MOE_DENSE = worker.MOE_DENSE


def _moe_dense_cfgs(arch):
    return [worker.moe_dense_config(arch, base)
            for base in (jax_smoke, get_smoke_config)]


def _moe_weights(i, arch):
    """``MOE_DENSE[arch]``'s weights: the reference's ``init_moe`` (the
    dense FFN's under ``dense/``)."""
    jc, _ = _moe_dense_cfgs(arch)
    out = {}
    for n, v in jmoe.init_moe(jax.random.PRNGKey(i), jc).items():
        if n == "dense":
            out.update({f"dense/{k}": np.array(w) for k, w in v.items()})
        else:
            out[n] = np.array(v)
    return out


def _moe_dense_jax(inp):
    """The reference's ``moe_dense`` (its fallback where the experts do
    not split, repro/models/moe.py ``moe_sharded``): y, aux, the gradients
    by ``jax.vjp``."""
    out = {}
    for arch in MOE_DENSE:
        jc, _ = _moe_dense_cfgs(arch)
        pre = f"moed/{arch}/"
        w = {n: jnp.asarray(v)
             for n, v in worker.moe_dense_weights(inp, pre).items()}
        params = {n: v for n, v in w.items() if "/" not in n}
        if any(n.startswith("dense/") for n in w):
            params["dense"] = {n[len("dense/"):]: v for n, v in w.items()
                               if n.startswith("dense/")}
        (y, aux), vjp = jax.vjp(lambda p, x: jmoe.moe_dense(p, x, jc),
                                params, jnp.asarray(inp[pre + "x"]))
        gp, gx = vjp((jnp.asarray(inp[pre + "ct"]),
                      jnp.asarray(inp[pre + "ct_aux"])))
        out[pre + "y"], out[pre + "aux"] = np.asarray(y), np.asarray(aux)
        out[pre + "grad/x"] = np.asarray(gx)
        for n, g in gp.items():
            if n == "dense":
                out.update({f"{pre}grad/dense/{k}": np.asarray(v)
                            for k, v in g.items()})
            else:
                out[f"{pre}grad/{n}"] = np.asarray(g)
    return out


_reduce_inputs = worker.reduce_inputs
# the reference's weights, for ``worker.build_inputs``
JAX_WEIGHTS = types.SimpleNamespace(
    cell=_port_model, batch=lambda cell: _batch(cell, "train"),
    rwkv=_rwkv_model, attention=_group_layer_weights, moe=_moe_weights)


@functools.cache
def _inputs():
    """The ranks' inputs on the reference's weights (read only)."""
    return worker.build_inputs(JAX_WEIGHTS)


_leaves = worker.cache_leaves


# ---------------------------------------------------------------------------
# the unsharded runs: the port and the reference
# ---------------------------------------------------------------------------
def _port_run(cell):
    """The unsharded port's outputs, keyed as the worker's, on the
    reference's weights, tokens and batches as this module makes them."""
    _, tc = _cfgs(cell)
    _, kinds, _, accum = CELLS[cell]
    return worker.port_outputs(
        tc, _port_model(cell), kinds, accum, torch.from_numpy(_tokens(cell)),
        lambda kind: {k: torch.from_numpy(v)
                      for k, v in _batch(cell, kind).items()})


def _jax_run(cell):
    """The reference's outputs, keyed as ``_port_run``'s."""
    jc, _ = _cfgs(cell)
    arch, kinds, _, accum = CELLS[cell]
    params = _jax_params(arch, heads=_heads(cell))
    tokens = jnp.asarray(_tokens(cell), jnp.int32)
    out = {}
    if kinds == "train":
        batch = {k: jnp.asarray(v) for k, v in _batch(cell, "train").items()}
        opt = jax_make_optimizer(jc.optimizer)
        if jc.moe is None:
            state = {"params": params, "opt": opt.init(params),
                     "step": jnp.zeros((), jnp.int32)}
            new, metrics = jax.jit(jsteps.build_train_step(
                jc, opt, lambda s: LR, grad_accum=accum))(state, batch)
            new = new["params"]
        else:
            def loss(p, mb):
                outs = [jtf.forward_train(p, jc, {"tokens": s["tokens"]})
                        for s in worker.split(mb)]
                xent, _ = jax_xent(jnp.concatenate([o[0] for o in outs]),
                                   mb["labels"])
                return xent + jsteps.AUX_COEF * (outs[0][1] + outs[1][1]) \
                    / 2, xent

            @jax.jit
            def step(p):
                grads, xent = jax.grad(loss, has_aux=True)(p, batch)
                new, _, gn = opt.update(grads, opt.init(p), p, LR)
                return new, {"loss": xent, "grad_norm": gn}
            assert accum == 1
            new, metrics = step(params)
        out.update({k: float(metrics[k]) for k in ("loss", "grad_norm")})
        out["new"] = jax.tree.map(np.asarray, new)
        out["old"] = jax.tree.map(np.asarray, params)
        return out
    logits, cache = jax.jit(functools.partial(jtf.forward_prefill, cfg=jc))(
        params, batch={k: jnp.asarray(v)
                       for k, v in _batch(cell, "prefill").items()})

    def leaves(c):
        return [np.asarray(e[n]) for part in ("blocks", "tail")
                for e in c[part] for n in sorted(e)]
    out["prefill"] = [np.asarray(logits)] + leaves(cache)
    if "decode" in kinds:
        logits, cache = jtf.forward_decode(params, jc, cache,
                                           tokens[:, -1:], S)
        out["decode"] = [np.asarray(logits)] + leaves(cache)
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Starts the 8 ranks, computes the unsharded runs meanwhile, joins the
    ranks; -> (rank 0's results, {cell: port run} with the parts'
    (``worker.unsharded``), {cell: reference run})."""
    d = tmp_path_factory.mktemp("sharded")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(d / "store"), str(d / "inputs.npz"),
         str(d / f"out{r}.npz"), "sharded"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        port = worker.unsharded(inp)
        ref = {c: _jax_run(c) for c in CELLS}
        ref["moed"] = _moe_dense_jax(inp)
        ref["rwkv"] = _rwkv_jax(inp)
        ref["layers"] = _group_layer_jax(inp)
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} gloo ranks did not finish in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, bad
    return dict(np.load(d / "out0.npz")), port, ref


# ---------------------------------------------------------------------------
# 8 ranks, a 2 x 4 mesh
# ---------------------------------------------------------------------------
def _outputs(res, cell, kind):
    n = sum(1 for k in res if k.startswith(f"{cell}/{kind}/cache"))
    return [res[f"{cell}/{kind}/logits"]] + [
        res[f"{cell}/{kind}/cache{i}"] for i in range(n)]


SERVE_CASES = [(c, k) for c in SERVE for k in CELLS[c][1].split(",")]


@pytest.mark.parametrize("cell,kind", SERVE_CASES)
def test_sharded_serving_matches_unsharded_port(sharded, cell, kind):
    """The logits and every cache leaf: 1e-5 relative (int8 leaves
    exactly: the quantizer's inputs agree to ~1e-7, and an int8 value one
    step off would show)."""
    res, port, _ = sharded
    got, want = _outputs(res, cell, kind), port[cell][kind]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1, i
            assert (g != w).mean() < 1e-3, i
        else:
            assert _rel(g, w) <= DIST_F32_TOL, (i, _rel(g, w))


@pytest.mark.parametrize("cell,kind", [c for c in SERVE_CASES
                                       if c[0] != "g2q"])
def test_sharded_serving_matches_reference(sharded, cell, kind):
    res, _, ref = sharded
    got, want = _outputs(res, cell, kind), ref[cell][kind]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=f"output {i}")


# cell -> the q-rows routes its model takes, by kernel name: paligemma's
# prefix-LM mask through the plain dispatch; whisper's encoder and its
# cross-attention too, its decoder self-attention through flash's
Q_ROWS_CELLS = {"pg": {"attention"}, "pgt": {"attention"},
                "wh": {"attention", "flash attention"},
                "rg6t": {"flash attention"},
                "wh6t": {"attention", "flash attention"}}


@pytest.mark.parametrize("cell", sorted(Q_ROWS_CELLS))
def test_q_rows_cells_take_the_route(sharded, cell):
    """C6 and C7 in the ``CELL_CONFIG`` cells: their attention takes the
    q-rows routes ``Q_ROWS_CELLS`` names (2 q heads on 4 ``model`` ranks)
    and no other, and every k and v projection is cut by columns over
    ``model``; the module's other cells take no q-rows route."""
    res, _, _ = sharded
    seen = json.loads(str(res[f"{cell}/routes"]))
    assert {k for k in seen if not k.startswith("kv/")} == \
        Q_ROWS_CELLS[cell], seen
    assert {k for k in seen if k.startswith("kv/")} == {"kv/columns"}, \
        seen
    for other in sorted(set(CELLS) - set(CELL_CONFIG)):
        seen = json.loads(str(res[f"{other}/routes"]))
        assert not any(k in seen for k in ("attention", "flash attention")), \
            (other, seen)


# cell -> the relative tolerance of AdamW's m and v where it is not
# DIST_F32_TOL (rwkv6-7b's, with its reasons: ``worker.GRAD_TOL``)
GRAD_TOL = worker.GRAD_TOL


_adamw_ratio = worker.adamw_ratio


@pytest.mark.parametrize("cell", TRAIN)
def test_sharded_train_step_matches_unsharded_port(sharded, cell):
    """The loss, the grad norm, AdamW's m and v (the grads) and Adafactor's
    updated parameters to 1e-5 in relative norm.  AdamW's first step moves
    a weight by lr m / (sqrt(v) + eps), which turns a grad near eps that
    the order of the sums moves by 1e-7 of the larger grads into a step
    that differs by up to lr (2 elements of gemma2-9b's embedding table:
    1.2e-5 of the table in relative norm); so each AdamW weight is held to
    1e-5 of itself plus lr times the difference of the two runs' step
    directions, recomputed from their own m and v."""
    res, port, _ = sharded
    want = port[cell]
    for k in ("loss", "grad_norm"):
        assert abs(float(res[f"{cell}/{k}"]) - want[k]) <= \
            DIST_F32_TOL * abs(want[k]), k
    if "m" not in want:
        for n, w in want["new"].items():
            assert _rel(res[f"{cell}/new/{n}"], w) <= DIST_F32_TOL, n
        return
    for n, w in want["new"].items():
        for k in ("m", "v"):
            assert _rel(res[f"{cell}/{k}/{n}"], want[k][n]) <= \
                GRAD_TOL.get(cell, DIST_F32_TOL), (k, n)
        moved = LR * np.abs(_adamw_ratio(res[f"{cell}/m/{n}"],
                                         res[f"{cell}/v/{n}"]) -
                            _adamw_ratio(want["m"][n], want["v"][n]))
        got = res[f"{cell}/new/{n}"].astype(np.float64)
        assert np.all(np.abs(got - w) <= DIST_F32_TOL * np.abs(w) + moved +
                      1e-9), n


@pytest.mark.parametrize("cell", TRAIN)
def test_sharded_train_step_matches_reference(sharded, cell):
    res, _, ref = sharded
    jc, tc = _cfgs(cell)
    assert abs(float(res[f"{cell}/loss"]) - ref[cell]["loss"]) <= \
        LOSS_TOL * abs(ref[cell]["loss"])
    assert abs(float(res[f"{cell}/grad_norm"]) - ref[cell]["grad_norm"]) <= \
        GNORM_TOL * ref[cell]["grad_norm"]
    new = params_to_numpy({k[len(f"{cell}/new/"):]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith(f"{cell}/new/")}, tc)
    pairs = zip(jax.tree_util.tree_leaves_with_path(ref[cell]["new"]),
                jax.tree.leaves(new), jax.tree.leaves(ref[cell]["old"]))
    for (path, j), t, p in pairs:
        what = jax.tree_util.keystr(path)
        if tc.optimizer == "adamw":
            bound = 2 * LR * (1 + 0.1 * np.abs(p)) * (1 + 2 ** -7)
            assert np.all(np.abs(t - j) <= bound), what
        else:
            err = _rel(t.astype(np.float64) - p, j.astype(np.float64) - p)
            assert err <= GNORM_TOL, (what, err)


def _moe_dense_keys(want, arch):
    keys = [k for k in want if k.startswith(f"moed/{arch}/")]
    assert f"moed/{arch}/grad/x" in keys and f"moed/{arch}/grad/w_down" \
        in keys, keys
    return keys


@pytest.mark.parametrize("arch", list(MOE_DENSE))
def test_moe_fallback_matches_unsharded_port(sharded, arch):
    """``moe_layer`` on DTensors whose experts do not split over the 4
    ``model`` ranks (6 experts) takes ``moe_dense`` on every token, as the
    reference does: y, aux and the gradients of x and every weight equal
    the unsharded port's ``moe_dense`` to 1e-5 relative."""
    res, port, _ = sharded
    for k in _moe_dense_keys(port["moed"], arch):
        assert res[k].shape == port["moed"][k].shape, k
        assert _rel(res[k], port["moed"][k]) <= DIST_F32_TOL, \
            (k, _rel(res[k], port["moed"][k]))


@pytest.mark.parametrize("arch", list(MOE_DENSE))
def test_moe_fallback_matches_reference(sharded, arch):
    """The same against the reference's ``moe_dense`` and its ``jax.vjp``,
    to tests/test_torch_moe.py's f32 tolerances (2e-4; aux 1e-5
    relative)."""
    res, _, ref = sharded
    for k in _moe_dense_keys(ref["moed"], arch):
        if k.endswith("/aux"):
            np.testing.assert_allclose(res[k], ref["moed"][k], rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(res[k], ref["moed"][k],
                                       atol=MODEL_TOL, rtol=MODEL_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("tag", ["flash", "flashq", "flashr", "plainp",
                                 "plainb", "plainx", "plainc", "plainh",
                                 *GROUP_TAGS, *HEAD_TAGS, "scan", "wkv6"])
def test_kernel_routes_on_eight_ranks(sharded, tag):
    """Each wrapper's DTensor route on the 2 x 4 mesh (some inputs cut
    locally, u's gradient a Partial over ``data``): its outputs and the
    gradients of its inputs equal the plain call's to 1e-5 relative, at
    the placements of the split axes.  ``flashq`` is flash's q-heads
    route: flat q of 8 heads cut over the 4 ``model`` ranks, k and v of 2
    kv heads whole there (each rank reads one; their gradients summed).
    ``flashr`` is its q-rows route (C5): flat q of 2 heads over the 4
    ``model`` ranks, whole there, each rank running rows [8 j, 8 j + 8) of
    head r // 2 (j = r % 2) at its own q0 against the keys up to its last
    row, with a window of 6; k's and v's gradients summed over ``model``,
    the output gathered back.  ``plainp``, ``plainb`` and ``plainx`` are
    the plain dispatch's q-rows route (C6, ``attention_q_rows``) on the
    same layout: the prefix mask over 5 positions (the q-block scan at q
    blocks of 4, each rank's 8 rows at their q0 against all 16 keys of its
    kv head, 1 kv head for 2 q heads), the bidirectional mask (the
    rectangle scan), cross-attention (``_sdpa``, 24 keys for 16 rows) and,
    ``plainc``, a causal mask with a window of 6 and the hook off (each
    rank's rectangle at its q0 against the keys up to its last row), and
    ``plainh``, the same with ``plain_attention`` as the hook (handed each
    rank's q0), against the port's branch on the whole tensors.  The
    ``GROUP_TAGS`` are the route by head groups (C10): 6 flat q heads over
    the 4 ranks, 2 groups of 3, each group's 16 rows split 2 ways, against
    1 kv head (a group inside it) and 6 (3 whole ones a group); flash under
    a causal mask with a window of 6 (``flashg*``), the plain dispatch
    under the bidirectional one (``plaing*``).  The ``HEAD_TAGS`` are the
    plain dispatch's q-heads route (C11, ``attention_q_heads``): 2 flat q
    heads cut over the 2 ``data`` ranks, 1 kv head whole there, under the
    prefix mask over 5 positions and the bidirectional one; k's and v's
    gradients summed over ``data``, the output cut on its heads."""
    res, port, _ = sharded
    want = port["kernels"]
    keys = [k for k in want if k.startswith(f"kern/{tag}/")]
    assert keys
    for k in keys:
        assert _rel(res[k], want[k]) <= DIST_F32_TOL, k
    place = {"flash": ["(Shard(dim=0), Shard(dim=2))"],
             "flashq": ["(Shard(dim=0), Shard(dim=2))"],
             "flashr": ["(Shard(dim=0), Replicate())"],
             "plainp": ["(Shard(dim=0), Replicate())"],
             "plainb": ["(Shard(dim=0), Replicate())"],
             "plainx": ["(Shard(dim=0), Replicate())"],
             "plainc": ["(Shard(dim=0), Replicate())"],
             "plainh": ["(Shard(dim=0), Replicate())"],
             **dict.fromkeys(GROUP_TAGS, ["(Shard(dim=0), Replicate())"]),
             **dict.fromkeys(HEAD_TAGS, ["(Shard(dim=2), Shard(dim=0))"]),
             "scan": ["(Shard(dim=0), Shard(dim=2))"],
             "wkv6": ["(Shard(dim=0), Shard(dim=2))",
                      "(Shard(dim=0), Shard(dim=1))"]}[tag]
    for i, pl in enumerate(place):
        assert str(res[f"kern/{tag}/place{i}"]) == pl


def test_q_rows_route_matches_the_reference(sharded):
    """C5's route on 8 ranks (``flashr``) against the reference's causal
    attention with the same window (``_sdpa``, f32) and its ``jax.vjp``:
    the output and q's, k's and v's gradients to the model tolerance."""
    from repro.models import attention as jattn
    res, _, _ = sharded
    inp = _kernel_inputs()
    q, k, v = (jnp.asarray(inp[f"kern/{n}r"]) for n in "qkv")
    B_, S_, H, hd = q.shape
    mask = jattn.make_mask_fn("causal", 6)(jnp.arange(S_), jnp.arange(S_))

    def ref(q, k, v):
        o = jattn._sdpa(q.reshape(B_, S_, H, 1, hd), k, v, mask, 0.0, 0.25)
        return o.reshape(B_, S_, H, hd)
    o, vjp = jax.vjp(ref, q, k, v)
    grads = vjp(jnp.asarray(inp["kern/flashr/ct0"]))
    np.testing.assert_allclose(res["kern/flashr/out0"], o, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    for n, g in zip(("qr", "kr", "vr"), grads):
        np.testing.assert_allclose(res[f"kern/flashr/grad/{n}"], g,
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=n)


@pytest.mark.parametrize("tag", ["plainp", "plainb", "plainx", "plainc",
                                 "plainh", *HEAD_TAGS])
def test_plain_q_rows_route_matches_the_reference(sharded, tag):
    """C6's route on 8 ranks against the reference's branch of its
    dispatch on the whole tensors (``_qblock_scan`` under the prefix mask,
    ``_rect_scan``, ``_sdpa`` for cross-attention, ``_qblock_scan`` under
    the causal mask with a window, ``_sdpa`` under it for the
    ``plain_attention`` hook; f32) and its
    ``jax.vjp``: the output and q's, k's and v's gradients to the model
    tolerance.  The same for C11's q-heads route (``HEAD_TAGS``: the
    prefix and bidirectional branches)."""
    import torch_dist_worker as worker

    from repro.models import attention as jattn
    res, _, _ = sharded
    inp = _kernel_inputs()
    names = {**worker.PLAIN_ROWS, **worker.PLAIN_HEADS}[tag][0]
    o, vjp = jax.vjp(functools.partial(_whole_rows_case, jattn, jnp, tag),
                     *(jnp.asarray(inp[f"kern/{n}"]) for n in names))
    grads = vjp(jnp.asarray(inp[f"kern/{tag}/ct0"]))
    np.testing.assert_allclose(res[f"kern/{tag}/out0"], o, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(res[f"kern/{tag}/grad/{n}"], g,
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=n)


@pytest.mark.parametrize("tag", GROUP_TAGS)
def test_group_rows_route_matches_the_reference(sharded, tag):
    """C10's route on 8 ranks against the reference on the whole tensors
    (``_sdpa`` under the causal mask with a window of 6 for flash,
    ``_rect_scan`` for the plain dispatch's bidirectional branch; f32) and
    its ``jax.vjp``: the output and q's, k's and v's gradients to the model
    tolerance."""
    import torch_dist_worker as worker

    from repro.models import attention as jattn
    res, _, _ = sharded
    inp = _kernel_inputs()
    names = ("gq", *worker.GROUP_ROWS[tag])
    o, vjp = jax.vjp(functools.partial(_whole_group_case, jattn, jnp, tag),
                     *(jnp.asarray(inp[f"kern/{n}"]) for n in names))
    grads = vjp(jnp.asarray(inp[f"kern/{tag}/ct0"]))
    np.testing.assert_allclose(res[f"kern/{tag}/out0"], o, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(res[f"kern/{tag}/grad/{n}"], g,
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=n)


GROUP_LAYER_TAGS = ["attng1", "attng6"]


def _group_layer_keys(want, tag):
    keys = sorted(k for k in want if k.startswith(f"{tag}/"))
    assert {f"{tag}/out", f"{tag}/grad/x", f"{tag}/grad/wq",
            f"{tag}/grad/wk", f"{tag}/grad/wv", f"{tag}/grad/wo"} == \
        set(keys), keys
    return keys


@pytest.mark.parametrize("tag", GROUP_LAYER_TAGS)
def test_group_rows_layer_matches_unsharded_port(sharded, tag):
    """C10 in the attention layer (``attention_seq``, 6 q heads on the 4
    ``model`` ranks: recurrentgemma-2b's local attention through flash's
    route with 1 kv head, whisper-small's bidirectional attention through
    the plain dispatch's with 6): the output and the gradients of x, wq,
    wk, wv and wo equal the unsharded port's to 1e-5 relative."""
    res, port, _ = sharded
    for k in _group_layer_keys(port["layers"], tag):
        assert _rel(res[k], port["layers"][k]) <= DIST_F32_TOL, \
            (k, _rel(res[k], port["layers"][k]))


@pytest.mark.parametrize("tag", GROUP_LAYER_TAGS)
def test_group_rows_layer_matches_reference(sharded, tag):
    """The same against the reference's ``attention_seq`` (f32) and its
    ``jax.vjp``, to the model tolerance."""
    res, _, ref = sharded
    for k in _group_layer_keys(ref["layers"], tag):
        np.testing.assert_allclose(res[k], ref["layers"][k], atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=k)


def _rwkv_keys(want, tag):
    keys = sorted(k for k in want if k.startswith(f"{tag}/"))
    assert {f"{tag}/{k}" for k in (
        "out/tm", "out/state", "out/cm", "grad/x_tm", "grad/tm.wr",
        "grad/tm.tm_w1", "grad/tm.u", "grad/cm.wr", "grad/cm.wk")} <= \
        set(keys), keys
    return keys


@pytest.mark.parametrize("tag", RWKV_TAGS)
def test_rwkv_mixes_on_rows_match_unsharded_port(sharded, tag):
    """C9: rwkv6-7b's time mix and channel mix on x laid out as the
    residual stream (its rows cut over the 4 ``model`` ranks, each rank's
    LoRAs and d x d products on its own rows, the token shift across the
    ranks' blocks, the wkv6 by heads): the outputs, the final state, the
    last rows and the gradients of x and of every weight equal the
    unsharded port's to 1e-5 relative.  C13 (``rwkv2``): 2 heads, which
    the 4 ranks do not divide: each rank the wkv6 of its own block of
    rows from a zero state, the blocks' final states and summed logw
    gathered, the state carried into each block added; the same
    tolerance."""
    res, port, _ = sharded
    for k in _rwkv_keys(port["rwkv"], tag):
        assert res[k].shape == port["rwkv"][k].shape, k
        assert _rel(res[k], port["rwkv"][k]) <= DIST_F32_TOL, \
            (k, _rel(res[k], port["rwkv"][k]))


RWKV_TOL = 1e-4             # tests/test_torch_rwkv.py's f32 blocks
RWKV_GRAD_TOL = 5e-4        # tests/test_torch_train.py's rwkv6-7b grads


@pytest.mark.parametrize("tag", RWKV_TAGS)
def test_rwkv_mixes_on_rows_match_reference(sharded, tag):
    """The same against the reference's ``wkv_chunked`` and
    ``channel_mix`` and their ``jax.vjp``: the values to the rwkv tests' f32
    tolerance (1e-4, elementwise), the gradients to the train test's for
    rwkv6-7b's chunked path (5e-4 in relative norm: the plain chunked wkv
    rounds in another order, which the per-head group norm amplifies)."""
    res, _, ref = sharded
    for k in _rwkv_keys(ref["rwkv"], tag):
        if "/out/" in k:
            np.testing.assert_allclose(res[k], ref["rwkv"][k], atol=RWKV_TOL,
                                       rtol=RWKV_TOL, err_msg=k)
        else:
            assert _rel(res[k], ref["rwkv"][k]) <= RWKV_GRAD_TOL, \
                (k, _rel(res[k], ref["rwkv"][k]))


def test_rwkv_products_run_on_the_ranks_rows(sharded):
    """C9: rank 0 runs every product with a d x d weight (64 x 64: the
    time mix's five projections, its decay LoRA, the channel mix's
    receptance) on its own 32 rows (4 sequences x 8 positions), forward
    and backward; the data shard's 128 rows meet only the channel mix's
    ``ff`` columns (Megatron, as in the reference)."""
    res, _, _ = sharded
    prods = json.loads(str(res["rwkv/products"]))
    d = get_smoke_config("rwkv6-7b").d_model
    rows, shard_rows = B // 2 * S // 4, B // 2 * S
    dd = [p for p in prods if [d, d] in p]
    assert dd and all(rows in p[0] + p[1] for p in dd), dd
    assert all(shard_rows not in p[0] + p[1] for p in dd), dd
    assert any(shard_rows in p[0] + p[1] for p in prods)


@pytest.mark.parametrize("case", ["rr", "zero", "all"])
def test_partial_sums_reduce_in_one_collective(sharded, case):
    """C15 on a (2, 2, 2) ("pod", "data", "model") mesh of the 8 ranks
    (``worker.REDUCE_CASES``): partial sums over ``pod`` and ``data`` (2 x
    2), reduced to replicated, to a ZeRO shard over ``data``, and, partial
    over ``model`` too, to shards over ``data`` and ``model``.
    ``context.redistribute`` issues one all-reduce over the partial dims
    flattened (4 ranks, or 8), where DTensor's own issues one collective a
    mesh dim, one of them over ``pod`` alone (2 ranks); both equal the sum
    of the ranks' blocks, and each other to 1e-6 in f32."""
    import torch_dist_worker as worker
    res, _, _ = sharded
    g = _reduce_inputs()["reduce/g"].astype(np.float64)
    held = worker.REDUCE_CASES[case][0]
    want = g.sum(0) if held[2] == "P" else g[:4].sum(0)
    flat, steps = (res[f"reduce/{case}/{how}"] for how in ("flat", "steps"))
    assert _rel(flat, steps) <= 1e-6, _rel(flat, steps)
    assert _rel(flat, want) <= 1e-6, _rel(flat, want)
    flat_c, steps_c = (json.loads(str(res[f"reduce/{case}/{how}/"
                                          "collectives"]))
                       for how in ("flat", "steps"))
    assert flat_c == [["all-reduce", 8 if held[2] == "P" else 4]], flat_c
    assert len(steps_c) >= 2 and ["all-reduce", 2] in steps_c, steps_c


def test_vocab_parallel_loss_matches_the_full_logits(sharded):
    """``softmax_xent`` of logits sharded on the vocab over ``model`` (128
    columns a rank) and on the batch over ``data``, labels at every shard's
    edges and ignored ones: the loss, the count and the logits' gradient
    equal the plain call's on the full logits (f32, 1e-6 relative); the
    gradient stays sharded on the vocab; the ranks exchange no logits (no
    all-gather; the max, the sum and the label's logit all-reduced)."""
    res, port, _ = sharded
    want = port["xent"]
    assert abs(float(res["xent/loss"]) - float(want["xent/loss"])) <= \
        1e-6 * abs(float(want["xent/loss"]))
    assert int(res["xent/n"]) == int(want["xent/n"]) == XENT_B * XENT_S - 5
    assert _rel(res["xent/grad"], want["xent/grad"]) <= 1e-6
    assert str(res["xent/grad_place"]) == "(Shard(dim=0), Shard(dim=2))"
    stats = json.loads(str(res["xent/stats"]))
    assert stats["all-gather"]["count"] == 0
    assert stats["all-reduce"]["count"] >= 3
    assert stats["all-reduce"]["operand_bytes"] < \
        XENT_B * XENT_S * XENT_V * 4 / 8


def test_grad_shardings_take_zero_layout(sharded):
    """The grads and updates of the TRAIN_LOWERS cell sit at ``opt_pspecs``'
    ZeRO layout: every stacked layer tensor is sharded over ``data``
    (``layer_spec`` moved it off R)."""
    res, _, _ = sharded
    _, tc = _cfgs("g2t")
    names = [k[len("g2t/new/"):] for k in res if k.startswith("g2t/new/")]
    for n, pl in zip(names, res["g2t/grad_placements"]):
        if n.startswith("layers."):
            assert str(pl).startswith("(Shard"), (n, pl)


def test_decode_cache_is_sharded_over_its_slots(sharded):
    """``cache_pspecs``: batch over ``data``, the slots over ``model``
    (``kv_seq``), for the ring, the full and the int8 caches."""
    res, _, _ = sharded
    for cell in ("g2", "g2q"):
        for pl in res[f"{cell}/cache_placements"]:
            assert str(pl) == "(Shard(dim=1), Shard(dim=2))", (cell, pl)


def test_microbatch_takes_the_reference_rows_on_eight_data_ranks(sharded):
    """A batch of 64 rows sharded over 8 data ranks, ``grad_accum`` 4 (not
    a multiple of the ranks, which a DTensor reshape refuses): microbatch i
    is rows [16 i, 16 i + 16), as the reference's reshape
    (``repro/train/steps.py:55-59``) takes them, sharded over ``data``."""
    res, _, _ = sharded
    full = np.arange(64 * 4).reshape(64, 4)
    for i in range(4):
        np.testing.assert_array_equal(res[f"mb/{i}"],
                                      full.reshape(4, 16, 4)[i])
        assert str(res[f"mb/place{i}"]) == "(Shard(dim=0),)"


def test_shard_to_shard_is_an_all_to_all_on_gloo(sharded):
    """Shard(0) -> Shard(1) over ``data`` of an (8, 12) f32 under
    ``native_alltoall``: rank 0 holds columns 0-5 of every row, and the
    trace counts one all-to-all of its own (4, 12) in and (8, 6) out, no
    all-gather (DTensor's own CPU fallback would gather the whole dim)."""
    res, _, _ = sharded
    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    np.testing.assert_array_equal(res["a2a/local"], full[:, :6])
    stats = json.loads(str(res["a2a/stats"]))
    assert stats["all-to-all"] == {"count": 1, "operand_bytes": 4 * 12 * 4,
                                   "output_bytes": 8 * 6 * 4}
    assert stats["all-gather"]["count"] == 0


def test_fake_world_traces_what_the_real_ranks_run(sharded):
    """Rank 0 of a fake 2 x 4 world (no other process, no data moved)
    traces the same sharded smoke train step as rank 0 of the 8 gloo ranks
    running it on real CPU tensors: the same ops, op for op by name, the
    same flops and the same collectives, kind by kind, in bytes."""
    import torch_dist_worker as worker

    from repro_torch.launch.mesh import fake_mesh
    res, _, _ = sharded
    with fake_mesh(AbstractMesh(("data", "model"), (2, 4))) as mesh:
        fake = worker.traced_train_step(mesh)
    assert json.loads(fake["ops"]) == json.loads(str(res["trace/ops"]))
    assert int(fake["flops"]) == int(res["trace/flops"]) > 0
    real = json.loads(str(res["trace/collectives"]))
    assert json.loads(fake["collectives"]) == real
    assert sum(v["operand_bytes"] for v in real.values()) > 0
    # C3: flash on 1 of the 4 q heads (the q-heads route), the rank's
    # microbatch rows; C4: no all-gather of the f32 logits' rows
    cfg = get_smoke_config(worker.TRACE_ARCH)
    rows = worker.TRACE_B // worker.TRACE_ACCUM // 2
    S = worker.TRACE_S
    assert json.loads(fake["flash_q"]) == json.loads(str(res["trace/flash_q"])) \
        == [[rows, S, cfg.n_heads // 4, cfg.head_dim]]
    assert int(fake["largest_gather"]) == int(res["trace/largest_gather"]) \
        < rows * S * cfg.vocab_size * 4


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _same(got, want, what):
    got = got.full_tensor() if context.is_dtensor(got) else got
    assert torch.equal(got, want), what


ONE_RANK = ["g2", "g2q", "rg", "rw", "g2t", "rgt", "qw", "rwt"]


@pytest.mark.parametrize("cell", ONE_RANK)
def test_one_rank_mesh_is_bit_identical(one_rank, cell):
    """``shard_params`` on a 1 x 1 mesh: prefill, decode and the train step
    (``grad_shardings`` and ``update_constraint`` set) equal the plain
    model's bit for bit, through flash, the scan, the wkv6 and
    ``moe_sharded`` (which, on one rank, is the dense path)."""
    mesh = one_rank
    _, tc = _cfgs(cell)
    kinds = CELLS[cell][1]
    tokens = torch.from_numpy(_tokens(cell))[:4]
    shape = LM_SHAPES["train_4k" if kinds == "train" else "prefill_32k"]
    rules = layouts.choose_layout(tc, dataclasses.replace(
        shape, seq_len=S, global_batch=4), mesh)
    plain, model = _port_model(cell), _port_model(cell)
    layouts.shard_params(model, tc, rules, mesh)
    if kinds == "train":
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        gshard = layouts.param_placements(model, tc, layouts.opt_pspecs(
            layouts.param_pspecs(model, tc, rules), model, tc, mesh), mesh)
        runs = []
        for m, kw in ((plain, {}), (model, {"update_constraint": gshard})):
            opt = make_optimizer(tc.optimizer, cfg=tc, **kw)
            step = tsteps.build_train_step(
                tc, opt, lambda s: LR, grad_accum=2,
                grad_shardings=kw.get("update_constraint"))
            state = tsteps.init_train_state(None, tc, opt, params=m)
            if m is model:
                batch = layouts.distribute_tree(
                    batch, layouts.batch_pspecs(batch, rules), mesh)
            with context.use_rules(rules if m is model else None):
                runs.append(step(state, batch)[1])
        for k in ("loss", "grad_norm"):
            _same(runs[1][k], runs[0][k], k)
        want = dict(plain.named_parameters())
        for n, p in model.named_parameters():
            _same(p.detach(), want[n].detach(), n)
        return
    batch = {"tokens": tokens[:, :-1]}
    logits, cache = forward_prefill(plain, tc, batch)
    dbatch = layouts.distribute_tree(batch, layouts.batch_pspecs(
        batch, rules), mesh)
    with context.use_rules(rules):
        dlogits, dcache = forward_prefill(model, tc, dbatch)
    _same(dlogits, logits, "prefill logits")
    for i, (g, w) in enumerate(zip(_leaves(dcache), _leaves(cache))):
        _same(g, w, f"prefill cache leaf {i}")
    if "decode" not in kinds:
        return
    logits, cache = forward_decode(plain, tc, cache, tokens[:, -1:], S)
    drules = layouts.choose_layout(tc, dataclasses.replace(
        LM_SHAPES["decode_32k"], seq_len=S, global_batch=4), mesh)
    dcache = layouts.distribute_tree(dcache, layouts.cache_pspecs(
        dcache, tc, drules), mesh)
    tok = layouts.distribute_tree({"t": tokens[:, -1:]}, {"t": (None, None)},
                                  mesh)["t"]
    with context.use_rules(drules):
        dlogits, dcache = forward_decode(model, tc, dcache, tok, S)
    _same(dlogits, logits, "decode logits")
    for i, (g, w) in enumerate(zip(_leaves(dcache), _leaves(cache))):
        _same(g, w, f"decode cache leaf {i}")


def _dt(mesh, t, placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements)


@pytest.mark.parametrize("bad", ["seq", "head_dim", "partial"])
def test_flash_raises_on_a_placement_it_cannot_split(one_rank, bad):
    """Sharding the sequence or the head dim, or a Partial, raises with
    the placements in the message; nothing gathers or falls back."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.kernels.flash_attention import flash_attention
    mesh = one_rank
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 2, 2, 16, generator=g)
    k, v = (torch.randn(2, 16, 2, 16, generator=g) for _ in range(2))
    pl = {"seq": Shard(1), "head_dim": Shard(4), "partial": Partial()}[bad]
    dq = _dt(mesh, q, (Replicate(), Replicate()))
    if bad == "partial":
        dq = torch.distributed.tensor.DTensor.from_local(
            q, mesh, (Replicate(), pl), run_check=False)
    else:
        dq = _dt(mesh, q, (Replicate(), pl))
    dk, dv = (_dt(mesh, t, (Shard(0), Replicate())) for t in (k, v))
    with pytest.raises(ValueError, match="flash attention.*placements"):
        flash_attention(dq, dk, dv, scale=0.25, q_block=512, pack=True)


def test_recurrent_kernels_raise_on_a_sequence_shard(one_rank):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_chunk import wkv6
    mesh = one_rank
    g = torch.Generator().manual_seed(0)
    a = _dt(mesh, torch.rand(2, 16, 8, generator=g), (Shard(1), Replicate()))
    with pytest.raises(ValueError, match="RG-LRU.*cannot be split"):
        rglru_scan(a, a)
    r = _dt(mesh, torch.randn(2, 16, 2, 16, generator=g),
            (Replicate(), Shard(1)))
    u = _dt(mesh, torch.randn(2, 16, generator=g), (Replicate(), Shard(1)))
    with pytest.raises(ValueError, match="wkv6.*cannot be split"):
        wkv6(r, r, r, -r.abs(), u)


def test_kernels_run_local_shards_of_splittable_dtensors(one_rank):
    """On a mesh of one, shards of the split axes cut nothing: the
    wrappers run the plain version on the local tensors, return the plain
    call's values bit for bit, replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_chunk import wkv6
    mesh = one_rank
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 16, 2, 2, 16, generator=g)
    k, v = (torch.randn(2, 16, 2, 16, generator=g) for _ in range(2))
    o = flash_attention(_dt(mesh, q, (Shard(0), Shard(2))),
                        _dt(mesh, k, (Shard(0), Replicate())),
                        _dt(mesh, v, (Replicate(), Shard(2))), scale=0.25,
                        q_block=512, pack=True)
    assert o.placements == (Replicate(), Replicate())
    _same(o, flash_attention(q, k, v, scale=0.25, q_block=512, pack=True), "flash")
    r, kk, vv = (torch.randn(2, 16, 2, 16, generator=g) for _ in range(3))
    w, u = -torch.rand(2, 16, 2, 16, generator=g), torch.randn(2, 16,
                                                               generator=g)
    y, st = wkv6(*(_dt(mesh, t, (Shard(0), Shard(2))) for t in (r, kk, vv, w)),
                 _dt(mesh, u, (Replicate(), Shard(0))))
    wy, wst = wkv6(r, kk, vv, w, u)
    _same(y, wy, "wkv6 y")
    _same(st, wst, "wkv6 state")


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce"])
def test_collectives_copy_nothing_on_one_rank(one_rank, op):
    """C2: over a group of one rank each collective returns a view of its
    input (the same storage, no allocation) and its backward passes the
    gradient through."""
    mesh = one_rank
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = {"all_gather": lambda: coll.all_gather(x, ("data", "model"), 1, mesh),
         "reduce_scatter": lambda: coll.reduce_scatter(x, "model", 1, mesh),
         "all_reduce": lambda: coll.all_reduce(x, ("data", "model"), mesh),
         }[op]()
    assert y is not x
    assert y.data_ptr() == x.data_ptr()
    assert y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert torch.equal(y, x)
    g = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    y.backward(g)
    assert torch.equal(x.grad, g)


# arch -> how flash splits its heads over 4 and over 16 ``model`` ranks
HEAD_SPLITS = {
    "arctic-480b": ("kv_heads", "q_rows"),
    "gemma2-9b": ("kv_heads", "q_heads"),
    "gemma3-1b": ("q_heads", "q_rows"),
    "h2o-danube-1.8b": ("kv_heads", "q_heads"),
    "internlm2-20b": ("kv_heads", "q_heads"),
    "paligemma-3b": ("q_heads", "q_rows"),
    "qwen3-moe-235b-a22b": ("kv_heads", "q_heads"),
    "recurrentgemma-2b": ("q_rows", "q_rows"),
    "rwkv6-7b": ("kv_heads", "kv_heads"),
    "whisper-small": ("kv_heads", "q_rows"),
}


def _flash_local_q(H, K, hd, tp, kv_split, rank=0):
    """``rank``'s flash on meta DTensors of (2, 8) tokens on a fake
    (1, tp) mesh: q cut on its heads over ``model`` where ``tp`` divides
    them (flat unless the kv heads split too), else whole there and flat
    (the q-rows route) -> (the local output's shape, the q shape the kernel
    recorded, the flops it recorded)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.roofline.trace import OpTrace
    with fake_mesh(AbstractMesh(("data", "model"), (1, tp)), rank) as mesh:
        def dt(shape, d):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     (Replicate(), Shard(d) if d else
                                      Replicate()))
        q = dt((2, 8, K, H // K, hd) if kv_split else (2, 8, H, hd),
               2 if H % tp == 0 else None)
        k, v = (dt((2, 8, K, hd), 2 if kv_split else None) for _ in "kv")
        with OpTrace() as trace:
            o = flash_attention(q, k, v, scale=0.25, q_block=512, pack=True)
    [op] = [op for op in trace.ops if op.name == "flash_attention"]
    return tuple(o.to_local().shape), op.shape, op.flops


@pytest.mark.parametrize("tp", [4, 16])
@pytest.mark.parametrize("arch", sorted(HEAD_SPLITS))
def test_each_arch_takes_one_head_split(arch, tp):
    """C3, C5 and C10: each arch's full config at 4 and 16 ``model`` ranks
    takes exactly one of flash's three layouts, the one the reference's
    rules imply: kv heads split (``kv_heads`` on ``model``), q heads split
    with each rank's H / tp heads reading one kv head, which rank 0 runs at
    those local shapes (its q (B, S, 1 kv head, H / tp, hd) in the kernel's
    layout), or, where ``tp`` does not divide the heads (``heads`` on
    nothing), g = gcd(H, tp) groups of H / g heads, each group's rows split
    over n = tp / g ranks: rank 0 runs the first 8 / n rows of group 0 and
    the last rank the last rows of the last group, with more causal pairs,
    in the kernel's layout (B * kv heads, rows, q heads a kv head, hd): the
    group's kv heads where it holds whole kv groups (whisper-small's 3 of
    12), else the one kv head it lies in (recurrentgemma-2b's 5 of 10 q
    heads, arctic-480b's 7 of 56 on one of 8), and the output is gathered
    whole.  No arch replicates its attention any more."""
    from repro_torch.distributed.heads import head_split, row_groups
    from repro_torch.roofline.bounds import flash_work
    cfg = get_config(arch)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    how = head_split(H, K, tp)
    assert how == HEAD_SPLITS[arch][tp == 16]
    rules = layouts.choose_layout(cfg, LM_SHAPES["train_4k"],
                                  AbstractMesh(("data", "model"), (16, tp)))
    assert (rules.rules["kv_heads"] == "model") == (how == "kv_heads")
    assert (rules.rules["heads"] is None) == (how == "q_rows")
    out, kernel_q, _ = _flash_local_q(H, K, hd, tp, how == "kv_heads")
    if how == "kv_heads":
        assert out == (2, 8, K // tp, H // K, hd)
        assert kernel_q == (2 * K // tp, 8, H // K, hd)
    elif how == "q_heads":
        assert out == (2, 8, H // tp, hd)
        assert kernel_q == (2, 8, H // tp, hd)
    else:
        g, n = row_groups(H, tp)
        rows, h = 8 // n, H // g
        nk = max(h // (H // K), 1)
        first = _flash_local_q(H, K, hd, tp, False)
        last = _flash_local_q(H, K, hd, tp, False, rank=tp - 1)
        assert out == last[0] == (2, 8, H, hd)
        assert kernel_q == last[1] == (2 * nk, rows, h // nk, hd)
        assert first[2] == flash_work(2 * nk, rows, rows, h // nk, hd)[0]
        assert last[2] == flash_work(2 * nk, rows, 8, h // nk, hd,
                                     q0=8 - rows)[0] > first[2]


@pytest.mark.parametrize("H,K,tp", [(24, 6, 4), (12, 4, 6)])
def test_other_head_layouts_raise(H, K, tp):
    """q heads that split over ``model`` where each rank's H / tp heads
    read more than one kv head: ``head_split`` and flash's DTensor route
    raise with (H, K, tp) and the placements; nothing is replicated."""
    from repro_torch.distributed.heads import head_split
    with pytest.raises(ValueError, match=rf"\({H}, {K}, {tp}\)"):
        head_split(H, K, tp)
    with pytest.raises(ValueError, match=rf"\({H}, {K}, {tp}\).*"
                       "placements q"):
        _flash_local_q(H, K, 16, tp, False)


def test_q_rows_route_raises_on_rows_that_do_not_split():
    """4 q heads over 16 ``model`` ranks spread each head over 4 ranks: 6
    rows do not split 4 ways, and the route raises with (H, K, tp, S)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh(AbstractMesh(("data", "model"), (1, 16))) as mesh:
        q, k, v = (distribute_tensor(torch.empty(s, device="meta"), mesh,
                                     (Replicate(), Replicate()))
                   for s in ((2, 6, 4, 16), (2, 6, 2, 16), (2, 6, 2, 16)))
        with pytest.raises(ValueError, match=r"\(4, 2, 16, 6\)"):
            flash_attention(q, k, v, scale=0.25, q_block=512, pack=True)


@pytest.mark.parametrize("mask_mode", ["prefix", "bidir"])
def test_plain_q_rows_route_raises_on_rows_that_do_not_split(mask_mode):
    """The plain dispatch's q-rows route (C6) on 4 q heads over 16
    ``model`` ranks: 6 rows do not split over a head's 4 ranks, and it
    raises with (H, K, tp, S); nothing is replicated."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.attention import attention_q_rows
    with fake_mesh(AbstractMesh(("data", "model"), (1, 16))) as mesh:
        q, k, v = (distribute_tensor(torch.empty(s, device="meta"), mesh,
                                     (Replicate(), Replicate()))
                   for s in ((2, 6, 4, 16), (2, 6, 2, 16), (2, 6, 2, 16)))
        with pytest.raises(ValueError,
                           match=r"attention cannot split \(H, K, tp, S\) = "
                           r"\(4, 2, 16, 6\)"):
            attention_q_rows(q, k, v, mask_mode=mask_mode, prefix_len=2,
                             scale=0.25, q_block=4, pack=True)


@pytest.mark.parametrize("route", ["flash", "plain"])
def test_head_groups_raise_on_rows_that_do_not_split(route):
    """C10's route: 6 q heads over 4 ``model`` ranks fall into 2 groups of
    3, each group's rows over 2 ranks; 5 rows do not split 2 ways, and
    flash's route and the plain dispatch's raise with (H, K, tp, S);
    nothing is replicated."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.attention import attention_q_rows
    with fake_mesh(AbstractMesh(("data", "model"), (1, 4))) as mesh:
        q, k, v = (distribute_tensor(torch.empty(s, device="meta"), mesh,
                                     (Replicate(), Replicate()))
                   for s in ((2, 5, 6, 16), (2, 5, 1, 16), (2, 5, 1, 16)))
        with pytest.raises(ValueError, match=r"\(6, 1, 4, 5\)"):
            if route == "flash":
                flash_attention(q, k, v, scale=0.25, q_block=512, pack=True)
            else:
                attention_q_rows(q, k, v, mask_mode="bidir", scale=0.25,
                                 q_block=4, pack=True)


def test_head_groups_across_kv_heads_raise():
    """10 q heads over 4 ``model`` ranks: 2 groups of 5 q heads, which
    hold no whole kv group of 2 (5 kv heads) and lie in more than one kv
    head: ``head_split`` raises with (H, K, tp)."""
    from repro_torch.distributed.heads import head_split
    with pytest.raises(ValueError, match=r"\(10, 5, 4\)"):
        head_split(10, 5, 4)


def test_layer_spec_moves_the_layer_axis():
    """The reference shards R itself where ``opt_pspecs`` finds it free;
    a layer takes ``data`` on its next free dim that ``data`` divides, or
    is replicated over it.  The counts stated in layouts.py's docstring."""
    mesh = AbstractMesh(("data", "model"), (2, 4))
    assert layouts.layer_spec(("data", None, "model"), (64, 16), True,
                              mesh) == ("data", "model")
    assert layouts.layer_spec(("data", "model"), (64,), True,
                              mesh) == ("model",)
    assert layouts.layer_spec(("data", None), (3,), True, mesh) == (None,)
    assert layouts.layer_spec(("data", None), (3,), False, mesh) == \
        ("data", None)
    counts = {}
    for arch in ("gemma2-9b", "recurrentgemma-2b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(get_smoke_config(arch), attn_q_block=16)
        rules = layouts.choose_layout(cfg, dataclasses.replace(
            LM_SHAPES["train_4k"], seq_len=S, global_batch=B), mesh)
        model = init_params(cfg, None, device="meta")
        ps = layouts.param_pspecs(model, cfg, rules)
        assert not any(s and s[0] for k, s in ps.items()
                       if k.startswith("blocks/"))
        shapes = layouts._stacked_shapes(model, cfg)
        on_r = moved = 0
        for key, spec in layouts.opt_pspecs(ps, model, cfg, mesh).items():
            if key.startswith("blocks/") and spec and spec[0]:
                on_r += 1
                moved += "data" in str(layouts.layer_spec(
                    spec, shapes[key][1:], True, mesh))
        counts[arch] = (on_r, moved)
    assert counts == {"gemma2-9b": (22, 22), "recurrentgemma-2b": (39, 31),
                      "qwen3-moe-235b-a22b": (9, 9)}


# ---------------------------------------------------------------------------
# chip_smoke.py's [multirank] inputs and the shared oracle (no spawn)
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def _weights(inp) -> set:
    """The keys of the inputs whose arrays are weights: the reference's in
    ``_inputs``, the port's own in ``chip_smoke.multirank_inputs``."""
    keys = {k for k in inp if "/p/" in k}
    keys |= {f"{tag}/{n}" for tag in worker.GROUP_LAYERS
             for n in ("wq", "wk", "wv", "wo")}
    for arch in MOE_DENSE:
        pre = f"moed/{arch}/"
        keys |= {pre + n for n in worker.moe_dense_weights(inp, pre)}
    return keys


def test_chip_smoke_builds_the_inputs_the_test_writes():
    """``chip_smoke.multirank_inputs`` (no JAX: the port's own weights from
    seeded generators) writes the keys, shapes and dtypes of ``_inputs``
    (the reference's weights), and every array that is not a weight
    (tokens, whisper's and paligemma's batches, the parts' x, cotangents
    and draws) equal."""
    got, want = _chip_smoke().multirank_inputs(None), _inputs()
    assert set(got) == set(want), set(got) ^ set(want)
    weights = _weights(want)
    for k, w in want.items():
        assert (got[k].shape, got[k].dtype) == (w.shape, w.dtype), k
        if k not in weights:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert any(not np.array_equal(got[k], want[k]) for k in weights)


def _same_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same_tree(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{what}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


@pytest.mark.parametrize("cell", ["g2", "g2t"])
def test_shared_oracle_is_port_run_bit_for_bit(cell):
    """``worker.port_run`` (the cell's config, weights, tokens and batches
    as the ranks read them from the inputs) gives ``_port_run``'s outputs
    (the reference's weights carried across, this module's batches) bit
    for bit: gemma2-9b's prefill and decode, and its train step at
    ``grad_accum=2``."""
    _same_tree(worker.port_run(_inputs(), cell), _port_run(cell), cell)


def test_full_width_cell_reads_its_config_and_seed():
    """``chip_smoke.MULTIRANK_FULL_CELL`` at full width: rwkv6-7b's full
    config cut to one layer in f32, its weights drawn by each rank from
    its seed (none in the inputs), 8 x 33 tokens in the full vocab; and
    ``seeded_model`` draws the same weights twice, its zero leaves given
    values."""
    cs = _chip_smoke()
    inp = cs.multirank_inputs("full")
    cell, arch, layers = cs.MULTIRANK_FULL_CELL
    assert str(inp["cells"]).split(",")[-1] == cell
    assert not any(k.startswith(f"{cell}/p/") for k in inp)
    cfg = worker.cell_config(inp, cell)
    full = get_config(arch)
    assert (cfg.n_layers, cfg.param_dtype, cfg.d_model, cfg.vocab_size) \
        == (layers, "float32", full.d_model, full.vocab_size)
    assert inp[f"{cell}/tokens"].shape == (B, S + 1)
    assert 2 <= inp[f"{cell}/tokens"].min() and \
        inp[f"{cell}/tokens"].max() < full.vocab_size
    small = worker.rwkv_config("rwkv", get_smoke_config)
    a, b = (dict(worker.seeded_model(small, 3).named_parameters())
            for _ in range(2))
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert all(a[n].abs().sum() > 0 for n in a
               if n.rpartition(".")[2] in NORMAL)


@pytest.mark.parametrize("experts", [6, 8])
def test_moe_dense_ffn_takes_the_rows_gathered(experts):
    """C18: arctic's parallel dense FFN in the DTensor ``moe_layer`` takes
    its input gathered over ``act_seq`` (batch over ``data``, the
    sequence whole), as the layer's sublayers do, where x comes cut on its
    sequence, and its output's gradient comes back gathered too: torch
    2.11 refused to view either, cut on the sequence, as rows for the
    products.  On rank 0 of a fake 2 x 4 world, meta tensors, forward and
    backward: the fallback (6 experts on 4 ``model`` ranks) and
    ``moe_sharded`` (8); the output keeps x's layout."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.modules import MLP
    from repro_torch.roofline.trace import OpTrace
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))
    seen, grads, mlp = [], [], tmoe.mlp

    def spy(p, x, act):
        seen.append(tuple(x.placements))
        o = mlp(p, x, act)
        o.register_hook(lambda g: grads.append(tuple(g.placements)))
        return o
    p = tmoe.init_moe(cfg, None, torch.device("meta"))
    with fake_mesh(AbstractMesh(("data", "model"), (2, 4))) as mesh:
        rules = layouts.choose_layout(cfg, dataclasses.replace(
            LM_SHAPES["train_4k"], seq_len=S, global_batch=B), mesh)

        def dt(t, logical):
            return distribute_tensor(t.detach(), mesh,
                                     rules.placements(logical))
        q = tmoe.MoE({n: dt(getattr(p, n), lg) for n, lg in (
            ("router", (None, None)), ("w_gate", ("experts", None, "moe_ff")),
            ("w_up", ("experts", None, "moe_ff")),
            ("w_down", ("experts", "moe_ff", None)))}, MLP({
                n: dt(getattr(p.dense, n), lg) for n, lg in (
                    ("w_gate", (None, "ff")), ("w_up", (None, "ff")),
                    ("w_down", ("ff", None)))}))
        rows = rules.placements(("batch", "act_seq", None))
        x = distribute_tensor(torch.empty(B, S, cfg.d_model, device="meta"),
                              mesh, rows).requires_grad_()
        tmoe.mlp = spy
        try:
            with context.use_rules(rules), OpTrace():
                y, _ = tmoe.moe_layer(q, x, cfg)
                y.backward(distribute_tensor(torch.empty(y.shape,
                                                         device="meta"),
                                             mesh, y.placements))
        finally:
            tmoe.mlp = mlp
        gathered = rules.placements(("batch", "seq", None))
    assert rows != gathered
    assert seen == grads == [gathered], (seen, grads)
    assert y.placements == rows
