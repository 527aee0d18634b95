"""The JAX reference's outputs at full width, on the port's weights (not a
test module: it writes the files the port is held to).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py \
        [--cells gemma3-1b,whisper-small | --cells timed | --cells
         rwkv6-7b@4x1024] [--out PATH]
    ... tests/reference_golden.py --sensitivity rwkv6-7b@4x1024 \
        [--dtype float32] [--rows 1] [--layers 1,2,4,8,16,32]
    ... tests/reference_golden.py --int8-cache build/int8_cache.npz

For each cell and dtype it draws the port's weights (``golden.model``: a
``BlockDraws`` of ``golden.SEED``, the zero-initialised leaves given
draws), carries them to the reference's params tree leaf by leaf
(``carry``: each leaf stacked as ``models.weights.params_to_numpy`` stacks
it, cast to the reference's dtype, and the port's tensors of that leaf
freed before the next, so that the weights are held about once), runs the
reference's prefill with the logits of every position and 8 decode steps
fed the cell's tokens, both jitted, with the flash hook off (the jnp
path), and keeps what ``golden.summarize`` keeps of the logits, beside
the weights' checksums and the inputs.  A cell with an engine record also
runs the reference's ``ServingEngine`` in f32 on the engine's prompts,
its ``_decode`` wrapped by ``golden.EngineRecord``.

The cells of ``golden.CELLS`` go to ``tests/golden/full_width.npz`` (all
of them ~5.5 min and ~20 GB on 8 cores); those of ``golden.TIMED``
(``--cells timed``, or their names) to ``tests/golden/timed.npz``.  With
``--cells`` it rewrites those cells' records and keeps the file's others,
so each timed cell can be written in a process of its own.  The timed
cells, full depth at 4 x 1024, on 8 cores (f32 and bf16 together, the
engine with the f32): rwkv6-7b ~25 min and ~40 GB (its 7.6 B f32 weights,
once), recurrentgemma-2b and paligemma-3b ~8 min and ~20 GB each,
gemma3-1b ~5 min, its int8 cache ~3 min, whisper-small ~1 min.

The train cells (``reference_train``, ``golden.TRAIN``) go to
``tests/golden/train.npz``, the same cells over three steps
(``reference_train_steps``, ``golden.TRAIN_STEPS``, ``--cells
h2o-danube-1.8b@steps``) to ``tests/golden/train_steps.npz``; ``--dtype``
writes one dtype's records and keeps the file's others, so that a cell
whose two dtypes together pass the host's memory (paligemma-3b's) is
written a dtype a process.

``--sensitivity`` measures how far rounding alone moves a cell's logits
at each depth (``sensitivity``; rwkv6-7b at 2-4 layers and 4 rows ~80 s a
depth), and ``--int8-cache`` writes the reference's int8 KV cache after
the int8 cell's f32 prefill (``int8_cache``; ~1 min), which ``python -m
repro_torch.launch.golden --int8-flips PATH`` compares with the port's.

``reference_run`` is also what tests/test_torch_full_width.py and
tests/test_torch_timed_golden.py call to hold the files to the reference.
"""
import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import resource
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _prefill_all(params, batch, *, cfg):
    """The reference's ``forward_prefill`` with every position unembedded
    (its own functions, its last-position slice left out)."""
    from repro.models import transformer as jtf
    x, positions, mask_mode, prefix_len, enc_out = jtf._prep_inputs(
        params, cfg, batch)
    x, _, cache = jtf._run_stack(params, x, cfg, positions, mask_mode,
                                 prefix_len, enc_out, want_cache=True)
    return jtf._unembed(params, cfg, x), cache


def carry(model, tcfg, jcfg) -> dict:
    """The port's ``model`` as the reference's params tree, leaf by leaf:
    each leaf's layers stacked, widened to numpy as ``params_to_numpy``
    does, put in the dtype of the reference's own ``init_params`` leaf, and
    the port's tensors of that leaf dropped before the next.  ``model`` is
    emptied (its parameters on the meta device)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtf
    from repro_torch.models.weights import (_numpy, reference_tree, stack,
                                            stacked_view)

    named = {n: p.detach() for n, p in model.named_parameters()}
    model.to("meta")
    view = stacked_view(named, tcfg)
    keys = reference_tree({k: k for k in view}, tcfg)
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    if jax.tree.structure(keys) != jax.tree.structure(shapes):
        raise ValueError("the port's tree is not the reference's")
    want = dict(zip(jax.tree.leaves(keys), jax.tree.leaves(shapes)))
    leaves = {}
    for key, names in view.items():
        a = _numpy(stack(key, [named.pop(n) for n in names]))
        if a.shape != want[key].shape:
            raise ValueError(f"{key}: {a.shape} in the port, "
                             f"{want[key].shape} in the reference")
        leaves[key] = jnp.asarray(a, want[key].dtype)
        del a
    return reference_tree(leaves, tcfg)


def reference_run(name: str, dtype: str) -> dict:
    """One cell in ``dtype`` through the reference: {"names", "sums",
    "inputs", "prefill", "decode"[, "engine"]} as ``golden.pack`` takes
    it."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_config as jax_config
    from repro.kernels import disable_flash_attention
    from repro.models import transformer as jtf
    from repro_torch.launch import golden

    disable_flash_attention()
    tcfg = golden.cell_config(name, dtype)
    jcfg = golden.cell_config(name, dtype, jax_config)
    model = golden.model(tcfg, golden.SEED, "cpu")
    names, sums = golden.checksums(model)
    params = carry(model, tcfg, jcfg)
    del model

    inp = golden.inputs(name, tcfg)
    batch = {k: jnp.asarray(v) for k, v in inp.items()
             if k not in ("decode", "prompts")}
    dirs = torch.tensor(golden.directions(tcfg.vocab_size))

    def summary(logits):
        x = np.asarray(logits).astype(np.float32)
        return golden.summarize(torch.from_numpy(
            x.reshape(-1, x.shape[-1])), dirs)
    logits, cache = jax.jit(functools.partial(_prefill_all, cfg=jcfg))(
        params, batch)
    prefill = summary(logits)
    del logits
    decode = jax.jit(lambda p, c, t, pos: jtf.forward_decode(p, jcfg, c, t,
                                                             pos))
    start, steps = golden.decode_start(tcfg, inp), []
    for i, t in enumerate(inp["decode"]):
        tok = jnp.asarray(np.asarray(t, np.int32).reshape(-1, 1))
        logits, cache = decode(params, cache, tok, jnp.int32(start + i))
        steps.append(summary(logits[:, 0]))
    del cache
    out = {"names": names, "sums": sums, "inputs": inp, "prefill": prefill,
           "decode": golden.concat(steps)}
    if dtype == "float32" and "prompts" in inp:
        out["engine"] = reference_engine(jcfg, params, inp["prompts"], dirs)
    else:
        inp.pop("prompts", None)
    return out


def _sample(leaf, r, idx, norm=True) -> tuple:
    """(f64 sum of squares, or None without ``norm``; f64 samples at
    ``idx``) of layer ``r`` of a reference leaf (``r`` None: the leaf),
    through a view of its buffer."""
    import torch

    from repro_torch.launch import golden
    a = np.asarray(leaf)
    if not norm:
        a = a if r is None else a[r]
        return None, a.reshape(-1)[idx].astype(np.float64)
    a = np.ascontiguousarray(a if r is None else a[r])
    with warnings.catch_warnings():   # a read-only buffer, only read here
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            if a.dtype.name == "bfloat16" else torch.from_numpy(a)
    return golden.squares(t), t.reshape(-1)[torch.from_numpy(idx)].double(
        ).numpy()


def reference_train(name: str, dtype: str, layers=None, nudge=False,
                    seq_exact=None) -> dict:
    """One train cell of ``golden.TRAIN`` in ``dtype`` through the
    reference: ``reference_train_steps``' one step (its loss and grads on
    batch 0, the clipped grads, its optimizer's first update, the loss on
    batch 1 after it) as ``golden.pack_train`` takes it: {"names", "sums",
    "numels", "batches", "scalars" (``golden.SCALARS``), "grad_norms",
    "grad", "update"}."""
    r = reference_train_steps(name, dtype, 1, layers, nudge, seq_exact)
    s = r["steps"][0]
    return {"names": r["names"], "sums": r["sums"], "numels": r["numels"],
            "batches": r["batches"],
            "scalars": {**s["scalars"], "loss_after": r["loss_after"]},
            "grad_norms": s["grad_norms"], "grad": s["grad"],
            "update": s["update"]}


def reference_train_steps(name: str, dtype: str, steps=None, layers=None,
                          nudge=False, seq_exact=None) -> dict:
    """One cell of ``golden.TRAIN_STEPS`` in ``dtype`` through the
    reference over ``steps`` steps (default ``golden.STEPS``) from one
    optimizer state: its ``init`` once, then on batches 0..steps-1 in turn
    the jitted ``value_and_grad`` of ``loss_fn``, its clip split out as
    ``reference_train``'s, and its ``update`` (one jit, compiled once, the
    grads, the state and the params donated), then the loss on batch
    ``steps``.  Each step keeps its scalars and each parameter's grad norm
    and samples (``golden.train_indices``; past step 1 ``golden.thinned``)
    and update samples (AdamW's f32 master); after the last step the
    state at the thinned indices (AdamW: m, v; Adafactor:
    ``golden.state_indices``' ``vr`` and ``vc`` of a factored leaf, ``v``
    of the others) and its count.  Returns ``golden.pack_train_steps``'
    record.  ``layers``, ``nudge``: as ``reference_train``'s, for
    ``--sensitivity``; ``seq_exact``: the exact sequential wkv (default:
    the cell's ``seq_exact``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.kernels import disable_flash_attention
    from repro.models import transformer as jtf
    from repro.optim import make_optimizer
    from repro.optim.optimizers import clip_by_global_norm
    from repro.train import steps as jsteps
    from repro_torch.launch import golden
    from repro_torch.models.weights import leaf_of

    disable_flash_attention()
    steps = steps or golden.STEPS
    if seq_exact is None:
        seq_exact = golden.cell(name).seq_exact
    forward = mock.patch.object(jsteps, "forward_train", functools.partial(
        jtf.forward_train, seq_exact=True)) if seq_exact else \
        contextlib.nullcontext()
    cut = {"n_layers": layers} if layers else {}
    tcfg = dataclasses.replace(golden.cell_config(name, dtype), **cut)
    jcfg = dataclasses.replace(golden.cell_config(name, dtype, jax_config),
                               **cut)
    m = golden.model(dataclasses.replace(tcfg, param_dtype="float32"))
    if dtype != "float32":
        m = golden.cast(m, tcfg)
    names, sums = golden.checksums(m)
    numels = [p.numel() for p in m.parameters()]
    shapes = [tuple(p.shape) for p in m.parameters()]
    params = carry(m, tcfg, jcfg)
    del m
    if nudge:                    # one ulp of the embedding's dtype
        params["embed"] = params["embed"] * (
            1 + jnp.finfo(params["embed"].dtype).eps)
    where = [leaf_of(n, tcfg) for n in names]
    idx = [golden.train_indices(n, k) for n, k in zip(names, numels)]

    def at(tree, i):
        key, r = where[i]
        leaf = tree
        for p in key.split("/"):
            leaf = leaf[int(p)] if isinstance(leaf, (tuple, list)) else leaf[p]
        return leaf, r

    batches = [golden.train_batch(name, tcfg, s) for s in range(steps + 1)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    loss = jax.jit(lambda p, b: jsteps.loss_fn(p, jcfg, b))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, jcfg, b), has_aux=True))
    clip = jax.jit(lambda g: clip_by_global_norm(g, golden.MAX_GRAD_NORM),
                   donate_argnums=0)
    opt = make_optimizer(jcfg.optimizer, max_grad_norm=math.inf)
    adamw = jcfg.optimizer == "adamw"
    update = jax.jit(lambda g, st, p: opt.update(g, st, p, golden.LR)[:2],
                     donate_argnums=(0, 1, 2))
    # the first step inits the state inside its update, as
    # ``reference_train`` does: XLA folds the zeros, and its rounding is then
    # that of train.npz's step bit for bit
    first = jax.jit(lambda p, g: opt.update(g, opt.init(p), p, golden.LR),
                    donate_argnums=0)
    st = None

    def base(tree):
        return [_sample(*at(tree, i), idx[i], norm=False)[1]
                for i in range(len(names))]
    before, out = base(params), []    # AdamW's master starts as the params
    for s in range(steps):
        t0 = time.perf_counter()  # repro: allow(DB001): progress report
        with forward:
            (_, metrics), grads = value_and_grad(params, jb[s])
        grads, gn = clip(grads)
        sq, gs = zip(*[_sample(*at(grads, i), idx[i])
                       for i in range(len(names))])
        params, st = update(grads, st, params) if s else first(params,
                                                               grads)[:2]
        del grads
        now = base(st["master"] if adamw else params)
        out.append({"names": names, "numels": numels,
                    "scalars": {"loss": float(metrics["loss"]),
                                "aux": float(metrics["aux"]),
                                "grad_norm": float(gn)},
                    "grad_norms": np.sqrt(sq),
                    "grad": [golden.thinned(g, s, n)
                             for g, n in zip(gs, names)],
                    "update": [golden.thinned(b - a, s, n)
                               for a, b, n in zip(before, now, names)],
                    "base": [golden.thinned(a, s, n)
                             for a, n in zip(before, names)]})
        before = now
        print(f"  step {s + 1}: {time.perf_counter() - t0:.0f} s", flush=True)
    state = {}
    for i in range(len(names)):
        key, r = where[i]
        thin = golden.thinned(idx[i], golden.STEPS, names[i])
        if adamw:
            for k in ("m", "v"):
                state.setdefault(k, []).append(
                    _sample(*at(st[k], i), thin, norm=False)[1])
            continue
        leaf, _ = at(st["vs"], i)
        ix = golden.state_indices(shapes[i], thin, r)
        for k in ("vr", "vc", "v"):
            state.setdefault(k, []).append(
                np.asarray(leaf[k])[ix[k]].astype(np.float64) if k in ix
                else None)
    with forward:
        after = loss(params, jb[steps])[1]
    return {"names": names, "sums": sums, "numels": numels,
            "batches": batches, "steps": out,
            "loss_after": float(after["loss"]), "state": state,
            "count": int(st["count"])}


def check_first_step(name: str, dtype: str, rec: dict) -> dict:
    """``reference_train_steps``' first step against ``train.npz``'s record
    of the same cell as it is stored there (f32 samples): the largest
    difference of each part (0 where they are the same), and batch 1's loss
    before step 2 against the file's loss after step 1 (another jit)."""
    from repro_torch.launch import golden
    want = golden.stored_train(golden.load(golden.TRAIN_GOLDEN),
                               golden.train_name(name), dtype)
    s = rec["steps"][0]
    f32 = np.float32

    def diff(a, b):
        return float(np.max(np.abs(np.concatenate(a).astype(f32).astype(
            np.float64) - np.concatenate(b))))
    return {"names": rec["names"] == want["names"],
            "scalars": max(abs(s["scalars"][k] - want["scalars"][k])
                           for k in golden.STEP_SCALARS),
            "grad_norms": float(np.max(np.abs(np.asarray(s["grad_norms"]) -
                                              want["grad_norms"]))),
            "grad": diff(s["grad"], want["grad"]),
            "update": diff(s["update"], want["update"]),
            "loss_after_rel": golden.rel(rec["steps"][1]["scalars"]["loss"]
                                         if len(rec["steps"]) > 1 else
                                         rec["loss_after"],
                                         want["scalars"]["loss_after"])}


def train_sensitivity(name: str, dtype: str, layers: int) -> dict:
    """How far rounding alone moves a train cell's steps at ``layers``
    layers (a ``golden.TRAIN`` cell's one step, a ``golden.TRAIN_STEPS``
    cell's ``golden.STEPS``): at each step, each parameter's grad
    (``golden.leaf_errors``) and update (relative in norm over its
    samples) of the port on the CPU (the kernels' plain versions) and of
    the reference with its embedding moved one ulp, against the
    reference, each pair's largest and median error over the parameters
    (as ``sensitivity`` does for the logits), and as the port is held
    ("held": ``golden.compare_train_steps``' worst grad, update and state
    at each step, with their leaves); for a cell of the chunked wkv also
    the reference's exact sequential one (``seq_exact``) against it and
    the port."""
    from repro_torch.launch import golden
    t0 = time.perf_counter()  # repro: allow(DB001): progress report
    steps = 1 if name in golden.TRAIN else golden.STEPS
    ref, moved = (golden.with_losses_after(r, r["loss_after"]) for r in (
        reference_train_steps(name, dtype, steps, layers),
        reference_train_steps(name, dtype, steps, layers, nudge=True)))
    cfg = dataclasses.replace(golden.cell_config(name, dtype),
                              n_layers=layers)
    m = golden.model(dataclasses.replace(cfg, param_dtype="float32"))
    if dtype != "float32":
        m = golden.cast(m, cfg)
    port = golden.train_steps_record(m, cfg, ref["batches"], "cpu",
                                     len(ref["steps"]))

    def distances(a, b):
        out = []
        for x, y in zip(a["steps"], b["steps"]):
            d = golden.leaf_errors(x, y)
            u = [golden.rel(p, q) for p, q in zip(x["update"], y["update"])]
            out.append({"grad_worst": max(d), "grad_median": float(
                np.median(d)), "update_worst": max(u),
                "update_median": float(np.median(u)),
                "loss": golden.rel(x["scalars"]["loss"],
                                   y["scalars"]["loss"])})
        return out

    def held(a, b):
        e = golden.compare_train_steps(
            a, b, golden.train_tolerance(golden.train_name(name), dtype),
            cfg.optimizer == "adamw", dtype, None,
            golden.train_tolerance(name, dtype))
        return {"steps": [{k: [s[k]["worst"], s[k]["worst_leaf"]]
                           for k in ("grad", "update")} |
                          {"scalars": max(s["scalars"].values())}
                          for s in e["steps"]],
                "state": [e["state"]["worst"], e["state"]["worst_leaf"]]}
    out = {"cell": name, "dtype": dtype, "layers": layers,
           "port_vs_reference": distances(port, ref),
           "nudged_vs_reference": distances(moved, ref),
           "held": {"port": held(port, ref), "nudged": held(moved, ref)}}
    if "rwkv" in cfg.layer_kinds() and not golden.cell(name).seq_exact:
        exact = reference_train_steps(name, dtype, steps, layers,
                                      seq_exact=True)
        out.update(exact_vs_reference=distances(exact, ref),
                   port_vs_exact=distances(port, exact))
    return {**out, "seconds": time.perf_counter() - t0}


def reference_engine(jcfg, params, prompts, dirs) -> dict:
    """The reference's ``ServingEngine`` (``golden.ENGINE``) answering
    ``prompts``: ``golden.EngineRecord.record``.  Its cache is put in the
    weights' dtype: the engine makes it bf16, and its decode refuses f32
    weights beside a bf16 cache."""
    import jax.numpy as jnp

    from repro.models import init_cache
    from repro.serving.engine import Request, ServingEngine
    from repro_torch.launch import golden
    n, max_len = golden.ENGINE["n_slots"], golden.ENGINE["max_len"]
    eng = ServingEngine(jcfg, params, n_slots=n, max_len=max_len)
    eng.cache = init_cache(jcfg, n, max_len, dtype=jnp.dtype(jcfg.param_dtype))
    rec = golden.EngineRecord(eng, dirs)
    golden.submit(eng, Request, prompts)
    eng.run_until_done()
    return rec.record()


def int8_cache(path):
    """The reference's int8 KV cache after the f32 prefill of
    ``gemma3-1b+int8@4x1024`` on its record's weights and inputs, written
    to ``path`` ("<blocks|tail>/<i>/<leaf>": the int8 values and their f32
    scales) for ``python -m repro_torch.launch.golden --int8-flips``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.kernels import disable_flash_attention
    from repro_torch.launch import golden

    disable_flash_attention()
    name = golden.INT8_CELL
    tcfg = golden.cell_config(name, "float32")
    jcfg = golden.cell_config(name, "float32", jax_config)
    params = carry(golden.model(tcfg), tcfg, jcfg)
    inp = golden.inputs(name, tcfg)
    batch = {k: jnp.asarray(v) for k, v in inp.items()
             if k not in ("decode", "prompts")}
    _, cache = jax.jit(functools.partial(_prefill_all, cfg=jcfg))(params,
                                                                  batch)
    arrays = {f"{group}/{i}/{leaf}": np.asarray(v)
              for group in ("blocks", "tail")
              for i, leaves in enumerate(cache[group])
              for leaf, v in leaves.items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    print(f"wrote {path} ({Path(path).stat().st_size} bytes)")


def sensitivity(name: str, dtype: str, layers: int, rows: int) -> dict:
    """How far rounding alone moves a cell's logits at ``layers`` layers:
    the prefill's summaries (every position of the first ``rows`` rows) of
    the port on the CPU (the kernels' plain versions), of the reference,
    and of the reference with every value of its embedding table moved by
    one f32 ulp (a relative 2**-23, the size of the rounding any two f32
    programs differ by); each pair's projections' distance in relative
    norm and the argmax positions that differ.  Where the reference moves
    under the nudge about as far as the port lies from it, the port's
    distance is the stack's own amplification of rounding, not a fault."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_config as jax_config
    from repro.kernels import disable_flash_attention
    from repro_torch.launch import golden
    from repro_torch.models import forward_prefill

    disable_flash_attention()
    tcfg = dataclasses.replace(golden.cell_config(name, dtype),
                               n_layers=layers)
    jcfg = dataclasses.replace(golden.cell_config(name, dtype, jax_config),
                               n_layers=layers)
    inp = {k: v[:rows] for k, v in golden.inputs(name, tcfg).items()
           if k not in ("decode", "prompts")}
    dirs = torch.tensor(golden.directions(tcfg.vocab_size))
    t0 = time.perf_counter()  # repro: allow(DB001): progress report
    model = golden.model(tcfg)
    with torch.no_grad():
        logits, _ = forward_prefill(model, tcfg, golden.batch_of(inp, "cpu"),
                                    all_positions=True)
        port = golden.summarize(logits.flatten(0, 1), dirs)
    del logits
    params = carry(model, tcfg, jcfg)
    del model
    prefill = jax.jit(functools.partial(_prefill_all, cfg=jcfg))
    batch = {k: jnp.asarray(v) for k, v in inp.items()}

    def reference(p):
        x = np.asarray(prefill(p, batch)[0]).astype(np.float32)
        return golden.summarize(torch.from_numpy(
            x.reshape(-1, x.shape[-1])), dirs)

    def distances(a, b):
        return {"sketch_rel": golden._part_errors(
                    a, b, dict.fromkeys(golden.MEASURES, 1.0))["sketch_rel"],
                "argmax_differs": int(np.sum(a["argmax"] != b["argmax"]))}
    ref = reference(params)
    moved = reference(dict(params, embed=params["embed"] * (1 + 2.0 ** -23)))
    return {"cell": name, "dtype": dtype, "layers": layers, "rows": rows,
            "port_vs_reference": distances(port, ref),
            "nudged_vs_reference": distances(moved, ref),
            "positions": int(len(ref["argmax"])),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import golden

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(golden.CELLS),
                    help="cells of one file, comma-separated; 'timed' for "
                         "all of golden.TIMED")
    ap.add_argument("--out", default=None,
                    help="default: the cells' own file")
    ap.add_argument("--sensitivity", metavar="CELL", default=None,
                    help="print how far rounding moves CELL's logits at "
                         "each depth of --layers instead")
    ap.add_argument("--dtype", default=None,
                    help="--sensitivity's dtype (default float32); else "
                         "write only this dtype's records, keeping the "
                         "file's others (a dtype a process)")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--layers", default="1,2,4,8,16,32")
    ap.add_argument("--int8-cache", metavar="PATH", default=None,
                    help="write the reference's int8 cache after the "
                         "int8 cell's f32 prefill to PATH instead")
    args = ap.parse_args(argv)
    cells = list(golden.GROUPS[args.cells]) if args.cells in golden.GROUPS \
        else args.cells.split(",")
    flags = {getattr(golden.cell(n), "xla_flags", "")
             for n in ([args.sensitivity] if args.sensitivity else cells)}
    if len(flags) > 1:
        raise SystemExit(f"{cells}: cells of other XLA flags, write them "
                         f"in processes of their own")
    if flags - {""}:             # read when jax makes its backend
        os.environ["XLA_FLAGS"] = " ".join(
            filter(None, (os.environ.get("XLA_FLAGS"), *flags)))
    import jax
    if args.sensitivity:
        for layers in map(int, args.layers.split(",")):
            print(json.dumps(
                train_sensitivity(args.sensitivity, args.dtype or "float32",
                                  layers)
                if golden.table_of(args.sensitivity) in (
                    golden.TRAIN, golden.TRAIN_STEPS) else
                sensitivity(args.sensitivity, args.dtype or "float32",
                            layers, args.rows)), flush=True)
        return
    if args.int8_cache:
        int8_cache(args.int8_cache)
        return
    table = golden.table_of(cells[0])
    if any(n not in table for n in cells):
        raise SystemExit(f"{cells}: cells of one file only")
    train = table is golden.TRAIN
    multi = table is golden.TRAIN_STEPS
    out = Path(args.out or golden.file_of(cells[0]))
    records = {}
    for name in cells:
        for dt in [d for d in table[name].dtypes
                   if args.dtype in (None, d)]:
            t0 = time.perf_counter()  # repro: allow(DB001): progress report
            records[(name, dt)] = (reference_train if train else
                                   reference_train_steps if multi else
                                   reference_run)(name, dt)
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
            print(f"{name} {dt}: done in {time.perf_counter() - t0:.0f} s, "
                  f"the process's peak {peak:.1f} GB", flush=True)
            if multi:
                print(f"{name} {dt}: step 1 against train.npz: " + json.dumps(
                    check_first_step(name, dt, records[(name, dt)])),
                    flush=True)
    meta = {"jax": jax.__version__, "numpy": np.__version__,
            "seed": golden.SEED, "written_by": "tests/reference_golden.py"}
    if train or multi:
        meta.update(train_input_seed=golden.TRAIN_INPUT_SEED,
                    index_seed=golden.INDEX_SEED, k=golden.K, lr=golden.LR)
        arrays = (golden.pack_train_steps if multi else
                  golden.pack_train)(records, meta)
    else:
        vocabs = sorted({golden.cell_config(n, "float32").vocab_size
                         for n in table})
        meta.update(directions_seed=golden.DIRECTIONS_SEED,
                    input_seed=golden.INPUT_SEED,
                    directions={str(v): golden.array_sums(
                        golden.directions(v)).tolist() for v in vocabs})
        if table is golden.TIMED:
            meta.update(engine_seed=golden.ENGINE_SEED, engine=golden.ENGINE)
        arrays = golden.pack(records, meta)
    if out.exists() and (set(cells) != set(table) or args.dtype):
        old = golden.load(out)
        arrays = {**{k: v for k, v in old.items()
                     if (k.split("/")[0] not in cells or args.dtype and
                         k.split("/")[1:2] != [args.dtype]) and k != "meta"},
                  **arrays}
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
