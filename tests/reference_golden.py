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

``--sensitivity`` measures how far rounding alone moves a cell's logits
at each depth (``sensitivity``; rwkv6-7b at 2-4 layers and 4 rows ~80 s a
depth), and ``--int8-cache`` writes the reference's int8 KV cache after
the int8 cell's f32 prefill (``int8_cache``; ~1 min), which ``python -m
repro_torch.launch.golden --int8-flips PATH`` compares with the port's.

``reference_run`` is also what tests/test_torch_full_width.py and
tests/test_torch_timed_golden.py call to hold the files to the reference.
"""
import argparse
import dataclasses
import functools
import json
import math
import os
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


def _sample(leaf, r, idx) -> tuple:
    """(f64 sum of squares, f64 samples at ``idx``) of layer ``r`` of a
    reference leaf (``r`` None: the leaf), through a view of its buffer."""
    import torch

    from repro_torch.launch import golden
    a = np.asarray(leaf)
    a = np.ascontiguousarray(a if r is None else a[r])
    with warnings.catch_warnings():   # a read-only buffer, only read here
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            if a.dtype.name == "bfloat16" else torch.from_numpy(a)
    return golden.squares(t), t.reshape(-1)[torch.from_numpy(idx)].double(
        ).numpy()


def reference_train(name: str, dtype: str, layers=None, nudge=False,
                    seq_exact=False) -> dict:
    """One train cell of ``golden.TRAIN`` in ``dtype`` through the
    reference: its loss and grads on batch 0 (one jitted
    ``value_and_grad`` of ``repro.train.steps.loss_fn``), clipped as its
    optimizers clip them (``clip_by_global_norm``, the grads donated), its
    optimizer's first update (``make_optimizer(cfg.optimizer)``: its own
    ``init`` and ``update`` in one jit, the params donated, its clip then
    by inf: a scale of 1), and its loss on batch 1 after the update; each
    parameter's grad norm and samples (the clipped grads, which the port's
    ``.grad`` holds after its step) and update samples (new - old, AdamW's
    f32 master) at
    ``golden.train_indices`` under the port's parameter names.  Returns
    {"names", "sums", "numels", "batches", "scalars", "grad_norms", "grad",
    "update"} as ``golden.pack_train`` takes it.  ``layers``, ``nudge``,
    ``seq_exact``: ``--sensitivity``'s (that many layers; the embedding
    moved one ulp of its dtype; RWKV layers through the reference's exact
    sequential wkv, ``forward_train(seq_exact=True)``)."""
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
    cut = {"n_layers": layers} if layers else {}
    tcfg = dataclasses.replace(golden.cell_config(name, dtype), **cut)
    jcfg = dataclasses.replace(golden.cell_config(name, dtype, jax_config),
                               **cut)
    m = golden.model(dataclasses.replace(tcfg, param_dtype="float32"))
    if dtype != "float32":
        m = golden.cast(m, tcfg)
    names, sums = golden.checksums(m)
    numels = [p.numel() for p in m.parameters()]
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

    batches = [golden.train_batch(name, tcfg, s) for s in (0, 1)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    forward = functools.partial(jtf.forward_train, seq_exact=seq_exact)
    with mock.patch.object(jsteps, "forward_train", forward):
        loss = jax.jit(lambda p, b: jsteps.loss_fn(p, jcfg, b))
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.loss_fn(p, jcfg, b), has_aux=True))(params,
                                                                   jb[0])
    # the grads the update takes: its own clip, split out of it (the update
    # then clips by inf, a scale of exactly 1)
    grads, gn = jax.jit(lambda g: clip_by_global_norm(g, golden.MAX_GRAD_NORM),
                        donate_argnums=0)(grads)
    grad_sq, grad_s, before = [], [], []
    for i in range(len(names)):
        sq, s = _sample(*at(grads, i), idx[i])
        grad_sq.append(sq)
        grad_s.append(s)
        before.append(_sample(*at(params, i), idx[i])[1])
    opt = make_optimizer(jcfg.optimizer, max_grad_norm=math.inf)
    master = jcfg.optimizer == "adamw" and dtype != "float32"

    def update(p, g):
        new, st, _ = opt.update(g, opt.init(p), p, golden.LR)
        return new, st["master"] if master else None
    new, base = jax.jit(update, donate_argnums=0)(params, grads)
    del params, grads
    base = new if base is None else base
    upd = [_sample(*at(base, i), idx[i])[1] - before[i]
           for i in range(len(names))]
    del base
    with mock.patch.object(jsteps, "forward_train", forward):
        after = loss(new, jb[1])[1]
    return {"names": names, "sums": sums, "numels": numels,
            "batches": batches,
            "scalars": {"loss": float(metrics["loss"]),
                        "aux": float(metrics["aux"]), "grad_norm": float(gn),
                        "loss_after": float(after["loss"])},
            "grad_norms": np.sqrt(grad_sq), "grad": grad_s, "update": upd}


def train_sensitivity(name: str, dtype: str, layers: int) -> dict:
    """How far rounding alone moves a train cell's grads at ``layers``
    layers: each parameter's grad (``golden.leaf_errors``) of the port on
    the CPU (the kernels' plain versions), of the reference, and of the
    reference with its embedding moved one ulp, each pair's largest and
    median error over the parameters (as ``sensitivity`` does for the
    logits); for a config with RWKV layers also the reference's exact
    sequential wkv (``seq_exact``) against its chunked one and the port."""
    from repro_torch.launch import golden
    t0 = time.perf_counter()  # repro: allow(DB001): progress report
    ref = reference_train(name, dtype, layers)
    moved = reference_train(name, dtype, layers, nudge=True)
    cfg = dataclasses.replace(golden.cell_config(name, dtype),
                              n_layers=layers)
    m = golden.model(dataclasses.replace(cfg, param_dtype="float32"))
    if dtype != "float32":
        m = golden.cast(m, cfg)
    port = golden.train_step_record(m, cfg, ref["batches"], "cpu")

    def distances(a, b):
        d = golden.leaf_errors(a, b)
        return {"grad_worst": max(d), "grad_median": float(np.median(d)),
                "loss": golden.rel(a["scalars"]["loss"], b["scalars"]["loss"])}
    out = {"cell": name, "dtype": dtype, "layers": layers,
           "port_vs_reference": distances(port, ref),
           "nudged_vs_reference": distances(moved, ref)}
    if "rwkv" in cfg.layer_kinds():
        exact = reference_train(name, dtype, layers, seq_exact=True)
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
    ap.add_argument("--dtype", default="float32")
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
                train_sensitivity(args.sensitivity, args.dtype, layers)
                if args.sensitivity in golden.TRAIN else
                sensitivity(args.sensitivity, args.dtype, layers,
                            args.rows)), flush=True)
        return
    if args.int8_cache:
        int8_cache(args.int8_cache)
        return
    table = golden.table_of(cells[0])
    if any(n not in table for n in cells):
        raise SystemExit(f"{cells}: cells of one file only")
    train = table is golden.TRAIN
    out = Path(args.out or golden.file_of(cells[0]))
    records = {}
    for name in cells:
        for dt in table[name].dtypes:
            t0 = time.perf_counter()  # repro: allow(DB001): progress report
            records[(name, dt)] = (reference_train if train else
                                   reference_run)(name, dt)
            print(f"{name} {dt}: done in {time.perf_counter() - t0:.0f} s",
                  flush=True)
    meta = {"jax": jax.__version__, "numpy": np.__version__,
            "seed": golden.SEED, "written_by": "tests/reference_golden.py"}
    if train:
        meta.update(train_input_seed=golden.TRAIN_INPUT_SEED,
                    index_seed=golden.INDEX_SEED, k=golden.K, lr=golden.LR)
        arrays = golden.pack_train(records, meta)
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
    if out.exists() and set(cells) != set(table):
        old = golden.load(out)
        arrays = {**{k: v for k, v in old.items()
                     if k.split("/")[0] not in cells and k != "meta"},
                  **arrays}
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
