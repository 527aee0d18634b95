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
import sys
import time
from pathlib import Path

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
    import jax

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
    if args.sensitivity:
        for layers in map(int, args.layers.split(",")):
            print(json.dumps(sensitivity(args.sensitivity, args.dtype,
                                         layers, args.rows)), flush=True)
        return
    if args.int8_cache:
        int8_cache(args.int8_cache)
        return
    cells = list(golden.TIMED) if args.cells == "timed" \
        else args.cells.split(",")
    table = golden.CELLS if cells[0] in golden.CELLS else golden.TIMED
    if any(n not in table for n in cells):
        raise SystemExit(f"{cells}: cells of one file only")
    out = Path(args.out or golden.file_of(cells[0]))
    records = {}
    for name in cells:
        for dt in table[name].dtypes:
            t0 = time.perf_counter()  # repro: allow(DB001): progress report
            records[(name, dt)] = reference_run(name, dt)
            print(f"{name} {dt}: done in {time.perf_counter() - t0:.0f} s",
                  flush=True)
    vocabs = sorted({golden.cell_config(n, "float32").vocab_size
                     for n in table})
    dirs = {str(v): golden.array_sums(golden.directions(v)).tolist()
            for v in vocabs}
    meta = {"jax": jax.__version__, "numpy": np.__version__,
            "seed": golden.SEED, "directions_seed": golden.DIRECTIONS_SEED,
            "input_seed": golden.INPUT_SEED, "directions": dirs,
            "written_by": "tests/reference_golden.py"}
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
    print(json.dumps(meta["directions"]))


if __name__ == "__main__":
    main()
