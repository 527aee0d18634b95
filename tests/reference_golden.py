"""The JAX reference's outputs at full width, on the port's weights (not a
test module: it writes the file the port is held to).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py \
        [--cells gemma3-1b,whisper-small] [--out tests/golden/full_width.npz]

For each cell and dtype of ``repro_torch.launch.golden.CELLS`` it draws the
port's weights (``golden.model``: a ``BlockDraws`` of ``golden.SEED``, the
zero-initialised leaves given draws), carries them to the reference's
params tree (``models.weights.params_to_numpy``, each leaf cast to the
reference's dtype), runs the reference's prefill with the logits of every
position and 8 decode steps fed the cell's tokens, both jitted, with the
flash hook off (the jnp path), and keeps what ``golden.summarize`` keeps
of the logits, beside the weights' checksums and the inputs.  With
``--cells`` it rewrites those cells' records and keeps the file's others.
All cells take ~4 min and ~20 GB on 8 cores (internlm2-20b's 1.5 B f32
weights are held three times: the port's, the numpy tree, the
reference's).

``reference_run`` is also what tests/test_torch_full_width.py calls to
hold the file to the reference.
"""
import argparse
import functools
import json
import sys
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


def reference_run(name: str, dtype: str) -> dict:
    """One cell in ``dtype`` through the reference: {"names", "sums",
    "inputs", "prefill", "decode"} as ``golden.pack`` takes it."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_config as jax_config
    from repro.kernels import disable_flash_attention
    from repro.models import transformer as jtf
    from repro_torch.launch import golden
    from repro_torch.models.weights import params_to_numpy

    disable_flash_attention()
    tcfg = golden.cell_config(name, dtype)
    jcfg = golden.cell_config(name, dtype, jax_config)
    model = golden.model(tcfg, golden.SEED, "cpu")
    names, sums = golden.checksums(model)
    tree = params_to_numpy(model, tcfg)
    del model
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    if jax.tree.structure(tree) != jax.tree.structure(shapes):
        raise ValueError(f"{name}: the port's tree is not the reference's")
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    del tree

    inp = golden.inputs(name, tcfg)
    batch = {k: jnp.asarray(v) for k, v in inp.items() if k != "decode"}
    dirs = torch.tensor(golden.directions(tcfg.vocab_size))

    def summary(logits):
        return golden.summarize(torch.from_numpy(
            np.array(logits[0], np.float32)), dirs)
    logits, cache = jax.jit(functools.partial(_prefill_all, cfg=jcfg))(
        params, batch)
    prefill = summary(logits)
    del logits
    decode = jax.jit(lambda p, c, t, pos: jtf.forward_decode(p, jcfg, c, t,
                                                             pos))
    start, steps = golden.decode_start(tcfg, inp), []
    for i, t in enumerate(inp["decode"]):
        logits, cache = decode(params, cache, jnp.asarray([[t]], jnp.int32),
                               jnp.int32(start + i))
        steps.append(summary(logits))
    return {"names": names, "sums": sums, "inputs": inp, "prefill": prefill,
            "decode": golden.concat(steps)}


def main(argv=None):
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    from repro_torch.launch import golden

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(golden.CELLS))
    ap.add_argument("--out", default=str(golden.GOLDEN))
    args = ap.parse_args(argv)
    out = Path(args.out)
    cells = args.cells.split(",")
    records = {}
    for name in cells:
        for dt in golden.CELLS[name].dtypes:
            records[(name, dt)] = reference_run(name, dt)
            print(f"{name} {dt}: done", flush=True)
    vocabs = sorted({golden.cell_config(n, "float32").vocab_size
                     for n in golden.CELLS})
    dirs = {str(v): golden.array_sums(golden.directions(v)).tolist()
            for v in vocabs}
    meta = {"jax": jax.__version__, "numpy": np.__version__,
            "seed": golden.SEED, "directions_seed": golden.DIRECTIONS_SEED,
            "input_seed": golden.INPUT_SEED, "directions": dirs,
            "written_by": "tests/reference_golden.py"}
    arrays = golden.pack(records, meta)
    if out.exists() and set(cells) != set(golden.CELLS):
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
