"""The dtype of the reference's expert-gradient reduce-scatters, as its
program emits them and as XLA's CPU compiler runs them (not a test module:
the reference's dry-run forces 512 host devices before JAX starts).

    python tests/reference_reduce_dtype.py

Compiles the reference's arctic-480b ``train_4k`` step on the ``pod`` mesh
at one layer, narrowed (d_model 448, head_dim 16, ff 304, vocab 4096,
256 x 256 tokens; its 128 experts, heads, Adafactor and bf16 params kept),
with XLA's pass dumps in a temp dir, and prints each reduce-scatter's
result dtype and shape after the SPMD partitioner and after the CPU
pipeline's ``all-reduce-promotion`` pass, and how many reductions that
pass cloned as ``*_promoted``.  The bf16 experts' gradients leave the
partitioner in bf16; the pass makes them f32.
"""
import dataclasses
import os
import re
import shutil
import sys
import tempfile
from collections import Counter
from pathlib import Path

# a reduction computation that all-reduce-promotion cloned in f32
PROMOTED = re.compile(r"%[\w.]+_promoted \(")


def main():
    dump = tempfile.mkdtemp()
    try:
        report(dump)
    finally:
        shutil.rmtree(dump, ignore_errors=True)


def report(dump):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_dump_to={dump} --xla_dump_hlo_pass_re="
                               "spmd-partitioning|all-reduce-promotion")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro.launch import dryrun as ref    # first: forces 512 devices
    import jax
    from repro.configs import base as configs
    from repro.distributed import context as dctx
    from repro.distributed.layouts import choose_layout
    from repro.launch.mesh import make_production_mesh
    base = configs.get_config("arctic-480b")
    cfg = dataclasses.replace(
        base, n_layers=1, d_model=448, head_dim=16, d_ff=304,
        vocab_size=4096, moe=dataclasses.replace(base.moe, d_ff_expert=304,
                                                 d_ff_dense=304))
    shape = dataclasses.replace(configs.LM_SHAPES["train_4k"], seq_len=256,
                                global_batch=256)
    mesh = make_production_mesh(multi_pod=False)
    rules = choose_layout(cfg, shape, mesh)
    with dctx.use_rules(rules):
        fn, abstract, in_sh, out_sh, donate = ref.build_cell(
            cfg, shape, mesh, rules, grad_accum=1)
        jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                donate_argnums=donate).lower(*abstract).compile()
    rs = re.compile(r"= (\w+)\[([\d,]*)\]\S* reduce-scatter\(")
    for stage in ("after_spmd-partitioning", "after_all-reduce-promotion"):
        [path] = [p for p in Path(dump).iterdir()
                  if "jit_train_step" in p.name and stage in p.name]
        text = path.read_text()
        kinds = Counter(f"{t}[{s}]" for t, s in rs.findall(text))
        print(f"{stage}: reduce-scatters {dict(kinds)}, reductions "
              f"promoted {len(PROMOTED.findall(text))}")


if __name__ == "__main__":
    main()
