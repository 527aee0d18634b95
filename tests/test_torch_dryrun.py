"""The port's dry-run (repro_torch.launch.dryrun) against the reference's.

* ``models.io.input_specs``: the reference's shapes and dtypes, leaf for
  leaf, for every arch and each of its shapes.
* State bytes at full size, for all ten archs: the port's meta-device
  params, train state (AdamW and Adafactor), decode cache at
  ``decode_32k`` and batch weigh what the reference's ``jax.eval_shape``
  leaves weigh, exactly.  Nothing is compiled.
* ``memory`` of a traced cell on a 1 x 1 mesh against the reference's
  ``compiled.memory_analysis()`` on its one CPU device, smoke configs (one
  superblock) of a dense, a recurrent, a MoE and an encoder-decoder arch,
  train / prefill / decode.  Arguments and aliases are equal; the reference is compiled with
  ``keep_unused=True`` (by default jit prunes arguments a step never reads:
  a prefill's labels, whisper's encoder weights in decode).  Outputs differ
  by what is explained: XLA's CPU output tuple holds an 8-byte pointer for
  each leaf, and the port's train-step token count is int64 (a bool sum in
  PyTorch) where the reference's is int32.
* ``run_cell`` writes no file: records are written by ``main`` only, and
  never under ``experiments/dryrun/``.  A production-mesh cell is traced
  as rank 0 of a fake world (``tests/test_torch_dryrun_mesh.py``): its
  record carries rank 0's collectives and counts (``"rank0"``).
"""
import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.io import batch_specs as jax_batch_specs  # noqa: E402
from repro.models.io import input_specs as jax_input_specs  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import init_train_state as jax_train_state  # noqa: E402
from repro_torch.configs.base import (LM_SHAPES, ShapeConfig,  # noqa: E402
                                      get_config, get_smoke_config,
                                      list_archs, shapes_for)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models.io import batch_specs, input_specs  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.roofline.trace import COLLECTIVES  # noqa: E402
from repro_torch.train.steps import init_train_state  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                         np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_torch_leaves(v, f"{path}[{i}]"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_the_reference(arch):
    for s in shapes_for(arch):
        got = _torch_leaves(input_specs(get_config(arch), LM_SHAPES[s.name]))
        want = _jax_leaves(jax_input_specs(jax_config(arch),
                                           JAX_SHAPES[s.name]))
        assert got == want, s.name


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _torch_bytes(tree) -> int:
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_torch_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_torch_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("arch", list_archs())
def test_state_bytes_at_full_size_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    key = jax.random.PRNGKey(0)
    assert _torch_bytes(init_params(cfg, None, device="meta")) == \
        _jax_bytes(jax.eval_shape(lambda: jax_init_params(key, jcfg)))
    for name in ("adamw", "adafactor"):
        state = init_train_state(None, cfg, make_optimizer(name, cfg=cfg),
                                 device="meta")
        want = jax.eval_shape(lambda: jax_train_state(
            key, jcfg, jax_make_optimizer(name)))
        assert _torch_bytes(state) == _jax_bytes(want), name
    s = LM_SHAPES["decode_32k"]
    assert _torch_bytes(init_cache(cfg, s.global_batch, s.seq_len,
                                   device="meta")) == \
        _jax_bytes(jax.eval_shape(lambda: jax_init_cache(
            jcfg, s.global_batch, s.seq_len)))
    for shape in ("train_4k", "prefill_32k"):
        assert _torch_bytes(batch_specs(cfg, LM_SHAPES[shape])) == \
            _jax_bytes(jax_batch_specs(jcfg, JAX_SHAPES[shape]))


@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` to force 512 host devices
    when it is imported: this process keeps its one device (its backend is
    up first) and the flag is taken back, so that no later subprocess
    inherits it."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b",
                                  "qwen3-moe-235b-a22b", "whisper-small"])
def test_memory_matches_the_reference_memory_analysis(reference_dryrun, arch,
                                                      kind):
    from repro.distributed import context as jctx
    from repro.distributed.layouts import choose_layout
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    one_superblock = {"n_layers": jax_smoke(arch).pattern_len}
    jcfg = dataclasses.replace(jax_smoke(arch), **one_superblock)
    shape = JaxShape("s", kind, 32, 4)
    rules = choose_layout(jcfg, shape, mesh)
    with jctx.use_rules(rules):
        fn, abstract, in_sh, out_sh, donate = reference_dryrun.build_cell(
            jcfg, shape, mesh, rules, grad_accum=1)
        n_out = len(jax.tree.leaves(jax.eval_shape(fn, *abstract)))
        ma = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                     donate_argnums=donate, keep_unused=True).lower(
            *abstract).compile().memory_analysis()
    rec = dryrun.trace_cell(dataclasses.replace(get_smoke_config(arch),
                                                **one_superblock),
                            ShapeConfig("s", kind, 32, 4),
                            AbstractMesh(("data", "model"), (1, 1)),
                            grad_accum=1)
    mem = {k: round(v * 1e9) for k, v in rec["memory"].items()
           if k.endswith("_gb")}
    assert mem["argument_gb"] == ma.argument_size_in_bytes
    assert mem["alias_gb"] == ma.alias_size_in_bytes
    token_count = 4 if kind == "train" else 0
    assert mem["output_gb"] - token_count == \
        ma.output_size_in_bytes - 8 * n_out
    m = rec["memory"]
    assert m["peak_gb"] == pytest.approx(
        m["argument_gb"] + m["output_gb"] + m["temp_gb"] - m["alias_gb"])


def test_one_device_counts_its_collectives():
    rec = dryrun.trace_cell(get_smoke_config("gemma3-1b"),
                            ShapeConfig("s", "prefill", 32, 2),
                            AbstractMesh(("data", "model"), (1, 1)))
    assert rec["n_chips"] == 1
    assert all(v == {"count": 0, "operand_bytes": 0, "output_bytes": 0}
               for v in rec["collectives"].values())
    assert rec["hlo_len"] >= sum(rec["hlo_ops"].values())
    assert rec["cost"]["flops_per_device"] > 0


def test_run_cell_writes_no_file():
    before = {p: sorted(p.rglob("*")) for p in (EXPERIMENTS / "dryrun",
                                                dryrun.OUT_DIR)}
    smoke = dataclasses.replace(get_smoke_config("h2o-danube-1.8b"),
                                n_layers=1)
    rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", True,
                          cfg_override=smoke)
    assert {p: sorted(p.rglob("*")) for p in before} == before
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("multipod", 512,
                                                          "decode")
    assert set(rec["collectives"]) == set(COLLECTIVES) and \
        "collectives_note" not in rec and rec["n_ranks_traced"] == 1
    assert rec["memory"]["temp_split"] == "rank0"
    assert rec["cost"]["split"] == "rank0"
    assert "compile_s" not in rec and rec["lower_s"] > 0
