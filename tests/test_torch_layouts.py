"""The port's layout specs (repro_torch.distributed.layouts) against the
reference's, for every registered arch, each of its shapes and both
production meshes (16 x 16 and 2 x 16 x 16).

The reference runs on ``jax.eval_shape`` params and caches and a stand-in
mesh that carries only ``shape`` and ``axis_names`` (what ``choose_layout``
and ``opt_pspecs`` read); the port on meta-device params and caches and
``launch.mesh.make_production_mesh``'s abstract mesh.  Params and optimizer
specs are compared leaf for leaf by the reference leaf's path (the port's
come keyed by leaf key, over its stacked view); cache and batch specs by
their path in the same nesting.  Specs must be equal, element for element.
"""
import functools

import jax
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec  # noqa: E402
from repro.configs.base import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.distributed import layouts as jl  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.io import batch_specs as jax_batch_specs  # noqa: E402
from repro_torch.configs.base import (LM_SHAPES, get_config,  # noqa: E402
                                      list_archs, shapes_for)
from repro_torch.distributed import layouts as tl  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models.io import batch_specs  # noqa: E402

CASES = [(arch, s.name, multi_pod) for arch in list_archs()
         for s in shapes_for(arch) for multi_pod in (False, True)]


class StandIn:
    """The reference's mesh as its layouts read it: names and sizes."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(mesh.mesh_dim_names, mesh.shape))


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_key(path): tuple(spec) for path, spec in leaves}


def _torch_specs(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_specs(v, path + (str(k),)))
        return out
    if not tree or any(isinstance(v, dict) for v in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_torch_specs(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


@functools.cache
def _jax_params(arch):
    return jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  jax_config(arch)))


@functools.cache
def _torch_params(arch):
    return init_params(get_config(arch), None, device="meta")


@pytest.mark.parametrize("arch,shape,multi_pod", CASES)
def test_specs_equal_reference(arch, shape, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = StandIn(mesh)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jshape, tshape = JAX_SHAPES[shape], LM_SHAPES[shape]
    jr = jl.choose_layout(jcfg, jshape, jmesh)
    tr = tl.choose_layout(tcfg, tshape, mesh)
    assert tr.rules == jr.rules

    jparams = _jax_params(arch)
    jp = jl.param_pspecs(jparams, jcfg, jr)
    tp = tl.param_pspecs(_torch_params(arch), tcfg, tr)
    assert tp == _jax_specs(jp)
    assert tl.opt_pspecs(tp, _torch_params(arch), tcfg, mesh) == \
        _jax_specs(jl.opt_pspecs(jp, jparams, jmesh))

    B, S = tshape.global_batch, tshape.seq_len
    assert _torch_specs(tl.batch_pspecs(batch_specs(tcfg, tshape), tr)) == \
        _jax_specs(jl.batch_pspecs(jax_batch_specs(jcfg, jshape), jr))
    jcache = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S))
    tcache = init_cache(tcfg, B, S, device="meta")
    assert _torch_specs(tl.cache_pspecs(tcache, tcfg, tr)) == \
        _jax_specs(jl.cache_pspecs(jcache, jcfg, jr))


def test_opt_specs_put_data_on_the_layer_axis():
    """internlm2-20b's stacked norm (48, 6144) gets ``data`` on the layer
    axis, its first free dim that 16 divides, as in the reference; the
    per-layer tensor (6144,) would get it on d_model.  An unstacked leaf
    gets it on its own first dim."""
    mesh = make_production_mesh()
    cfg = get_config("internlm2-20b")
    rules = tl.choose_layout(cfg, LM_SHAPES["train_4k"], mesh)
    model = _torch_params("internlm2-20b")
    specs = tl.opt_pspecs(tl.param_pspecs(model, cfg, rules), model, cfg,
                          mesh)
    assert specs["blocks/0/ln1"] == ("data", None)
    assert specs["final_norm"] == ("data",)


def test_to_shardings_gives_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    cfg = get_config("qwen3-moe-235b-a22b")
    rules = tl.choose_layout(cfg, LM_SHAPES["train_4k"], mesh)
    pl = tl.to_shardings(tl.param_pspecs(_torch_params(
        "qwen3-moe-235b-a22b"), cfg, rules), mesh)
    # (R, E, d, f): experts over model, the expert ff over data
    assert pl["blocks/0/moe/w_gate"] == (Replicate(), Shard(3), Shard(1))
    assert pl["final_norm"] == (Replicate(),) * 3
    bp = tl.to_shardings(tl.batch_pspecs(batch_specs(cfg, LM_SHAPES[
        "train_4k"]), rules), mesh)
    # batch over ("pod", "data"): dim 0 split over both, pod major
    assert bp["tokens"] == (Shard(0), Shard(0), Replicate())
