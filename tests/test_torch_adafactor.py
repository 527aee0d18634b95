"""The port's Adafactor (repro_torch.optim.adafactor) against the reference's
on the reference's stacked params tree, on the CPU.

The reference factors each leaf of its tree, whose superblock leaves stack
the R layers as ``(R, ...)``; the port groups its per-layer tensors into
the same leaves through ``models.weights.stacked_view``.  Both take the same
weights (the reference's ``init_params``, norms given random values) and
the same grads (numpy draws in the reference's tree, cut into the port's
layers), two updates each.

Tolerance: f32, every new weight and every state leaf to 1e-5 relative,
elementwise against the element or, near zero, the leaf's largest element
(the optimizer tests' rule in tests/test_torch_train.py): the arithmetic is
the reference's, in another summation order.  ``clip_thresh=0.1`` makes the
RMS clip bind on every leaf: an update normalised by its own second moment
has an RMS near 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adafactor as jax_adafactor  # noqa: E402
from repro_torch.configs.base import get_smoke_config, list_archs  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.weights import (leaf_of, params_from_jax,  # noqa: E402
                                        params_to_numpy, reference_tree)
from repro_torch.optim import adafactor, optimizers  # noqa: E402

MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
NORMS = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
         "k_norm", "ln_x", "enc_norm"}
LR = 0.01


def _jax_params(cfg, seed=0):
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in NORMS:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.3, leaf.dtype)
        return leaf
    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(perturb, params))


def _grads(params, seed):
    """Random grads in the reference's tree, each leaf with its own scale
    (so the global clip and the per-leaf RMS both matter)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * rng.uniform(0.01, 1.0)
                   ).astype(np.float32), params)


def _port_grads(grads, tc, model):
    """The reference's grads tree cut into the port's per-layer names."""
    out = {}
    for name, _ in model.named_parameters():
        key, r = leaf_of(name, tc)
        leaf = grads
        for p in key.split("/"):
            leaf = leaf[int(p)] if isinstance(leaf, tuple) else leaf[p]
        out[name] = torch.tensor(np.asarray(leaf if r is None else leaf[r]))
    return out


def _state_numpy(st, tc):
    return reference_tree({k: {n: t.numpy() for n, t in s.items()}
                           for k, s in st["vs"].items()}, tc)


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, what
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-5 * max(np.abs(j).max(), 1e-30),
                               err_msg=what)


def _compare_trees(t_tree, j_tree):
    jl = jax.tree_util.tree_leaves_with_path(j_tree)
    tl = jax.tree.leaves(t_tree)
    assert jax.tree.structure(t_tree) == jax.tree.structure(
        jax.tree.map(np.asarray, j_tree))
    for (path, j), t in zip(jl, tl):
        _close(t, j, jax.tree_util.keystr(path))


def _run_both(arch, clip_thresh, steps=2):
    jc = dataclasses.replace(jax_smoke(arch), param_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    jp = _jax_params(jc)
    model = params_from_jax(jp, tc, device="cpu")
    tparams = dict(model.named_parameters())
    jopt = jax_adafactor(clip_thresh=clip_thresh)
    topt = adafactor(clip_thresh=clip_thresh, cfg=tc)
    jst, tst = jopt.init(jp), topt.init(tparams)
    jparams = jax.tree.map(jnp.asarray, jp)
    for i in range(steps):
        g = _grads(jp, seed=10 + i)
        jparams, jst, jgn = jopt.update(jax.tree.map(jnp.asarray, g), jst,
                                        jparams, LR)
        _, tst, tgn = topt.update(_port_grads(g, tc, model), tst, tparams, LR)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
    return tc, model, tst, jparams, jst


@pytest.mark.parametrize("clip_thresh", [1.0, 0.1])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_adafactor_on_stacked_leaves_matches_reference(arch, clip_thresh):
    tc, model, tst, jparams, jst = _run_both(arch, clip_thresh)
    assert int(tst["count"]) == int(jst["count"]) == 2
    _compare_trees(_state_numpy(tst, tc), jst["vs"])
    _compare_trees(params_to_numpy(model, tc), jparams)
    # a stacked norm is factored across the layers, as the reference's
    vs = tst["vs"]["blocks/0/ln1"]
    assert sorted(vs) == ["vc", "vr"]
    assert vs["vr"].shape == (tc.n_superblocks,)
    assert vs["vc"].shape == (tc.d_model,)


def test_chunked_update_equals_one_chunk(monkeypatch):
    """The two passes over chunks of the experts give the update of one
    chunk a layer (the clip binding, so the leaf-wide RMS is used)."""
    tc, model, tst, _, _ = _run_both("qwen3-moe-235b-a22b", 0.1)
    monkeypatch.setattr(optimizers, "_CHUNK", 3 * 64 * 64)
    assert len(optimizers._chunks(8, 64 * 64)) == 3
    tc2, model2, tst2, _, _ = _run_both("qwen3-moe-235b-a22b", 0.1)
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    _compare_trees(_state_numpy(tst2, tc2), _state_numpy(tst, tc))


@pytest.mark.parametrize("arch", list_archs())
def test_init_state_has_the_reference_shapes(arch):
    """init's state, through the stacked view, is the reference's
    ``opt["vs"]`` tree leaf for leaf (shapes and f32), for every arch."""
    jc = jax_smoke(arch)
    tc = get_smoke_config(arch)
    jst = jax.eval_shape(
        lambda: jax_adafactor().init(jtf.init_params(jax.random.PRNGKey(0),
                                                     jc)))
    model = init_params(tc, None, device="meta")
    tst = adafactor(cfg=tc).init(dict(model.named_parameters()))
    tree = reference_tree(tst["vs"], tc)
    jl = jax.tree_util.tree_leaves_with_path(jst["vs"])
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tree,
                                           is_leaf=torch.is_tensor)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jst["vs"]))
    for (path, j), t in zip(jl, jax.tree.leaves(tree,
                                                is_leaf=torch.is_tensor)):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
