"""The port's train step with bf16 params (the configs' default) against
the JAX reference's, on the CPU: the cases, weights and batches of
tests/test_torch_train.py, whose helpers this file uses.

Tolerances, with reasons: the loss to 2e-2 relative; each grad leaf to 5e-2
in relative norm (||t - j|| / ||j||), or to twice what bf16 rounding moves
that leaf in the reference itself (its bf16 grads against its f32 grads on
the same weights) where that is larger; AdamW's new master weights within
2 lr (1 + wd |p|); Adafactor's step on each leaf (the MoE configs: new bf16
weights - old) to 5e-2 in relative norm, or twice what bf16 moves that
step in the reference itself where that is larger (its first step is about
lr, a few bf16 ulps of a weight, so rounding the new weights alone moves it
by several percent: 13–14% on two leaves when this test was written).  The reference's bf16 gelu and casts round differently
from torch's (``ROADMAP.md`` "Reference numerics"), and a random stack
amplifies rounding: gemma3-1b's q/k norms move by up to 9% and rwkv6-7b's
time-mix weights by more than 100% between the reference's own bf16 and f32
grads (measured when this test was written).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from test_torch_train import (CASES, LR, _batch, _cfgs,  # noqa: E402,F401
                              _check_grads, _check_master, _check_steps,
                              _jax_params, _np,
                              _port, _reference, _rel, one_thread)

BF16_TOL = 5e-2


@functools.cache
def _reference_bf16_spread(arch):
    """What bf16 rounding moves each grad leaf in the reference itself: its
    bf16 grads against its f32 grads on the same (bf16-valued) weights."""
    jc, _ = _cfgs(arch, "bfloat16")
    jp = _jax_params(jc)
    jc32 = dataclasses.replace(jc, param_dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = {k: jnp.asarray(v) for k, v in _batch(jc).items()}
    g32 = jax.jit(jax.grad(lambda p: jsteps.loss_fn(p, jc32, batch)[0]))(jp32)
    g16 = _reference(arch, "bfloat16", False, 1)["grads"]
    return [_rel(a, b) for a, b in zip(jax.tree.leaves(g16),
                                       jax.tree.leaves(_np(g32)))]


@functools.cache
def _reference_bf16_step_spread(arch):
    """What bf16 moves each leaf's optimizer step (new weights - old) in the
    reference itself: its bf16 step against its f32 step from the same
    (bf16-valued) weights.  Adafactor's first step is about lr a weight,
    a few bf16 ulps of a weight, so the rounding of the new weights alone
    moves it by several percent."""
    jc, _ = _cfgs(arch, "bfloat16")
    jp = _jax_params(jc)
    jc32 = dataclasses.replace(jc, param_dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = {k: jnp.asarray(v) for k, v in _batch(jc).items()}
    opt = jax_make_optimizer(jc.optimizer)
    state = {"params": jp32, "opt": opt.init(jp32),
             "step": jnp.zeros((), jnp.int32)}
    new32, _ = jax.jit(jsteps.build_train_step(jc32, opt, lambda s: LR))(
        state, batch)
    ref = _reference(arch, "bfloat16", False, 1)
    return [_rel(a - p, b - p) for a, b, p in zip(
        jax.tree.leaves(ref["new"]["params"]),
        jax.tree.leaves(_np(new32["params"])),
        jax.tree.leaves(ref["params"]))]


@pytest.mark.parametrize("arch,seq_exact", CASES)
def test_train_step_bf16_matches_reference(arch, seq_exact):
    ref, grads, new, metrics = _port(arch, "bfloat16", seq_exact)
    assert abs(metrics["loss"] - ref["metrics"]["loss"]) <= \
        2e-2 * abs(ref["metrics"]["loss"])
    tols = [max(BF16_TOL, 2 * s) for s in _reference_bf16_spread(arch)]
    _check_grads(grads, ref["grads"], tols)
    if "vs" in new["opt"]:                       # Adafactor (the MoE configs)
        _check_steps(new, ref, [max(BF16_TOL, 2 * s)
                                for s in _reference_bf16_step_spread(arch)])
    else:
        _check_master(new, ref)
