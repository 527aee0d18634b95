"""The port's training path (repro_torch.train, optim, models.losses,
forward_train) against the JAX reference on the CPU, on the same weights and
the same batches.

Weights are the reference's own (``repro.models.init_params``), with every
norm and zero-initialised vector given random values (as the model tests
do), converted by ``params_from_jax``.  Batches are the reference's
``SyntheticTokens`` draws (whisper's with ``frames``, paligemma's with
``patches``).  Both packages take one step of ``build_train_step`` with the
config's optimizer (AdamW with f32 master; Adafactor over the stacked
leaves for the two MoE configs, whose loss carries the MoE aux) and a
constant learning rate: the schedule's first value is 0, which would leave
the params unchanged.
The reference's step is jitted; the port's runs eagerly, its attention
through the flash wrapper's plain version (f32 P·V, as the kernel).  rwkv6-7b
also runs with ``forward_train(seq_exact=True)`` in both train steps (the
exact sequential wkv; neither ``build_train_step`` takes the flag, so both
steps are patched alike).

Tolerances, with reasons:
* f32 params: the loss to 1e-5 relative, each grad leaf and each of AdamW's
  m and v leaves to 1e-4 in relative norm (||t - j|| / ||j||).  rwkv6-7b's
  chunked path is held to 5e-4: the port's plain chunked wkv (torch's CPU
  products and exps) rounds its output to ~8e-7 relative where the
  reference's and the exact sequential form round to ~1e-7, and each
  layer's per-head group norm divides by small per-head deviations, which
  amplifies that ~100x in the grads; the same weights through the port with
  the wkv core in f64 match the reference to 2.8e-5 (measured when this
  test was written), and ``seq_exact`` holds 1e-4.
* AdamW's first step moves each weight by about lr * sign(g) wherever
  |g| >> eps, so an element whose grad is near 0 may step the other way:
  the master weights are held elementwise within 2 lr (1 + wd |p|).
* Adafactor's state leaves to twice the grads' tolerance (they hold
  squared grads, as AdamW's v), and each leaf's step (new weights - old) to
  the grads' tolerance in relative norm: the step is continuous in the
  grads.

The same steps with bf16 params are in tests/test_torch_train_bf16.py.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.losses import softmax_xent as jax_xent  # noqa: E402
from repro.optim import adafactor as jax_adafactor  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.checkpoint import TwoTierCheckpoint  # noqa: E402
from repro_torch.checkpoint.twotier import flatten  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import forward_train, init_params  # noqa: E402
from repro_torch.models.losses import softmax_xent  # noqa: E402
from repro_torch.models.weights import (params_from_jax,  # noqa: E402
                                        params_to_numpy, reference_tree)
from repro_torch.optim import (adafactor, adamw, cosine_schedule,  # noqa: E402
                               make_optimizer)
from repro_torch.train import steps as tsteps  # noqa: E402

ARCHS = ["h2o-danube-1.8b", "gemma3-1b", "recurrentgemma-2b", "rwkv6-7b",
         "qwen3-moe-235b-a22b", "arctic-480b", "whisper-small",
         "paligemma-3b"]
B, S = 2, 64          # h2o-danube's smoke window is 32: the window masks
LR = 1e-3
F32_TOL = 1e-4
RWKV_CHUNKED_F32_TOL = 5e-4
NORMAL = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
          "k_norm", "lnx_b", "ba", "bi", "conv_b", "mu_x", "mu", "mu_k",
          "mu_r"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's CPU bf16 matmuls at these small shapes take ~100x longer on
    several threads than on one (thread start-up per call)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(t, j) -> float:
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(cfg, seed=0):
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in NORMAL:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.3, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def _batch(cfg, batch=B, step=0):
    return JaxTokens(cfg, batch, S, seed=0).batch_for_step(step)


@functools.cache
def _reference(arch, dtype, seq_exact=False, grad_accum=1):
    """The reference's grads (one jitted value_and_grad of its loss_fn) and
    one jitted step of its build_train_step, as numpy trees."""
    jc, _ = _cfgs(arch, dtype)
    jp = _jax_params(jc)
    batch = {k: jnp.asarray(v) for k, v in _batch(jc, B * grad_accum).items()}
    opt = jax_make_optimizer(jc.optimizer)
    state = {"params": jp, "opt": opt.init(jp),
             "step": jnp.zeros((), jnp.int32)}
    fwd = functools.partial(jtf.forward_train, seq_exact=seq_exact)
    with mock.patch.object(jsteps, "forward_train", fwd):
        grads = jax.jit(jax.grad(
            lambda p: jsteps.loss_fn(p, jc, batch)[0]))(jp) \
            if grad_accum == 1 else None
        new, metrics = jax.jit(jsteps.build_train_step(
            jc, opt, lambda s: LR, grad_accum=grad_accum))(state, batch)
    return {"params": _np(jp), "grads": None if grads is None else _np(grads),
            "new": _np(new), "metrics": {k: float(v) for k, v in
                                         metrics.items()}}


def _port(arch, dtype, seq_exact=False, grad_accum=1):
    """The port's grads (before the optimizer) and one step of its
    build_train_step from the reference's weights."""
    jc, tc = _cfgs(arch, dtype)
    ref = _reference(arch, dtype, seq_exact, grad_accum)
    model = params_from_jax(_jax_params(jc), tc, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(jc, B * grad_accum).items()}
    opt = make_optimizer(tc.optimizer, cfg=tc)
    state = tsteps.init_train_state(None, tc, opt, params=model)
    grads = None
    fwd = functools.partial(forward_train, seq_exact=seq_exact)
    with mock.patch.object(tsteps, "forward_train", fwd):
        if grad_accum == 1:
            total, _ = tsteps.loss_fn(model, tc, batch)
            total.backward()
            grads = params_to_numpy({n: p.grad for n, p in
                                     model.named_parameters()}, tc)
        step = tsteps.build_train_step(tc, opt, lambda s: LR,
                                       grad_accum=grad_accum)
        state, metrics = step(state, batch)
    if opt.name == "adamw":
        new_opt = {k: params_to_numpy(state["opt"][k], tc)
                   for k in ("m", "v", "master")}
    else:
        new_opt = {"vs": reference_tree(
            {k: {n: t.numpy() for n, t in s.items()}
             for k, s in state["opt"]["vs"].items()}, tc)}
    new = {"params": params_to_numpy(model, tc), "opt": new_opt}
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    return ref, grads, new, {k: float(v) for k, v in metrics.items()}


def _check_grads(grads, ref_grads, tols):
    assert jax.tree.structure(grads) == jax.tree.structure(ref_grads)
    for (path, j), t, tol in zip(_leaves(ref_grads), jax.tree.leaves(grads),
                                 tols):
        assert t.shape == j.shape, jax.tree_util.keystr(path)
        err = _rel(t, j)
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def _check_master(new, ref, wd=0.1):
    """AdamW's new weights within 2 lr (1 + wd |p|) of the reference's, the
    step's ratio m / sqrt(v) allowed 2^-7 past 1 for the bf16 rounding of
    (1 - b1) g and (1 - b2) g^2 in bf16 grads' dtype."""
    for (path, j), t, p in zip(_leaves(ref["new"]["opt"]["master"]),
                               jax.tree.leaves(new["opt"]["master"]),
                               jax.tree.leaves(ref["params"])):
        bound = 2 * LR * (1 + wd * np.abs(p)) * (1 + 2 ** -7)
        assert np.all(np.abs(t - j) <= bound), jax.tree_util.keystr(path)


def _check_steps(new, ref, tols):
    """Adafactor's step on each leaf (new weights - old) to its tolerance
    in relative norm: its update is continuous in the grads (no sign flips
    as AdamW's first step has)."""
    for (path, j), t, p, tol in zip(_leaves(ref["new"]["params"]),
                                    jax.tree.leaves(new["params"]),
                                    jax.tree.leaves(ref["params"]), tols):
        err = _rel(t.astype(np.float64) - p, j.astype(np.float64) - p)
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


# seq_exact changes only RWKV layers
CASES = [(arch, False) for arch in ARCHS] + [("rwkv6-7b", True)]


@pytest.mark.parametrize("arch,seq_exact", CASES)
def test_train_step_f32_matches_reference(arch, seq_exact):
    ref, grads, new, metrics = _port(arch, "float32", seq_exact)
    tol = RWKV_CHUNKED_F32_TOL if arch == "rwkv6-7b" and not seq_exact \
        else F32_TOL
    assert abs(metrics["loss"] - ref["metrics"]["loss"]) <= \
        1e-5 * abs(ref["metrics"]["loss"])
    assert abs(metrics["grad_norm"] - ref["metrics"]["grad_norm"]) <= \
        tol * ref["metrics"]["grad_norm"]
    assert metrics["lr"] == pytest.approx(LR)
    _check_grads(grads, ref["grads"], [tol] * len(jax.tree.leaves(grads)))
    if "vs" in new["opt"]:                       # Adafactor (the MoE configs)
        _check_grads(new["opt"]["vs"], ref["new"]["opt"]["vs"],
                     [2 * tol] * len(jax.tree.leaves(new["opt"]["vs"])))
        _check_steps(new, ref, [tol] * len(jax.tree.leaves(new["params"])))
        return
    for k in ("m", "v"):
        _check_grads(new["opt"][k], ref["new"]["opt"][k],
                     [2 * tol if k == "v" else tol] *
                     len(jax.tree.leaves(grads)))
    _check_master(new, ref)
    np.testing.assert_array_equal(
        np.concatenate([a.ravel() for a in jax.tree.leaves(new["params"])]),
        np.concatenate([a.ravel() for a in
                        jax.tree.leaves(new["opt"]["master"])]))


def test_grad_accum_matches_reference():
    """Two microbatches: grads summed, then divided by 2, as the reference's
    grad_accum=2 (loss, AdamW state and new weights)."""
    ref, _, new, metrics = _port("h2o-danube-1.8b", "float32", grad_accum=2)
    assert abs(metrics["loss"] - ref["metrics"]["loss"]) <= \
        1e-5 * abs(ref["metrics"]["loss"])
    assert metrics["tokens"] == ref["metrics"]["tokens"]
    n = len(jax.tree.leaves(new["opt"]["m"]))
    _check_grads(new["opt"]["m"], ref["new"]["opt"]["m"], [F32_TOL] * n)
    _check_grads(new["opt"]["v"], ref["new"]["opt"]["v"], [2 * F32_TOL] * n)
    _check_master(new, ref)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
def test_softmax_xent_with_ignored_labels_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 17, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    labels[rng.random((3, 17)) < 0.25] = -1
    jl, jn = jax_xent(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(tn) == int(jn) == int((labels != -1).sum())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    bf = torch.from_numpy(logits).bfloat16()
    jl16, _ = jax_xent(jnp.asarray(bf.float().numpy(), jnp.bfloat16),
                       jnp.asarray(labels))
    np.testing.assert_allclose(float(softmax_xent(bf, torch.from_numpy(
        labels))[0]), float(jl16), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    j, t = jax_cosine(3e-3, 20, 2000), cosine_schedule(3e-3, 20, 2000)
    for step in (0, 10, 20, 1000, 2000, 3000):
        got, want = float(t(step)), float(j(step))
        assert got == pytest.approx(want, rel=1e-6, abs=0), step
        assert float(t(torch.tensor(step, dtype=torch.int32))) == got
    assert float(t(0)) == 0.0


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (12, 8), "b": (8,), "k": (3, 5, 6)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) * 0.3
              for n, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,kw", [("adamw", {"master": True}),
                                     ("adamw", {"master": False}),
                                     ("adafactor", {"weight_decay": 0.01})])
def test_optimizer_updates_match_reference(name, kw):
    """Three updates on the same f32 params and grads: new params and every
    state leaf to 1e-5 relative, elementwise against the element or, near
    zero (m sums grads of either sign), the leaf's largest element."""
    jopt = {"adamw": jax_adamw, "adafactor": jax_adafactor}[name](**kw)
    topt = {"adamw": adamw, "adafactor": adafactor}[name](**kw)
    params, grads = _opt_inputs()
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.tensor(a) for n, a in params.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        jp, jst, jgn = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                   jst, jp, 0.01)
        tp2, tst, tgn = topt.update({n: torch.tensor(a) for n, a in g.items()},
                                    tst, tp, 0.01)
        assert tp2 is tp
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
        for n in params:
            j = np.asarray(jp[n])
            np.testing.assert_allclose(tp[n].numpy(), j, rtol=1e-5,
                                       atol=1e-5 * np.abs(j).max(), err_msg=n)
        jleaves = _leaves(jst)
        tleaves = jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), tst, is_leaf=torch.is_tensor))
        assert len(jleaves) == len(tleaves)
        for (path, j), t in zip(jleaves, tleaves):
            j = np.asarray(j)
            np.testing.assert_allclose(t, j, rtol=1e-5,
                                       atol=1e-5 * np.abs(j).max(),
                                       err_msg=jax.tree_util.keystr(path))
        assert int(tst["count"]) == i + 1


def test_params_to_numpy_inverts_params_from_jax():
    jc, tc = _cfgs("recurrentgemma-2b", "bfloat16")
    jp = jax.tree.map(np.asarray, _jax_params(jc))
    back = params_to_numpy(params_from_jax(jp, tc, device="cpu"), tc)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for (path, j), t in zip(_leaves(jp), jax.tree.leaves(back)):
        assert t.shape == j.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(t, j.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_tokens_bit_equal_to_reference(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    for seed, step in ((0, 0), (3, 7), (11, 123)):
        j = JaxTokens(jc, 3, 40, seed=seed).batch_for_step(step)
        t = SyntheticTokens(tc, 3, 40, seed=seed).batch_for_step(step)
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    it = SyntheticTokens(tc, 2, 16, seed=5).start(step=4)
    try:
        first = next(it)
    finally:
        it.stop()
    np.testing.assert_array_equal(
        first["tokens"], JaxTokens(jc, 2, 16, seed=5).batch_for_step(4)[
            "tokens"])


def test_remat_changes_memory_not_values(monkeypatch):
    """none, full and dots give the same loss and grads bit for bit; full
    runs each attention forward twice (once in the recompute)."""
    calls = []
    real = flash_ops.flash_attention_bkg

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(flash_ops, "flash_attention_bkg", counted)
    _, tc = _cfgs("gemma3-1b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tc, remat=remat)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        calls.clear()
        loss, _ = tsteps.loss_fn(model, cfg, batch)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()],
                      len(calls))
    n_attn = sum(k in ("local", "global") for k in tc.layer_kinds())
    assert out["none"][2] == n_attn and out["full"][2] == 2 * n_attn
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_forward_train_logits_match_reference():
    jc, tc = _cfgs("h2o-danube-1.8b", "float32")
    jp = _jax_params(jc)
    tok = _batch(jc)["tokens"]
    jl, jaux = jtf.forward_train(jp, jc, {"tokens": jnp.asarray(tok)})
    tl, taux = forward_train(params_from_jax(jp, tc, device="cpu"), tc,
                             {"tokens": torch.from_numpy(tok)})
    assert tl.shape == (B, S, tc.vocab_size) and float(taux) == float(jaux) == 0
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=2e-4, rtol=2e-4)


def test_init_train_state_turns_gradients_on():
    _, tc = _cfgs("h2o-danube-1.8b", "bfloat16")
    model = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    st = tsteps.init_train_state(None, tc, adamw(), params=model)
    assert st["params"] is model
    assert all(p.requires_grad for p in model.parameters())
    assert sorted(st["opt"]) == ["count", "m", "master", "v"]
    assert all(t.dtype == torch.float32 for k in ("m", "v", "master")
               for t in st["opt"][k].values())


def test_checkpoint_snapshot_taken_before_maybe_save_returns(tmp_path):
    """The local tier writes in the background while the step updates the
    params in place: the restored state is the one at the save, bit for bit."""
    _, tc = _cfgs("h2o-danube-1.8b", "bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    step = tsteps.build_train_step(tc, adamw(), lambda s: LR)
    st = tsteps.init_train_state(torch.Generator().manual_seed(0), tc,
                                 adamw(), device="cpu")
    st, _ = step(st, batch)
    ck = TwoTierCheckpoint(str(tmp_path), local_every=1, global_every=50)
    saved = {k: t.clone() for k, t in flatten(st).items()}
    ck.maybe_save(st, 1)
    st, _ = step(st, batch)                  # in place, while it writes
    fresh = tsteps.init_train_state(torch.Generator().manual_seed(1), tc,
                                    adamw(), device="cpu")
    restored, at = ck.restore(fresh)
    assert at == 1 and restored is fresh
    got = flatten(restored)
    assert sorted(got) == sorted(saved)
    for k in saved:
        assert got[k].dtype == saved[k].dtype and torch.equal(got[k], saved[k])
    assert not torch.equal(flatten(st)["params/embed"], saved["params/embed"])


def test_launch_train_on_cpu(capsys):
    m = launch_train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                           "--seq", "16"])
    assert m.steps == 3 and all(np.isfinite(m.losses))
    assert "final loss" in capsys.readouterr().out
