"""The port's mixture of experts (repro_torch.models.moe) and its two MoE
architectures (qwen3-moe-235b-a22b; arctic-480b, with a parallel dense
residual FFN) against the JAX reference on their smoke configs.

Weights are the reference's own (``init_moe``, ``init_params``; every norm
given random values so that the ``(1 + scale)`` path is tested away from
zero), converted by ``params_from_jax``.  Inputs are numpy draws.  The JAX
model runs its causal attention with the Pallas flash kernel in interpret
mode, the function the port's attention computes on the CPU (see
tests/test_torch_model.py).  The helpers here also serve
tests/test_torch_encdec_vision.py.

Tolerances, with reasons (those of tests/test_torch_model.py):
* f32: 2e-4 absolute and relative (summation order).  The router computes
  in f64 in the port and in f32 in the reference; its gates agree to 1e-6
  and its expert indices exactly.
* bf16: 5e-2, logits and layer outputs elementwise, cache leaves in
  relative norm (||t - j|| / ||j||).  In a bf16 model, rounding-level
  differences between the frameworks (XLA fuses; torch rounds every op)
  move a router's input by an ulp, and a near-tie in the top-k then picks
  another expert for that token in both directions.  So the bf16 model
  tests run the port routed as the reference was (``pinned_routes``), so
  that every other difference is rounding, and hold each route that would
  have differed to a near-tie: the port's probability of the reference's
  weakest chosen expert is within 5e-2 (relative) of its own k-th largest.
  The f32 model tests pin nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import disable_flash_attention as jax_flash_off  # noqa: E402
from repro.kernels import enable_flash_attention as jax_flash_on  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.modules import MLP  # noqa: E402
from repro_torch.models.weights import (params_from_jax,  # noqa: E402
                                        params_to_numpy, to_tensor)

MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
NORMS = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
         "k_norm", "ln_x", "enc_norm"}
B, S = 2, 64


class pinned_routes:
    """Within the block, every ``_route`` call of the reference records its
    expert indices (through an ordered callback, so also inside scan and
    jit), and the port's calls, in the same order, take them: the gates are
    the port's own probabilities at those experts, normalised.  ``flips``
    counts the (call, token) rows where the port would have picked another
    set of experts, and ``gap`` is the largest (p_k - p_w) / p_k over them,
    p_k the port's k-th largest probability and p_w its probability of the
    reference's weakest chosen expert."""

    def __init__(self):
        self.ref, self.calls, self.flips, self.rows = [], 0, 0, 0
        self.gap = 0.0

    def __enter__(self):
        self._j, self._t = jmoe._route, tmoe._route

        def jax_route(x, router, k):
            out = self._j(x, router, k)
            jax.debug.callback(lambda i: self.ref.append(np.array(i)),
                               out[1], ordered=True)
            return out

        def torch_route(x, router, k):
            gate, idx, probs = self._t(x, router, k)
            want = torch.as_tensor(self.ref[self.calls], dtype=torch.int64)
            self.calls += 1
            self.rows += idx.shape[0]
            flip = (idx.sort(dim=1).values != want.sort(dim=1).values).any(1)
            if flip.any():
                pk = probs.gather(1, idx[:, -1:])[flip, 0]
                pw = probs.gather(1, want).min(dim=1).values[flip]
                self.flips += int(flip.sum())
                self.gap = max(self.gap, float(((pk - pw) / pk).max()))
            g = torch.gather(probs, 1, want)
            return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want, \
                probs
        jmoe._route, tmoe._route = jax_route, torch_route
        return self

    def __exit__(self, *exc):
        jmoe._route, tmoe._route = self._j, self._t


def cfgs(arch, dtype, **changes):
    return (dataclasses.replace(jax_smoke(arch), param_dtype=dtype, **changes),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype,
                                **changes))


def jax_params(cfg, seed):
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in NORMS:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.3, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


def models(arch, dtype, seed=0, **changes):
    jc, tc = cfgs(arch, dtype, **changes)
    jp = jax_params(jc, seed)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")


def numpy_batch(cfg, batch, seq, seed):
    """The reference's make_batch structure, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def tokens(n):
        return rng.integers(2, cfg.vocab_size, (batch, n)).astype(np.int32)

    def normal(n):
        return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        return {"frames": normal(seq), "tokens": tokens(seq // cfg.dec_len_ratio)}
    if cfg.frontend == "vision":
        return {"patches": normal(cfg.n_prefix_tokens),
                "tokens": tokens(seq - cfg.n_prefix_tokens)}
    return {"tokens": tokens(seq)}


def decode_start(cfg, batch):
    """The position right after a prefill of ``batch``."""
    n = batch["tokens"].shape[1]
    return n + cfg.n_prefix_tokens if cfg.frontend == "vision" else n


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def with_jax_flash(fn, *args):
    jax_flash_on(interpret=True, bq=16, bk=16)
    try:
        return fn(*args)
    finally:
        jax_flash_off()


def torch_leaves(cache):
    return [entry[name] for part in ("blocks", "tail") for entry in cache[part]
            for name in sorted(entry)]


def close(t, j, tol, what):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def close_caches(tcache, jcache, tol, normwise=False):
    """Every leaf, with the reference's shape and dtype, to ``tol`` (in
    relative norm with ``normwise``); without ``normwise`` the values of an
    int8 leaf to one quantization step (see
    tests/test_torch_encdec_vision.py)."""
    jl, tl = jax.tree.leaves(jcache), torch_leaves(tcache)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert tuple(t.shape) == j.shape, (i, t.shape, j.shape)
        assert str(t.dtype).split(".")[1] == str(j.dtype), (i, t.dtype, j.dtype)
        if normwise:
            t, j = t.float().numpy(), np.asarray(j, np.float32)
            err = np.linalg.norm(t - j) / np.linalg.norm(j)
            assert err <= tol, f"cache leaf {i}: relative error {err}"
        elif j.dtype == np.int8:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1,
                                       rtol=0, err_msg=f"cache leaf {i}")
        else:
            close(t, j, tol, f"cache leaf {i}")


def check_prefill_then_decode(arch, dtype, steps=4, seed=0, pins=None,
                              **changes):
    """forward_prefill, then ``steps`` forward_decode steps from its cache,
    both against the reference: logits and every cache leaf.  The reference
    runs first at each step, so a ``pinned_routes`` block around the call
    hands its routes to the port."""
    jc, tc, jp, tp = models(arch, dtype, seed, **changes)
    batch = numpy_batch(tc, B, S, seed)
    jl, jcache = with_jax_flash(jtf.forward_prefill, jp, jc, as_jax(batch))
    if pins is not None:
        jax.effects_barrier()
    tl, tcache = ttf.forward_prefill(tp, tc, as_torch(batch))
    assert tl.dtype == getattr(torch, dtype) and tuple(tl.shape) == jl.shape
    normwise = dtype == "bfloat16"
    close(tl, jl, TOL[dtype], "prefill logits")
    close_caches(tcache, jcache, TOL[dtype], normwise)
    jdec = jax.jit(lambda p, c, t, pos: jtf.forward_decode(p, jc, c, t, pos))
    toks = np.random.default_rng(seed + 1).integers(
        2, tc.vocab_size, (steps, B, 1)).astype(np.int32)
    start = decode_start(tc, batch)
    for i in range(steps):
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks[i]), jnp.int32(start + i))
        if pins is not None:
            jax.effects_barrier()
        tl, tcache = ttf.forward_decode(tp, tc, tcache, torch.tensor(toks[i]),
                                        start + i)
        close(tl, jl, TOL[dtype], f"decode logits at step {i}")
    close_caches(tcache, jcache, TOL[dtype], normwise)


def check_train_forward(arch, dtype, seed=0):
    jc, tc, jp, tp = models(arch, dtype, seed)
    batch = numpy_batch(tc, B, S, seed)
    jl, jaux = with_jax_flash(jtf.forward_train, jp, jc, as_jax(batch))
    tl, taux = ttf.forward_train(tp, tc, as_torch(batch))
    assert taux.dtype == torch.float32 and taux.dim() == 0
    close(tl, jl, TOL[dtype], "train logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)
    return float(taux)


# ---------------------------------------------------------------------------
# moe_dense on its own
# ---------------------------------------------------------------------------
def _moe_pair(arch, dtype, seed, **moe_changes):
    jc, tc = cfgs(arch, dtype)
    if moe_changes:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_changes))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_changes))
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc)

    def conv(d):
        return {k: to_tensor(np.asarray(v), "cpu") for k, v in d.items()
                if k != "dense"}
    tp = tmoe.MoE(conv(jp), MLP(conv(jp["dense"])) if "dense" in jp else None)
    x = np.random.default_rng(seed).standard_normal(
        (B, 32, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, jnp.asarray(x, dtype), torch.tensor(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_matches_jax(arch, dtype, groups):
    jc, tc, jp, tp, jx, tx = _moe_pair(arch, dtype, seed=groups)
    jy, jaux = jmoe.moe_dense(jp, jx, jc, groups=groups)
    ty, taux = tmoe.moe_dense(tp, tx, tc, groups=groups)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == jy.shape
    close(ty, jy, TOL[dtype], "moe output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_matches_jax(arch, dtype):
    """Expert indices equal, in top-k order; gates and probabilities to
    1e-6 (f64 router product against f32)."""
    jc, tc, jp, tp, jx, tx = _moe_pair(arch, dtype, seed=3)
    k = jc.moe.experts_per_token
    jg, ji, jprob = jmoe._route(jx.reshape(-1, jc.d_model), jp["router"], k)
    tg, ti, tprob = tmoe._route(tx.reshape(-1, tc.d_model), tp.router, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-6)
    np.testing.assert_allclose(
        float(tmoe._aux_loss(tprob, ti, tc.moe.n_experts)),
        float(jmoe._aux_loss(jprob, ji, jc.moe.n_experts)), rtol=1e-6)


def test_routing_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: lax.top_k takes the lower index first."""
    router = np.eye(4, 8, dtype=np.float32)
    router[:, 5] = router[:, 1]            # experts 1 and 5 always tie
    x = np.array([[0, 2, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], np.float32)
    jg, ji, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), 3)
    tg, ti, _ = tmoe._route(torch.tensor(x), torch.tensor(router), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, :2].tolist() == [1, 5]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_drops_past_capacity_as_jax(arch, dtype):
    """A small capacity factor: tokens past an expert's capacity are
    dropped, the same tokens in both packages."""
    jc, tc, jp, tp, jx, tx = _moe_pair(arch, dtype, seed=5,
                                       capacity_factor=0.25)
    T, k, E = B * 32, tc.moe.experts_per_token, tc.moe.n_experts
    C = tmoe._capacity(T, k, E, 0.25)
    _, idx, _ = tmoe._route(tx.reshape(T, -1), tp.router, k)
    assert int(torch.bincount(idx.reshape(-1), minlength=E).max()) > C, \
        "no expert went past its capacity"
    jy, _ = jmoe.moe_dense(jp, jx, jc)
    ty, _ = tmoe.moe_dense(tp, tx, tc)
    close(ty, jy, TOL[dtype], "moe output with drops")


def test_capacity_matches_jax():
    for T in (1, 4, 7, 64, 4096):
        for k in (1, 2, 8):
            for E in (8, 128):
                for cf in (0.25, 1.0, 1.25):
                    assert tmoe._capacity(T, k, E, cf) == \
                        jmoe._capacity(T, k, E, cf)


@pytest.mark.parametrize("decode", [False, True])
def test_moe_layer_takes_moe_sharded_under_rules(monkeypatch, tmp_path,
                                                 decode):
    """Without sharding rules moe_layer is moe_dense; under them (a gloo
    group of one process, a 1 x 1 mesh) it takes moe_sharded, whose
    collectives are then identities: the same values bit for bit."""
    import torch.distributed as dist
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.distributed import context
    from repro_torch.distributed.layouts import choose_layout
    from repro_torch.launch.mesh import make_mesh
    _, tc, _, tp, _, tx = _moe_pair("arctic-480b", "float32", seed=0)
    if decode:
        tx = tx[:, :1]
    want = tmoe.moe_dense(tp, tx, tc)
    taken = []
    real = tmoe.moe_sharded
    monkeypatch.setattr(tmoe, "moe_sharded",
                        lambda *a, **kw: taken.append(kw) or real(*a, **kw))
    for a, b in zip(tmoe.moe_layer(tp, tx, tc, decode=decode), want):
        assert torch.equal(a, b)
    assert taken == []
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        rules = choose_layout(tc, LM_SHAPES["train_4k"], mesh)
        with context.use_rules(rules):
            got = tmoe.moe_layer(tp, tx, tc, decode=decode)
    finally:
        dist.destroy_process_group()
    assert taken == [{"decode": decode}]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_moe_dense_rejects_uneven_groups():
    _, tc, _, tp, _, tx = _moe_pair("qwen3-moe-235b-a22b", "float32", seed=0)
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_dense(tp, tx, tc, groups=3)


# ---------------------------------------------------------------------------
# the two MoE models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    check_prefill_then_decode(arch, "float32")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_matches_jax_bf16(arch):
    """bf16, the port routed as the reference was (see the module's
    docstring); a route that would have differed is a near-tie."""
    with pinned_routes() as pins:
        check_prefill_then_decode(arch, "bfloat16", pins=pins)
    cfg = get_smoke_config(arch)
    assert pins.calls == 5 * cfg.n_layers        # prefill and 4 decode steps
    assert pins.gap <= TOL["bfloat16"], (pins.gap, pins.flips, pins.rows)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_matches_jax(arch):
    assert check_train_forward(arch, "float32") > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip(arch):
    """params_to_numpy gives back the reference's tree, leaf for leaf."""
    jc, tc, jp, tp = models(arch, "float32")
    back = params_to_numpy(tp, tc)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for b, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(b, w)
    model = ttf.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in model.named_parameters()} \
        == {n: (tuple(t.shape), t.dtype) for n, t in tp.named_parameters()}
