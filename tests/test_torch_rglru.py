"""The port's RG-LRU path (repro_torch.kernels.rglru_scan, repro_torch.models
.rglru) against the JAX reference on the same numpy inputs.

The scan's plain version is held against the Pallas kernel in interpret mode
(as tests/test_kernels.py runs it) and against the reference's associative
scan, over test_rglru_kernel's shapes, at that test's 2e-5: all three round
the same recurrence in different orders, a few f32 ulps of |h| < ~20.
The kernels' walk (``rglru_scan_walk_ref``: each channel in order, h
carried in f64 as both kernels carry it, rounded to f32 where stored) is held the same way, over that sweep, C that no group divides and
a near 1; an f32 carry is shown to drift past 2e-5 from the recurrence in
f64 where a is near 1 over 1024 steps, which the f64 carry holds.

The block (rglru_seq, rglru_decode) takes the reference's own parameters
with the zero-initialised ba, bi and conv_b given random values, so that no
term is tested only at zero.  Tolerances: f32 2e-5 (summation order of the
projections only); bf16 2e-2 absolute and relative, about two bf16 ulps near
1 (the conv output and the projections round to bf16 where one rounding step
may land differently); the f32 state h is held to the same 2e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.rglru_scan.kernel import rglru_scan_blocked  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    plan, rglru_scan, rglru_scan_ref, rglru_scan_walk_ref)
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models.weights import to_tensor  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 2e-5


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("B,S,C,bt,bc", [
    (2, 256, 128, 64, 64), (1, 128, 512, 32, 256), (3, 64, 96, 16, 32),
])
def test_plain_scan_matches_pallas(B, S, C, bt, bc):
    rng = np.random.default_rng(B * S + C)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, C))))).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h = rglru_scan(torch.tensor(a), torch.tensor(b))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, C)
    _close(h, rglru_scan_blocked(jnp.asarray(a), jnp.asarray(b), bt=bt, bc=bc),
           SCAN_TOL, "Pallas kernel")
    _close(h, jax_scan_ref(jnp.asarray(a), jnp.asarray(b)), SCAN_TOL,
           "associative scan")


@pytest.mark.parametrize("S", [1, 2, 5, 33])
def test_plain_scan_any_length(S):
    """Lengths the Pallas blocks do not divide, against a direct loop."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    want = np.zeros_like(b)
    h = np.zeros((2, 8), np.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    _close(rglru_scan_ref(torch.tensor(a), torch.tensor(b)), want, SCAN_TOL)


def _gates(B, S, C, seed, near_one=False):
    rng = np.random.default_rng(seed)
    if near_one:       # slow decay: |h| grows to ~sqrt(S)
        a = 1 - rng.uniform(0, 1e-3, (B, S, C))
    else:
        a = 1 / (1 + np.exp(-rng.standard_normal((B, S, C))))
    return a.astype(np.float32), \
        rng.standard_normal((B, S, C)).astype(np.float32)


@pytest.mark.parametrize("B,S,C,bt,bc,near_one", [
    (2, 256, 128, 64, 64, False), (1, 128, 512, 32, 256, False),
    (3, 64, 96, 16, 32, False), (2, 256, 128, 64, 64, True),
    (4, 64, 2560, 64, 256, False),        # recurrentgemma-2b's plan: G = 80
    (2, 37, 70, None, None, False),       # ragged S and C, C % 4 != 0
    (4, 33, 2564, None, None, True),      # the last group holds 4 channels
])
def test_grouped_walk_matches_pallas(B, S, C, bt, bc, near_one):
    a, b = _gates(B, S, C, B + S + C, near_one)
    h = rglru_scan_walk_ref(torch.tensor(a), torch.tensor(b))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, C)
    if bt is not None:
        _close(h, rglru_scan_blocked(jnp.asarray(a), jnp.asarray(b), bt=bt,
                                     bc=bc), SCAN_TOL, "Pallas kernel")
    _close(h, jax_scan_ref(jnp.asarray(a), jnp.asarray(b)), SCAN_TOL,
           "associative scan")
    _close(h, rglru_scan_ref(torch.tensor(a), torch.tensor(b)), SCAN_TOL,
           "plain version")


@pytest.mark.parametrize("B,C", [(4, 2560), (2, 128), (3, 96), (2, 70),
                                 (1, 2560), (64, 2560), (4, 2564)])
def test_grouped_plan(B, C):
    """Groups of 4..128 channels (a multiple of 4, so TMA boxes stay 16-byte
    aligned) that fill the 132 SMs of an H100 about once."""
    G = plan(B, C, 132)
    assert G % 4 == 0 and 4 <= G <= 128
    ctas = B * -(-C // G)
    assert ctas <= 132 or G == 128
    if (B, C) == (4, 2560):
        assert (G, ctas) == (80, 128)


@pytest.mark.parametrize("carry,holds", [(torch.float64, True),
                                         (torch.float32, False)])
def test_f32_carry_misses_at_slow_decay(carry, holds):
    """a near 1 over recurrentgemma-2b's prompt length, b ~ N(0, 1): |h|
    grows to ~sqrt(S) and nothing decays the walk's roundings.  The f64
    carry (both kernels') stays within one f32 rounding of the recurrence
    in f64 and so holds 2e-5; an f32 carry (one f32 FMA a step) drifts past
    it."""
    a, b = (torch.tensor(x) for x in _gates(1, 1024, 512, 0, near_one=True))
    want = rglru_scan_ref(a.double(), b.double())
    h = rglru_scan_walk_ref(a, b, carry=carry)
    excess = ((h.double() - want).abs() - SCAN_TOL * want.abs()).max().item()
    assert (excess <= SCAN_TOL) == holds, excess
    if holds:      # rounded once: within f32's unit roundoff of |h|
        assert ((h.double() - want).abs()
                <= 2.0 ** -24 * want.abs() + 1e-9).all()


def _params(dtype, seed=0):
    cfg = dataclasses.replace(jax_smoke(ARCH), param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype)
    jp = jr.init_rglru(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for name in ("ba", "bi", "conv_b"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.5,
                               jnp.float32)
    tp = tr.RGLRU({n: to_tensor(np.asarray(a), "cpu") for n, a in jp.items()})
    return cfg, tcfg, jp, tp


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, cfg.param_dtype), \
        torch.tensor(x).to(getattr(torch, cfg.param_dtype))


def test_init_matches_reference_layout():
    cfg, tcfg, jp, _ = _params("bfloat16")
    tp = tr.init_rglru(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {n: (tuple(t.shape), str(t.dtype).split(".")[1])
           for n, t in tp.named_parameters()}
    want = {n: (a.shape, str(a.dtype)) for n, a in jp.items()}
    assert got == want
    # linspace rounds its steps in another order: one f32 ulp
    np.testing.assert_allclose(tp.lam.numpy(), np.asarray(jp["lam"]),
                               rtol=3e-7)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_seq_matches_jax(dtype, h0):
    cfg, tcfg, jp, tp = _params(dtype)
    jx, tx = _x(cfg, (2, 48, cfg.d_model), 1)
    hinit = np.random.default_rng(2).standard_normal(
        (2, cfg.d_rnn)).astype(np.float32) if h0 else None
    jy, jh, jc = jr.rglru_seq(jp, jx, cfg,
                              None if hinit is None else jnp.asarray(hinit))
    ty, th, tc = tr.rglru_seq(tp, tx, tcfg,
                              None if hinit is None else torch.tensor(hinit))
    assert ty.dtype == tx.dtype and th.dtype == torch.float32
    assert tc.dtype == tx.dtype and tuple(tc.shape) == jc.shape
    _close(ty, jy, TOL[dtype], "y")
    _close(th, jh, TOL[dtype], "h_last")
    _close(tc, jc, 0.0, "conv_tail")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_matches_jax(dtype):
    """Decode from a prefill's (h, conv) for 8 steps: the port's cache is
    updated in place and must track the reference's returned caches."""
    cfg, tcfg, jp, tp = _params(dtype, seed=3)
    jx, tx = _x(cfg, (2, 24, cfg.d_model), 4)
    _, jh, jc = jr.rglru_seq(jp, jx, cfg)
    _, th, tc = tr.rglru_seq(tp, tx, tcfg)
    jcache, tcache = {"h": jh, "conv": jc}, {"h": th, "conv": tc}
    h_buf, conv_buf = tcache["h"], tcache["conv"]
    for step in range(8):
        jxs, txs = _x(cfg, (2, 1, cfg.d_model), 10 + step)
        jy, jcache = jr.rglru_decode(jp, jxs, cfg, jcache)
        ty, tcache = tr.rglru_decode(tp, txs, tcfg, tcache)
        _close(ty, jy, TOL[dtype], f"y at step {step}")
    assert tcache["h"] is h_buf and tcache["conv"] is conv_buf
    _close(tcache["h"], jcache["h"], TOL[dtype], "h")
    _close(tcache["conv"], jcache["conv"], TOL[dtype], "conv")


def test_init_cache_matches_reference():
    cfg, tcfg, _, _ = _params("bfloat16")
    jc = jr.init_rglru_cache(cfg, 3)
    tc = tr.init_rglru_cache(tcfg, 3, device="cpu")
    for name in ("h", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
