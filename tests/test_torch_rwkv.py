"""The port's RWKV-6 path (repro_torch.kernels.rwkv6_chunk, repro_torch.models
.rwkv, group_norm_heads) against the JAX reference on the same numpy inputs.

The wkv6 plain version is held against the Pallas kernel in interpret mode
(as tests/test_kernels.py runs it) and the reference's exact sequential
oracle ``wkv6_ref``, over test_wkv6_kernel's shapes, at that test's 1e-3:
the chunked and the sequential forms round the same sums in different
orders.  Its final state, which the Pallas kernel does not return, is held
against the reference model's ``wkv_chunked`` state and against a
sequential numpy loop.

The tensor-core kernel's numerics (``wkv6_chunk_ref``: chunks of 16, the
in-chunk decays pairwise in f32, the three products with their operands
rounded as ``cvt.rna.tf32`` rounds them) are held the same way over that
sweep and the edges (logw all -5, all -1e-4, S = 1, ragged S) in 3xTF32,
the kernel's choice; the counter-case shows that plain TF32 misses 1e-3.

The blocks take the reference's own parameters with the zero-initialised
``mu_x``, ``mu``, ``lnx_b``, ``mu_k`` and ``mu_r`` given random values, so
that no term is tested only at zero.  Tolerances: f32 1e-4 (summation order
of the projections and the LoRAs; the group norm divides by a per-head
std that amplifies it a little); bf16 2e-2 absolute and relative, about two
bf16 ulps near 1; the time-mix against the sequential ``wkv_scan`` 2e-3,
the tolerance of the reference's test_wkv6_wrapper_matches_model_path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.rwkv6_chunk.kernel import wkv6_chunked  # noqa: E402
from repro.kernels.rwkv6_chunk.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import modules as jm  # noqa: E402
from repro.models import rwkv as jr  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6, wkv6_bh, wkv6_chunk_ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk.ref import TC_CHUNK, tf32_round  # noqa: E402
from repro_torch.models import modules as tm  # noqa: E402
from repro_torch.models import rwkv as tr  # noqa: E402
from repro_torch.models.weights import to_tensor  # noqa: E402

ARCH = "rwkv6-7b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_TOL = 1e-3
SCAN_TOL = 2e-3


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _kernel_inputs(BH, S, hd, seed, logw_value=None):
    """test_wkv6_kernel's distributions, drawn with numpy; ``logw_value``
    sets every logw to one value instead."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((BH, S, hd)) * 0.5),
                   -5.0, -1e-4).astype(np.float32)
    if logw_value is not None:
        logw = np.full_like(logw, logw_value)
    u = (rng.standard_normal((BH, hd)) * 0.1).astype(np.float32)
    return r, k, v, logw, u


def _sequential_state(k, v, logw):
    st = np.zeros((k.shape[0], k.shape[2], k.shape[2]), np.float64)
    for t in range(k.shape[1]):
        st = np.exp(logw[:, t])[:, :, None] * st + \
            k[:, t, :, None] * v[:, t, None, :]
    return st


@pytest.mark.parametrize("BH,S,hd,chunk", [
    (2, 128, 32, 32), (4, 256, 64, 64), (1, 64, 16, 16), (2, 96, 32, 32),
])
def test_plain_wkv6_matches_pallas(BH, S, hd, chunk):
    ins = _kernel_inputs(BH, S, hd, BH * S + hd)
    y, st = wkv6_bh(*map(torch.tensor, ins))
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (BH, S, hd) and tuple(st.shape) == (BH, hd, hd)
    jins = [jnp.asarray(a) for a in ins]
    _close(y, wkv6_chunked(*jins, chunk=chunk), KERNEL_TOL, "Pallas kernel")
    _close(y, jax_wkv6_ref(*jins), KERNEL_TOL, "sequential oracle")
    _close(st, _sequential_state(*ins[1:4]), KERNEL_TOL, "final state")


@pytest.mark.parametrize("S", [1, 7, 37])
def test_plain_wkv6_any_length(S):
    """Lengths no chunk divides: the padded steps leave y and the state as
    the sequential forms have them."""
    ins = _kernel_inputs(3, S, 16, S)
    y, st = wkv6_bh(*map(torch.tensor, ins))
    _close(y, jax_wkv6_ref(*map(jnp.asarray, ins)), KERNEL_TOL, "y")
    _close(st, _sequential_state(*ins[1:4]), KERNEL_TOL, "final state")


def test_tf32_round_is_cvt_rna():
    """Bit-exact cvt.rna.tf32.f32: 10 mantissa bits kept, to nearest, ties
    away from zero, in both signs."""
    ulp = 2.0 ** -10
    pairs = [(1.0, 1.0), (1 + ulp / 2, 1 + ulp), (1 + ulp / 2 - 2 ** -23, 1.0),
             (1 + 1.5 * ulp, 1 + 2 * ulp), (-(1 + ulp / 2), -(1 + ulp)),
             (0.0, 0.0)]
    got = tf32_round(torch.tensor([x for x, _ in pairs], dtype=torch.float32))
    assert got.tolist() == [w for _, w in pairs]
    x = torch.tensor(np.random.default_rng(0).standard_normal(1000),
                     dtype=torch.float32)
    got = tf32_round(x)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert ((got - x).abs() <= x.abs() * 2.0 ** -11).all()


# (BH, S, hd, chunk of the Pallas kernel or None, logw value or None):
# test_wkv6_kernel's sweep, then the edges: logw all -5 (fast decay),
# all -1e-4 (slow decay, a large state), S = 1, S no chunk divides, and
# logw far below the model's clamp
CHUNK_PLAN_CASES = [
    (2, 128, 32, 32, None), (4, 256, 64, 64, None), (1, 64, 16, 16, None),
    (2, 96, 32, 32, None), (2, 256, 64, 64, -5.0), (2, 512, 64, 64, -1e-4),
    (3, 1, 64, None, None), (3, 37, 64, None, None), (2, 37, 16, None, -1e-4),
    (2, 64, 32, 32, -40.0),       # 640 nats a chunk: no factor may overflow
]


@pytest.mark.parametrize("BH,S,hd,chunk,logw_value", CHUNK_PLAN_CASES)
def test_chunk_plan_holds_tolerance(BH, S, hd, chunk, logw_value):
    """The tensor-core kernel's plan (chunks of 16, A pairwise in f32, the
    three products in 3xTF32 with bit-exact cvt.rna rounding) against the
    Pallas kernel in interpret mode, the exact sequential oracle and a
    sequential state, at test_wkv6_kernel's 1e-3."""
    ins = _kernel_inputs(BH, S, hd, BH * S + hd, logw_value)
    y, st = wkv6_chunk_ref(*map(torch.tensor, ins), precision="3xtf32")
    assert tuple(y.shape) == (BH, S, hd) and tuple(st.shape) == (BH, hd, hd)
    jins = [jnp.asarray(a) for a in ins]
    if chunk is not None:
        _close(y, wkv6_chunked(*jins, chunk=chunk), KERNEL_TOL, "Pallas kernel")
    _close(y, jax_wkv6_ref(*jins), KERNEL_TOL, "sequential oracle")
    _close(st, _sequential_state(*ins[1:4]), KERNEL_TOL, "final state")


@pytest.mark.parametrize("BH,S,hd,logw_value", [
    (4, 256, 64, None), (2, 512, 64, -1e-4), (2, 256, 64, -5.0),
])
def test_chunk_plan_plain_tf32_misses_tolerance(BH, S, hd, logw_value):
    """The counter-case: the same plan with each operand rounded to TF32
    once misses 1e-3 where 3xTF32 holds it, so the kernel splits."""
    ins = _kernel_inputs(BH, S, hd, 7, logw_value)
    tins = list(map(torch.tensor, ins))
    want = np.asarray(jax_wkv6_ref(*map(jnp.asarray, ins)), np.float64)

    def excess(y):
        return float((np.abs(y.double().numpy() - want)
                      - KERNEL_TOL * np.abs(want)).max())
    assert excess(wkv6_chunk_ref(*tins, precision="tf32")[0]) > KERNEL_TOL
    assert excess(wkv6_chunk_ref(*tins, precision="3xtf32")[0]) <= KERNEL_TOL
    assert excess(wkv6_chunk_ref(*tins, precision="f32")[0]) <= KERNEL_TOL


def test_chunk_plan_pads_ragged_tail():
    """S one past a chunk: the padded steps leave the state as it was."""
    S = TC_CHUNK + 1
    ins = list(map(torch.tensor, _kernel_inputs(2, S, 32, 3)))
    y, st = wkv6_chunk_ref(*ins)
    y1, st1 = wkv6_chunk_ref(*(t[:, :S - 1] for t in ins[:4]), ins[4])
    torch.testing.assert_close(y[:, :S - 1], y1, atol=0, rtol=0)
    _close(st, _sequential_state(*(t.numpy() for t in ins[1:4])), KERNEL_TOL)


def test_time_mix_seq_through_chunk_plan_matches_wkv_scan(monkeypatch):
    """The model path with the tensor-core kernel's plan where the card
    runs the kernel, against the reference's sequential ``wkv_scan``."""
    calls = []

    def plan(*args):
        calls.append(args[0].shape)
        return wkv6_chunk_ref(*args)
    monkeypatch.setattr(wkv6_ops, "wkv6_ref", plan)
    cfg, tcfg = _cfgs("float32")
    jtm, _, ttm, _ = _params(cfg, seed=2)
    jx, tx = _x(cfg, (2, 64, cfg.d_model), 10, scale=0.5)
    jo, jst, _ = jr.wkv_scan(jtm, jx, cfg)
    to, tst, _ = tr.time_mix_seq(ttm, tx, tcfg)
    assert len(calls) == 1
    _close(to, jo, SCAN_TOL, "out")
    _close(tst, jst, SCAN_TOL, "state")


def test_wkv6_wrapper_folds_heads():
    """The model-facing wrapper folds (B,S,H,hd) as the reference's does."""
    from repro.kernels.rwkv6_chunk.ops import wkv6 as jax_wkv6
    rng = np.random.default_rng(5)
    B, S, H, hd = 2, 32, 3, 16
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    y, st = wkv6(*map(torch.tensor, (r, k, v, logw, u)))
    assert tuple(y.shape) == (B, S, H, hd) and tuple(st.shape) == (B, H, hd, hd)
    _close(y, jax_wkv6(*map(jnp.asarray, (r, k, v, logw, u)), chunk=16),
           KERNEL_TOL)


def _cfgs(dtype):
    return (dataclasses.replace(jax_smoke(ARCH), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype))


def _params(cfg, seed=0):
    jtm = jr.init_time_mix(jax.random.PRNGKey(seed), cfg)
    jcm = jr.init_channel_mix(jax.random.PRNGKey(seed + 1), cfg)
    rng = np.random.default_rng(seed)
    for p, names in ((jtm, ("mu_x", "mu")), (jcm, ("mu_k", "mu_r"))):
        for n in names:
            p[n] = jnp.asarray(rng.uniform(0, 1, p[n].shape), jnp.float32)
    jtm["lnx_b"] = jnp.asarray(rng.standard_normal(cfg.d_model) * 0.3,
                               jnp.float32)
    jtm["lnx_s"] = jnp.asarray(1 + rng.standard_normal(cfg.d_model) * 0.3,
                               jnp.float32)

    def conv(p):
        return {n: to_tensor(np.asarray(a), "cpu") for n, a in p.items()}
    return jtm, jcm, tr.TimeMix(conv(jtm)), tr.ChannelMix(conv(jcm))


def _x(cfg, shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)
    return jnp.asarray(x, cfg.param_dtype), \
        torch.tensor(x).to(getattr(torch, cfg.param_dtype))


def test_init_matches_reference_layout():
    cfg, tcfg = _cfgs("bfloat16")
    jtm, jcm, _, _ = _params(cfg)
    gen = torch.Generator().manual_seed(0)
    for j, t in ((jtm, tr.init_time_mix(tcfg, gen, "cpu")),
                 (jcm, tr.init_channel_mix(tcfg, gen, "cpu"))):
        got = {n: (tuple(a.shape), str(a.dtype).split(".")[1])
               for n, a in t.named_parameters()}
        assert got == {n: (a.shape, str(a.dtype)) for n, a in j.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads(dtype):
    cfg, _ = _cfgs(dtype)
    rng = np.random.default_rng(6)
    scale = (1 + rng.standard_normal(64) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.3).astype(np.float32)
    jx, tx = _x(cfg, (2, 8, 64), 7, scale=3.0)
    j = jm.group_norm_heads(jx, jnp.asarray(scale), jnp.asarray(bias), 4)
    t = tm.group_norm_heads(tx, torch.tensor(scale), torch.tensor(bias), 4)
    assert t.dtype == tx.dtype
    _close(t, j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projections_match_jax(dtype):
    cfg, _ = _cfgs(dtype)
    jtm, _, ttm, _ = _params(cfg)
    jx, tx = _x(cfg, (2, 16, cfg.d_model), 8)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    jout = jr._projections(jtm, jx, jr._shifted(jx, None), H, hd)
    tout = tr._projections(ttm, tx, tr._shifted(tx, None), H, hd)
    for name, t, j in zip(("r", "k", "v", "g", "logw"), tout, jout):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).split(".")[1] == str(j.dtype), name
        _close(t, j, TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_seq_matches_wkv_chunked(dtype):
    """Output, final state and last input as the reference model's chunked
    path returns them."""
    cfg, tcfg = _cfgs(dtype)
    jtm, _, ttm, _ = _params(cfg, seed=1)
    jx, tx = _x(cfg, (2, 48, cfg.d_model), 9, scale=0.5)
    jo, jst, jlast = jr.wkv_chunked(jtm, jx, cfg)
    to, tst, tlast = tr.time_mix_seq(ttm, tx, tcfg)
    assert to.dtype == tx.dtype and tst.dtype == torch.float32
    _close(to, jo, TOL[dtype], "out")
    _close(tst, jst, TOL[dtype], "state")
    _close(tlast, jlast, 0.0, "x_last")


def test_time_mix_seq_matches_wkv_scan():
    """Twin of the reference's test_wkv6_wrapper_matches_model_path: the
    wrapper's path against the exact sequential oracle."""
    cfg, tcfg = _cfgs("float32")
    jtm, _, ttm, _ = _params(cfg, seed=2)
    jx, tx = _x(cfg, (2, 64, cfg.d_model), 10, scale=0.5)
    jo, jst, _ = jr.wkv_scan(jtm, jx, cfg)
    to, tst, _ = tr.time_mix_seq(ttm, tx, tcfg)
    _close(to, jo, SCAN_TOL, "out")
    _close(tst, jst, SCAN_TOL, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_decode_matches_jax(dtype):
    """8 decode steps from a prefill's state: the port's cache is updated in
    place and must track the reference's returned state and tm_x."""
    cfg, tcfg = _cfgs(dtype)
    jtm, _, ttm, _ = _params(cfg, seed=3)
    jx, tx = _x(cfg, (2, 32, cfg.d_model), 11, scale=0.5)
    _, jst, jlast = jr.wkv_chunked(jtm, jx, cfg)
    _, tst, tlast = tr.time_mix_seq(ttm, tx, tcfg)
    jcache = {"state": jst, "tm_x": jlast}
    tcache = {"state": tst, "tm_x": tlast}
    for step in range(8):
        jxs, txs = _x(cfg, (2, 1, cfg.d_model), 20 + step, scale=0.5)
        jo, jcache["state"], jcache["tm_x"] = jr.time_mix_decode(
            jtm, jxs, cfg, jcache)
        to, tcache = tr.time_mix_decode(ttm, txs, tcfg, tcache)
        _close(to, jo, TOL[dtype], f"out at step {step}")
    assert tcache["state"] is tst and tcache["tm_x"] is tlast
    _close(tcache["state"], jcache["state"], TOL[dtype], "state")
    _close(tcache["tm_x"], jcache["tm_x"], 0.0, "tm_x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    cfg, _ = _cfgs(dtype)
    _, jcm, _, tcm = _params(cfg, seed=4)
    jx, tx = _x(cfg, (2, 16, cfg.d_model), 12)
    jo, jlast = jr.channel_mix(jcm, jx)
    to, tlast = tr.channel_mix(tcm, tx)
    _close(to, jo, TOL[dtype], "sequence")
    _close(tlast, jlast, 0.0, "x_last")
    jxs, txs = _x(cfg, (2, 1, cfg.d_model), 13)
    jo, _ = jr.channel_mix(jcm, jxs, jlast)
    to, _ = tr.channel_mix(tcm, txs, tlast)
    _close(to, jo, TOL[dtype], "decode")


def _carry(cfg, seed):
    """A state (B,H,hd,hd) f32 and a previous input (B,D) to start from."""
    rng = np.random.default_rng(seed)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    st = (rng.standard_normal((2, H, hd, hd)) * 0.5).astype(np.float32)
    xp = (rng.standard_normal((2, cfg.d_model)) * 0.5).astype(np.float32)
    return jnp.asarray(st), torch.tensor(st), \
        jnp.asarray(xp, cfg.param_dtype), \
        torch.tensor(xp).to(getattr(torch, cfg.param_dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_seq_with_state0_and_x_prev_matches_wkv_chunked(dtype):
    """The reference's optional ``state0`` and ``x_prev``: the port carries
    the state in outside the kernel, decayed by the cumulative logw."""
    cfg, tcfg = _cfgs(dtype)
    jtm, _, ttm, _ = _params(cfg, seed=4)
    jx, tx = _x(cfg, (2, 48, cfg.d_model), 12, scale=0.5)
    jst0, tst0, jxp, txp = _carry(cfg, 13)
    jo, jst, jlast = jr.wkv_chunked(jtm, jx, cfg, state0=jst0, x_prev=jxp)
    to, tst, tlast = tr.time_mix_seq(ttm, tx, tcfg, state0=tst0, x_prev=txp)
    _close(to, jo, TOL[dtype], "out")
    _close(tst, jst, TOL[dtype], "state")
    _close(tlast, jlast, 0.0, "x_last")


@pytest.mark.parametrize("carry", [False, True])
def test_wkv_scan_matches_reference_wkv_scan(carry):
    """The exact sequential oracle, from zero and from a given state and
    previous input."""
    cfg, tcfg = _cfgs("float32")
    jtm, _, ttm, _ = _params(cfg, seed=5)
    jx, tx = _x(cfg, (2, 40, cfg.d_model), 14, scale=0.5)
    jst0, tst0, jxp, txp = _carry(cfg, 15) if carry else (None,) * 4
    jo, jst, jlast = jr.wkv_scan(jtm, jx, cfg, state0=jst0, x_prev=jxp)
    to, tst, tlast = tr.wkv_scan(ttm, tx, tcfg, state0=tst0, x_prev=txp)
    _close(to, jo, TOL["float32"], "out")
    _close(tst, jst, TOL["float32"], "state")
    _close(tlast, jlast, 0.0, "x_last")
