"""The port's q-block attention (``repro_torch.models.attention``:
``qk_scores``, ``_sdpa(want_lse=)``, ``_lse_merge``, ``_rect_scan``,
``_causal_packed``, ``_qblock_scan``, ``causal_attention`` and
``attention_seq``'s dispatch) against the reference's
(``repro.models.attention``), on the same numpy inputs, on the CPU.

Each function's values, its logsumexp where it returns one, and the
gradients of its inputs (``jax.vjp`` against ``torch.autograd.grad`` of the
same cotangents) are held in f32 to 1e-5 and in bf16 to the model
tolerance of tests/test_torch_model.py (5e-2).  The masks: causal, causal
with a window (shorter than S - q_block, so the scan slices its keys, and
not), prefix-LM, bidirectional and a per-row (B, Sq, Skv) mask; the
lengths: S <= 2 q_block, S no multiple of q_block, S a multiple of
2 q_block (packable) and not.  ``attention_seq`` with its hook off takes
the reference's branch at each (both modules' functions spied on), and
the flash autograd function's backward (``FlashAttention``) recomputes
through the reference's dispatch at the layer's q block and packing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.weights import to_tensor  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, K, G, HD = 2, 2, 2, 16
QB = 16
SCALE = HD ** -0.5


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(S, dtype, seed=0, Skv=None):
    Skv = Skv or S
    arrs = _arrays([(B, S, K, G, HD), (B, Skv, K, HD), (B, Skv, K, HD)],
                   seed)
    jdt, tdt = DT[dtype]
    return arrs, [jnp.asarray(a, jdt) for a in arrs], \
        [torch.tensor(a).to(tdt) for a in arrs]


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               atol=tol, rtol=tol, err_msg=what)


def _check_vjp(jfn, tfn, jins, tins, cts, tol, what):
    """Outputs of ``jfn``/``tfn`` (a tuple each) and the gradients of their
    inputs for the numpy cotangents ``cts``, one per output."""
    shapes = jax.eval_shape(jfn, *jins)

    @jax.jit
    def fwd_bwd(ins, cts):          # one compiled call: eager JAX is slow
        out, vjp = jax.vjp(jfn, *ins)
        return out, vjp(cts)
    jout, jgrads = fwd_bwd(tuple(jins), tuple(
        jnp.asarray(c, s.dtype) for c, s in zip(cts, shapes)))
    leaves = [t.detach().requires_grad_() for t in tins]
    tout = tfn(*leaves)
    assert len(jout) == len(tout) == len(cts)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.shape == j.shape, (what, i, t.shape, j.shape)
        assert str(t.dtype).split(".")[1] == str(j.dtype), (what, i)
        _close(t, j, tol, f"{what}: output {i}")
    tgrads = torch.autograd.grad(tout, leaves, [
        torch.tensor(c).to(t.dtype) for c, t in zip(cts, tout)])
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        assert str(t.dtype).split(".")[1] == str(j.dtype), (what, i)
        _close(t, j, tol, f"{what}: grad {i}")


def _cts(outs_shapes, seed=9):
    return _arrays(outs_shapes, seed)


# ---------------------------------------------------------------------------
# each function against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_scores(dtype):
    """f32 scores; dq and dk in the operands' dtype."""
    S = 24
    _, jins, tins = _qkv(S, dtype)
    _check_vjp(lambda q, k: (jattn.qk_scores(q, k),),
               lambda q, k: (tattn.qk_scores(q, k),), jins[:2], tins[:2],
               _cts([(B, K, G, S, S)]), TOL[dtype], "qk_scores")


def _mask(mode, S, window=0, prefix=0):
    return np.asarray(jattn.make_mask_fn(mode, window, prefix)(
        jnp.arange(S), jnp.arange(S)))


# (mode, window, prefix_len, mask dims)
SDPA_MASKS = [("causal", 0, 0, 2), ("causal", 8, 0, 2), ("prefix", 0, 5, 2),
              ("bidir", 0, 0, 0), ("causal", 0, 0, 3)]


@pytest.mark.parametrize("mode,window,prefix,ndim", SDPA_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_with_lse(dtype, mode, window, prefix, ndim):
    """``_sdpa(want_lse=True)``: o and the logsumexp of the scores, and
    their gradients; a (B, Sq, Skv) mask drops a different row per batch
    row."""
    S = 24
    _, jins, tins = _qkv(S, dtype, seed=1)
    m = None
    if ndim:
        m = _mask(mode, S, window=window, prefix=prefix)
        if ndim == 3:
            m = np.stack([m, m & (np.arange(S)[None, :] != 3)])
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.tensor(m)
    cap = 20.0 if mode == "prefix" else 0.0

    def jfn(q, k, v):
        return jattn._sdpa(q, k, v, jm, cap, SCALE, want_lse=True)

    def tfn(q, k, v):
        return tattn._sdpa(q, k, v, tm, cap, SCALE, want_lse=True)
    _check_vjp(jfn, tfn, jins, tins, _cts([(B, S, K, G, HD), (B, K, G, S)]),
               TOL[dtype], f"_sdpa {mode}")
    # and without the lse, as attention_seq calls it
    _check_vjp(lambda *a: (jattn._sdpa(*a, jm, cap, SCALE),),
               lambda *a: (tattn._sdpa(*a, tm, cap, SCALE),), jins, tins,
               _cts([(B, S, K, G, HD)]), TOL[dtype], f"_sdpa {mode} o")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_merge(dtype):
    """The merge of two partials: in f32, cast back to o1's dtype."""
    S = 16
    jdt, tdt = DT[dtype]
    arrs = _arrays([(B, S, K, G, HD), (B, K, G, S), (B, S, K, G, HD),
                    (B, K, G, S)], 2)
    jins = [jnp.asarray(a, jdt if i % 2 == 0 else jnp.float32)
            for i, a in enumerate(arrs)]
    tins = [torch.tensor(a).to(tdt if i % 2 == 0 else torch.float32)
            for i, a in enumerate(arrs)]
    _check_vjp(jattn._lse_merge, tattn._lse_merge, jins, tins,
               _cts([(B, S, K, G, HD), (B, K, G, S)]), TOL[dtype],
               "_lse_merge")


@pytest.mark.parametrize("S,Skv", [(64, 64), (48, 32), (16, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_scan(dtype, S, Skv):
    """Unmasked q blocks against all the keys: o and lse."""
    _, jins, tins = _qkv(S, dtype, seed=3, Skv=Skv)
    _check_vjp(lambda *a: jattn._rect_scan(*a, 0.0, SCALE, QB),
               lambda *a: tattn._rect_scan(*a, 0.0, SCALE, QB), jins, tins,
               _cts([(B, S, K, G, HD), (B, K, G, S)]), TOL[dtype],
               "_rect_scan")


@pytest.mark.parametrize("S,cap", [(64, 0.0), (96, 30.0), (32, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_packed(dtype, S, cap):
    """The recursion at leaf 2 q_block: one level (64), two whose halves
    stop short of a q-block multiple (96: 48 -> two leaves of 24), and a
    leaf alone (32)."""
    _, jins, tins = _qkv(S, dtype, seed=4)
    _check_vjp(lambda *a: jattn._causal_packed(*a, cap, SCALE, QB, 2 * QB),
               lambda *a: tattn._causal_packed(*a, cap, SCALE, QB, 2 * QB),
               jins, tins, _cts([(B, S, K, G, HD), (B, K, G, S)]),
               TOL[dtype], "_causal_packed")


# (mode, window, prefix_len, S): windows shorter than S - q_block (the
# scan slices qb + window keys) and not
QBLOCK_CASES = [("causal", 0, 0, 64), ("causal", 8, 0, 64),
                ("causal", 40, 0, 64), ("causal", 16, 0, 48),
                ("prefix", 0, 20, 64), ("prefix", 8, 5, 48)]


@pytest.mark.parametrize("mode,window,prefix,S", QBLOCK_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qblock_scan(dtype, mode, window, prefix, S):
    _, jins, tins = _qkv(S, dtype, seed=5)
    jm = jattn.make_mask_fn(mode, window, prefix)
    tm = tattn.make_mask_fn(mode, window, prefix)
    _check_vjp(lambda *a: (jattn._qblock_scan(*a, jm, 0.0, SCALE, QB,
                                              window),),
               lambda *a: (tattn._qblock_scan(*a, tm, 0.0, SCALE, QB,
                                              window),),
               jins, tins, _cts([(B, S, K, G, HD)]), TOL[dtype],
               f"_qblock_scan {mode} window {window}")


def _ref_causal(q, k, v, *, window, softcap, scale, qb, pack):
    """The reference's ``attention_seq`` dispatch for a causal mask with
    its hook off, on q, k, v (positions 0..S-1)."""
    S = q.shape[1]
    if S <= 2 * qb or S % qb:
        mask = jattn.make_mask_fn("causal", window)(jnp.arange(S),
                                                    jnp.arange(S))
        return jattn._sdpa(q, k, v, mask, softcap, scale)
    if not window and S % (2 * qb) == 0 and pack:
        return jattn._causal_packed(q, k, v, softcap, scale, qb, 2 * qb)[0]
    return jattn._qblock_scan(q, k, v, jattn.make_mask_fn("causal", window),
                              softcap, scale, qb, window)


# (S, window, pack): S <= 2 qb, S % qb != 0, packable, unpackable
# (48 % 32), packing off, windows sliced and not
CAUSAL_CASES = [(32, 0, True), (40, 0, True), (64, 0, True), (48, 0, True),
                (64, 0, False), (64, 8, True), (64, 40, True)]


@pytest.mark.parametrize("S,window,pack", CAUSAL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_and_the_flash_backward(dtype, S, window, pack):
    """``causal_attention`` against the reference's dispatch, and
    ``FlashAttention`` (forward: the kernel's plain version on the CPU;
    backward: recomputed through ``causal_attention``) whose gradients are
    the reference's dispatch's."""
    _, jins, tins = _qkv(S, dtype, seed=6)
    kw = dict(window=window, softcap=0.0, scale=SCALE)

    def jfn(q, k, v):
        return (_ref_causal(q, k, v, qb=QB, pack=pack, **kw),)
    _check_vjp(jfn, lambda *a: (tattn.causal_attention(
        *a, q_block=QB, pack=pack, **kw),), jins, tins,
        _cts([(B, S, K, G, HD)]), TOL[dtype], "causal_attention")
    # the flash function's forward is f32 PV (the kernels'); its backward
    # is the dispatch's, whose p is cast to v's dtype: equal in f32
    ftol = TOL[dtype]
    _check_vjp(jfn, lambda *a: (FlashAttention.apply(
        *a, window, 0.0, SCALE, True, 0, QB, pack),), jins, tins,
        _cts([(B, S, K, G, HD)]), ftol, "FlashAttention")


def test_flash_backward_recomputes_through_the_dispatch(monkeypatch):
    """The backward calls the q-block scan (64 rows, window 8), the packed
    recursion (64, no window) or ``_sdpa`` of the rows at ``q0`` > 0,
    never ``plain_attention``'s whole square where the dispatch scans."""
    calls = []
    for name in ("_qblock_scan", "_causal_packed", "plain_attention"):
        fn = getattr(tattn, name)

        def spy(*a, _name=name, _fn=fn, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tattn, name, spy)
    for S, window, q0, want in ((64, 8, 0, "_qblock_scan"),
                                (64, 0, 0, "_causal_packed"),
                                (16, 0, 48, "plain_attention")):
        _, _, (q, k, v) = _qkv(S, "float32", seed=7, Skv=q0 + S)
        q.requires_grad_()
        o = FlashAttention.apply(q, k, v, window, 0.0, SCALE, True, q0, QB,
                                 True)
        calls.clear()
        o.sum().backward()
        assert calls[:1] == [want], (S, window, q0, calls)


# ---------------------------------------------------------------------------
# attention_seq's dispatch
# ---------------------------------------------------------------------------
BRANCHES = ("_sdpa", "_rect_scan", "_causal_packed", "_qblock_scan")
# (arch, kind, mask_mode, S, attn_causal_pack, cross): every branch
DISPATCH = [
    ("internlm2-20b", "global", "causal", 32, "auto", False),   # S <= 2 qb
    ("internlm2-20b", "global", "causal", 40, "auto", False),   # S % qb
    ("internlm2-20b", "global", "causal", 64, "auto", False),   # packed
    ("internlm2-20b", "global", "causal", 64, "on", False),
    ("internlm2-20b", "global", "causal", 64, "off", False),    # q blocks
    ("internlm2-20b", "global", "causal", 48, "auto", False),   # 48 % 32
    ("gemma3-1b", "local", "causal", 64, "auto", False),        # window 32
    ("gemma2-9b", "local", "causal", 64, "auto", False),        # softcap
    ("paligemma-3b", "global", "prefix", 64, "auto", False),
    ("paligemma-3b", "global", "prefix", 32, "auto", False),
    ("whisper-small", "global", "bidir", 64, "auto", False),
    ("whisper-small", "global", "causal", 64, "auto", True),    # cross
]


def _spy(monkeypatch, mod, calls):
    for name in BRANCHES:
        fn = getattr(mod, name)

        def spy(*a, _name=name, _fn=fn, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("arch,kind,mode,S,pack,cross", DISPATCH)
def test_attention_seq_takes_the_reference_branch(monkeypatch, arch, kind,
                                                  mode, S, pack, cross):
    """``attention_seq`` with the hook off (both packages) on the same
    weights and input: the first q-block function each calls is the same,
    and the outputs and k, v agree to 1e-5 (f32)."""
    jc, tc = (dataclasses.replace(f(arch), param_dtype="float32",
                                  attn_causal_pack=pack)
              for f in (jax_smoke, get_smoke_config))
    jp = jattn.init_attention(jax.random.PRNGKey(3), jc, cross=cross)
    tp = tattn.Attention({n: to_tensor(a, "cpu") for n, a in jp.items()})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(mask_mode=mode, prefix_len=20 if mode == "prefix" else 0)
    jkw, tkw = dict(kw), dict(kw)
    if cross:
        enc = rng.standard_normal((B, 24, jc.d_model)).astype(np.float32)
        epos = np.broadcast_to(np.arange(24), (B, 24)).astype(np.int32)
        jkw["kv_override"] = (jnp.asarray(enc), jnp.asarray(epos))
        tkw["kv_override"] = (torch.tensor(enc), torch.tensor(epos))
    jcalls, tcalls = [], []
    _spy(monkeypatch, jattn, jcalls)
    _spy(monkeypatch, tattn, tcalls)
    tkernels.disable_flash_attention()
    try:
        jo, (jk, jv) = jattn.attention_seq(jp, jnp.asarray(x), jc, kind,
                                           jnp.asarray(pos), **jkw)
        to, (tk, tv) = tattn.attention_seq(tp, torch.tensor(x), tc, kind,
                                           torch.tensor(pos), **tkw)
    finally:
        tkernels.enable_flash_attention()
    assert jcalls and tcalls[:1] == jcalls[:1], (tcalls, jcalls)
    for t, j, what in ((to, jo, "out"), (tk, jk, "k"), (tv, jv, "v")):
        _close(t, j, 1e-5, what)


def test_pack_ok_follows_the_config_and_the_model_axis():
    """``"on"``/``"off"`` as written; ``"auto"`` is ``n_heads % tp == 0``
    with ``tp`` the active rules' ``model`` size, 1 without rules."""
    from repro_torch.distributed.context import ShardingRules, use_rules
    from repro_torch.launch.mesh import AbstractMesh
    cfg = get_smoke_config("internlm2-20b")          # 4 heads
    assert tattn.pack_ok(dataclasses.replace(cfg, attn_causal_pack="on"))
    assert not tattn.pack_ok(dataclasses.replace(cfg,
                                                 attn_causal_pack="off"))
    assert tattn.pack_ok(cfg)
    for tp, want in ((4, True), (16, False)):
        with use_rules(ShardingRules(AbstractMesh(("data", "model"),
                                                  (2, tp)), {})):
            assert tattn.pack_ok(cfg) == want
