"""The port's model (repro_torch.models) against the JAX reference on the
smoke configs of the four dense attention architectures, gemma3-1b first.

Weights are the reference's own: ``repro.models.init_params``, with every
norm given random values (the reference initialises them to zero, which
would leave the ``(1 + scale)`` path untested), converted by
``params_from_jax``.  Inputs are numpy draws.

The JAX model runs with the Pallas flash kernel in interpret mode
(``enable_flash_attention(interpret=True, bq=16, bk=16)``), because the
port's default attention is the flash kernel's function, whose PV product is
f32; the reference's jnp path casts the probabilities to the activation
dtype first and is matched only in f32 (``test_attention_seq_plain_path``).

Tolerances, with reasons:
* f32 params: 2e-4 absolute and relative.  The frameworks sum in different
  orders; over a dozen layers that drifts by ~1e-5 on unit-sized values.
* bf16 params: 5e-2, the tolerance of the reference's own
  test_flash_kernel_plugs_into_model, elementwise on the logits.  The bf16
  cache leaves are held to 5e-2 in relative norm (||t - j|| / ||j||)
  instead: the reference's bf16 gelu rounds its constants and every
  intermediate to bf16 and differs from torch's by one ulp in about 45% of
  elements, and over gemma3's 12 smoke layers that drift takes a few of the
  ~4k elements of the deepest K caches past 5e-2 while the leaf as a whole
  stays within 2e-2.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.weights import params_from_jax, to_tensor  # noqa: E402

ARCHS = ["gemma3-1b", "internlm2-20b", "h2o-danube-1.8b", "gemma2-9b"]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
NORMS = {"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
         "k_norm"}
B, S = 2, 64


def _cfgs(arch, dtype):
    jc = dataclasses.replace(jax_smoke(arch), param_dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(arch), param_dtype=dtype)
    return jc, tc


def _jax_params(cfg, seed=0):
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in NORMS:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.3, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


def _models(arch, dtype, seed=0):
    jc, tc = _cfgs(arch, dtype)
    jp = _jax_params(jc, seed)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _jax_prefill(params, cfg, tokens):
    jax_flash_on(interpret=True, bq=16, bk=16)
    try:
        return jtf.forward_prefill(params, cfg, {"tokens": jnp.asarray(tokens)})
    finally:
        jax_flash_off()


def _torch_leaves(cache):
    out = []
    for part in ("blocks", "tail"):
        for entry in cache[part]:
            out += [entry[name] for name in sorted(entry)]
    return out


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _close_caches(tcache, jcache, tol, normwise=False):
    jl = jax.tree.leaves(jcache)
    tl = _torch_leaves(tcache)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert tuple(t.shape) == j.shape, (i, t.shape, j.shape)
        if normwise:
            t, j = t.float().numpy(), np.asarray(j, np.float32)
            err = np.linalg.norm(t - j) / np.linalg.norm(j)
            assert err <= tol, f"cache leaf {i}: relative error {err}"
        else:
            _close(t, j, tol, f"cache leaf {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype)
    tok = _tokens(tc, (B, S))
    jl, jcache = _jax_prefill(jp, jc, tok)
    tl, tcache = ttf.forward_prefill(tp, tc, {"tokens": torch.tensor(tok)})
    assert tl.dtype == getattr(torch, dtype)
    _close(tl, jl, TOL[dtype], "logits")
    _close_caches(tcache, jcache, TOL[dtype], normwise=dtype == "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_jax(arch):
    jc, tc, jp, tp = _models(arch, "float32", seed=1)
    steps, cache_len = 16, 24
    jcache = jtf.init_cache(jc, B, cache_len, dtype=jnp.float32)
    tcache = ttf.init_cache(tc, B, cache_len, dtype=torch.float32, device="cpu")
    jdec = jax.jit(lambda p, c, t, pos: jtf.forward_decode(p, jc, c, t, pos))
    toks = _tokens(tc, (steps, B, 1), seed=1)
    for pos in range(steps):
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks[pos]), jnp.int32(pos))
        tl, tcache = ttf.forward_decode(tp, tc, tcache, torch.tensor(toks[pos]),
                                        pos)
        _close(tl, jl, TOL["float32"], f"logits at step {pos}")
    _close_caches(tcache, jcache, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_jax(arch):
    """Decoding at pos=S on a prefill cache: the global layers' cache has
    length S, and the reference's clamped write lands in slot S-1."""
    jc, tc, jp, tp = _models(arch, "float32", seed=2)
    tok = _tokens(tc, (B, S), seed=2)
    nxt = _tokens(tc, (B, 1), seed=3)
    _, jcache = _jax_prefill(jp, jc, tok)
    _, tcache = ttf.forward_prefill(tp, tc, {"tokens": torch.tensor(tok)})
    jl, jcache = jtf.forward_decode(jp, jc, jcache, jnp.asarray(nxt),
                                    jnp.int32(S))
    tl, tcache = ttf.forward_decode(tp, tc, tcache, torch.tensor(nxt), S)
    _close(tl, jl, TOL["float32"], "logits")
    _close_caches(tcache, jcache, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_seq_plain_path(arch):
    """The port's plain attention (hook off) against the reference's jnp
    path (hook off), in f32 where the probability cast does nothing."""
    jc, tc = _cfgs(arch, "float32")
    jp = jattn.init_attention(jax.random.PRNGKey(4), jc)
    rng = np.random.default_rng(4)
    if "q_norm" in jp:
        for n in ("q_norm", "k_norm"):
            jp[n] = jnp.asarray(rng.standard_normal(jc.head_dim) * 0.3,
                                jnp.float32)
    tp = tattn.Attention({n: to_tensor(a, "cpu") for n, a in jp.items()})
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    tkernels.disable_flash_attention()
    try:
        for kind in sorted(set(tc.layer_pattern)):
            jo, (jk, jv) = jattn.attention_seq(jp, jnp.asarray(x), jc, kind,
                                               jnp.asarray(pos))
            to, (tk, tv) = tattn.attention_seq(tp, torch.tensor(x), tc, kind,
                                               torch.tensor(pos))
            for t, j, what in ((to, jo, "out"), (tk, jk, "k"), (tv, jv, "v")):
                _close(t, j, TOL["float32"], f"{kind} {what}")
    finally:
        tkernels.enable_flash_attention()
