"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX reference.

On the CPU the wrapper runs the plain version; it is held against the Pallas
kernel in interpret mode and against the jnp oracle over the reference's own
sweep (tests/test_kernels.py) at the reference's tolerances: 3e-5 in f32,
2.5e-2 in bf16.  The CUDA kernel is held against the plain version on the
card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_bkg as jbkg  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jref  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bkg)

SWEEP = [
    (2, 256, 4, 64, 0, 0.0),
    (2, 256, 1, 64, 64, 0.0),
    (3, 128, 2, 32, 0, 50.0),
    (1, 512, 6, 128, 128, 30.0),
    (2, 192, 2, 64, 96, 0.0),      # non-pow2 seq
]
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.5e-2)}


def _inputs(shape_q, shape_kv, dt, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jdt, tdt, tol = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs], tol)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol)


@pytest.mark.parametrize("BK,S,G,hd,win,cap", SWEEP)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_matches_pallas_interpret(BK, S, G, hd, win, cap, dt):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((BK, S, G, hd), (BK, S, hd), dt)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    _close(flash_attention_bkg(tq, tk, tv, **kw),
           jbkg(jq, jk, jv, bq=64, bk=64, interpret=True, **kw), tol)


@pytest.mark.parametrize("BK,S,G,hd,win,cap", SWEEP)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_matches_jnp_oracle(BK, S, G, hd, win, cap, dt):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((BK, S, G, hd), (BK, S, hd), dt,
                                              seed=1)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    _close(flash_attention_bkg(tq, tk, tv, **kw), jref(jq, jk, jv, **kw), tol)


@pytest.mark.parametrize("window", [0, 48])
def test_gqa_wrapper_matches_reference(window):
    B, S, K, G, hd = 2, 128, 2, 3, 32
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((B, S, K, G, hd), (B, S, K, hd),
                                              "f32", seed=2)
    o = flash_attention(tq, tk, tv, scale=hd ** -0.5, window=window)
    assert o.shape == (B, S, K, G, hd)
    _close(o, jops.flash_attention(jq, jk, jv, scale=hd ** -0.5, window=window,
                                   bq=64, bk=64, interpret=True), tol)


def test_cpu_route_launches_nothing():
    before = cuda_lib.launches["flash_attention"]
    q = torch.zeros(1, 16, 1, 16)
    k = torch.zeros(1, 16, 16)
    flash_attention_bkg(q, k, k, scale=0.25)
    assert cuda_lib.launches["flash_attention"] == before


def test_other_devices_raise():
    q = torch.zeros(1, 16, 1, 16, device="meta")
    k = torch.zeros(1, 16, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bkg(q, k, k, scale=0.25)
