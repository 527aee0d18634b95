"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX reference.

On the CPU the wrapper runs the plain version; it is held against the Pallas
kernel in interpret mode and against the jnp oracle over the reference's own
sweep (tests/test_kernels.py) at the reference's tolerances: 3e-5 in f32,
2.5e-2 in bf16.  The CUDA kernels are held against the plain version on the
card in tests/test_torch_cuda.py.

The routing rule (``variant``) is checked here, and so are the tensor-core
kernel's numerics: its plain version ``flash_attention_wgmma_ref`` (an
online softmax over 64-position KV tiles, P rounded to bf16 before P·V) is
held against the Pallas kernel in interpret mode and against the jnp oracle
in bf16 at the reference's 2.5e-2, over the reference's sweep and at
gemma3-1b's global and local prefill shapes (cut to BK 1).  The worst case
uses 0.0156 of the 2.5e-2 (one bf16 ulp of an output in [2, 4)), so the
margin is at least 0.0094.
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
    flash_attention, flash_attention_bkg, flash_attention_wgmma_ref, variant)

SWEEP = [
    (2, 256, 4, 64, 0, 0.0),
    (2, 256, 1, 64, 64, 0.0),
    (3, 128, 2, 32, 0, 50.0),
    (1, 512, 6, 128, 128, 30.0),
    (2, 192, 2, 64, 96, 0.0),      # non-pow2 seq
]
# gemma3-1b's prefill attention, one KV head of one prompt of 1024 tokens:
# (BK, S, G, hd, window, softcap) of its global and its local layers
GEMMA3 = [(1, 1024, 4, 256, 0, 0.0), (1, 1024, 4, 256, 512, 0.0)]
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


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.float32, 256, "fma"), (torch.float32, 80, "fma"),
    (torch.float32, 16, "fma"),
    (torch.bfloat16, 48, "fma"),      # a multiple of 16 with no instance
    (torch.bfloat16, 20, "fma"),      # not a multiple of 16
    (torch.bfloat16, 4, "fma"),
])
def test_variant_rule(dtype, hd, want):
    assert variant(dtype, hd) == want


@pytest.mark.parametrize("BK,S,G,hd,win,cap", SWEEP + GEMMA3)
def test_wgmma_numerics_match_pallas_interpret(BK, S, G, hd, win, cap):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((BK, S, G, hd), (BK, S, hd),
                                              "bf16", seed=3)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    _close(flash_attention_wgmma_ref(tq, tk, tv, **kw),
           jbkg(jq, jk, jv, bq=64, bk=64, interpret=True, **kw), tol)


@pytest.mark.parametrize("BK,S,G,hd,win,cap", SWEEP + GEMMA3)
def test_wgmma_numerics_match_jnp_oracle(BK, S, G, hd, win, cap):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((BK, S, G, hd), (BK, S, hd),
                                              "bf16", seed=4)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    _close(flash_attention_wgmma_ref(tq, tk, tv, **kw), jref(jq, jk, jv, **kw),
           tol)


def test_wgmma_numerics_ragged():
    """Sq != Skv, neither a multiple of the 64-position tile, G = 10: the
    emulation's last tile is partial and causality is top-left."""
    (jq, jk, jv), (tq, tk, tv), tol = _inputs((2, 90, 10, 32), (2, 150, 32),
                                              "bf16", seed=5)
    kw = dict(scale=32 ** -0.5, softcap=30.0, window=40)
    _close(flash_attention_wgmma_ref(tq, tk, tv, **kw), jref(jq, jk, jv, **kw),
           tol)


def test_build_log_resources_per_instantiation(monkeypatch):
    """``cuda_lib.resources`` pairs each kernel instantiation in an nvcc
    ``-Xptxas -v`` log with its register and spill lines."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_"
        "wgmma_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiffii'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_"
        "wgmma_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiffii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 211 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_"
        "wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiffii'"
        " for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers",
    ])
    monkeypatch.setattr(cuda_lib, "build_log", lambda name: log)
    got = cuda_lib.resources("flash_attention_wgmma")
    assert [used for _, used, _ in got] == [
        "Used 211 registers, used 1 barriers",
        "Used 122 registers, used 1 barriers"]
    assert got[1][2].startswith("8 bytes stack frame, 4 bytes spill stores")
    assert all("flash_wgmma_kernel" in fn for fn, _, _ in got)
    assert "256" in got[0][0] and "64" in got[1][0]
