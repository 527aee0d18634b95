"""Tests of the port that need an NVIDIA card (marked ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  They import no JAX, so that
they run on a card machine that has none:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The flash attention kernel is held against its plain version on the same
inputs: 3e-5 in f32 and 2.5e-2 in bf16, the reference's kernel tolerances
(tests/test_kernels.py), with tf32 off so that the plain f32 version is
full f32.  The model on the card (kernel) is held against the model on the
CPU (plain version) at the port's bf16 model tolerance, 5e-2: logits
elementwise, cache leaves in relative norm (see tests/test_torch_model.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bkg, flash_attention_ref)
from repro_torch.models import forward_prefill, init_params  # noqa: E402

TOL = {torch.float32: 3e-5, torch.bfloat16: 2.5e-2}
MODEL_TOL = 5e-2
# (BK, Sq, Skv, G, hd, window, softcap): tests/test_kernels.py's sweep, then
# the port's head dims and edges
SHAPES = [
    (2, 256, 256, 4, 64, 0, 0.0),
    (2, 256, 256, 1, 64, 64, 0.0),
    (3, 128, 128, 2, 32, 0, 50.0),
    (1, 512, 512, 6, 128, 128, 30.0),
    (2, 192, 192, 2, 64, 96, 0.0),
    (2, 100, 100, 3, 80, 0, 0.0),      # danube head dim, ragged tiles
    (2, 130, 130, 4, 80, 32, 0.0),
    (1, 300, 300, 4, 256, 0, 0.0),     # gemma3 head dim
    (2, 257, 257, 2, 256, 64, 50.0),
    (1, 64, 96, 2, 64, 0, 0.0),        # Sq != Skv: top-left causality
    (1, 64, 64, 2, 16, 0, 0.0),        # smoke-config head dim
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("BK,Sq,Skv,G,hd,win,cap", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, BK, Sq, Skv, G, hd, win, cap,
                              dtype):
    q = _randn((BK, Sq, G, hd), dtype, cuda_device, 0)
    k = _randn((BK, Skv, hd), dtype, cuda_device, 1)
    v = _randn((BK, Skv, hd), dtype, cuda_device, 2)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    before = cuda_lib.launches["flash_attention"]
    o = flash_attention_bkg(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launches["flash_attention"] == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    err = (o.float() - flash_attention_ref(q, k, v, **kw).float()).abs().max()
    assert err.item() <= TOL[dtype]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 16, 1, 16, device=cuda_device)
    k = torch.zeros(1, 16, 16, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_bkg(q.half(), k.half(), k.half(), scale=0.25)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 16, 1, 512, device=cuda_device)
        flash_attention_bkg(big, big[:, :, 0], big[:, :, 0], scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bkg(q.transpose(1, 3), k, k, scale=0.25)


def _leaves(cache):
    return [e[n] for part in ("blocks", "tail") for e in cache[part]
            for n in sorted(e)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b",
                                  "h2o-danube-1.8b", "gemma2-9b"])
def test_prefill_on_card_matches_cpu(cuda_device, arch):
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    cl, ccache = forward_prefill(model, cfg, {"tokens": tok})
    before = cuda_lib.launches["flash_attention"]
    gl, gcache = forward_prefill(model.to(cuda_device), cfg,
                                 {"tokens": tok.to(cuda_device)})
    torch.cuda.synchronize()
    assert cuda_lib.launches["flash_attention"] == before + cfg.n_layers
    np.testing.assert_allclose(gl.float().cpu().numpy(), cl.float().numpy(),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for g, c in zip(_leaves(gcache), _leaves(ccache)):
        g, c = g.float().cpu(), c.float()
        assert (torch.linalg.vector_norm(g - c) /
                torch.linalg.vector_norm(c)).item() <= MODEL_TOL
