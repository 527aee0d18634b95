"""Tests of the port that need an NVIDIA card (marked ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  They import no JAX, so that
they run on a card machine that has none:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs, at the
reference's kernel tolerances (tests/test_kernels.py): flash attention 3e-5
in f32 and 2.5e-2 in bf16 (every bf16 case goes through the tensor-core
kernel and every f32 case through the CUDA-core one, which the per-variant
launch counts show), the RG-LRU scan 2e-5, the wkv6 1e-3 (its output and
its final state), with tf32 off so that the plain f32 versions are full
f32; the scan and the wkv6 are held against their plain versions run in
f64.  The RG-LRU scan and the wkv6 each have two kernels, both held: the
wrapper's route (the channel-group scan, the tensor-core wkv6 in 3xTF32)
and the earlier design kept beside it, each with its own launch counter.
Each runs over the reference's sweep, then ragged shapes, then the shapes
of the serving path at full width.  The model on the card (kernel) is held
against the model on the CPU (plain version) at the port's bf16 model
tolerance, 5e-2: logits elementwise, cache leaves in relative norm (see
tests/test_torch_model.py).  Each flood-workflow body on the card is held
against the same body on the CPU, on the same payload and weights: the keep
mask exactly, tensors to 1e-5 (cuDNN sums in another order; tf32 off), the
alarm score to 1e-4; again with cuDNN's TF32 left at PyTorch's default, which
the bodies override for their own convolutions, and through ``launch.flood``
end to end with the engine's clock stepped.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bkg, flash_attention_ref, variant)
from repro_torch.kernels.rglru_scan import rglru_scan_bsc, rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan_thread  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6_bh, wkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk.ops import wkv6_seq  # noqa: E402
from repro_torch.models import forward_prefill, init_params  # noqa: E402
from repro_torch.serverless import workflow as wf  # noqa: E402

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
    (4, 1024, 1024, 10, 256, 2048, 0.0),   # recurrentgemma-2b's local layer
    # ragged at hd 256 and G 10: Sq*G not a multiple of the 128-row tile,
    # Skv not a multiple of the 64-position KV tile
    (2, 77, 77, 10, 256, 0, 0.0),
    (1, 201, 201, 10, 256, 50, 0.0),
    (2, 90, 150, 10, 256, 0, 30.0),
    # BK >= 2 with the last row tile of every BK row partial (a row box
    # past Sq*G must read zeros, not the next BK row)
    (3, 100, 100, 1, 128, 0, 0.0),
]
# (B, S, C, a near 1): test_rglru_kernel's sweep, ragged shapes (C % 4 != 0
# and the last channel group short of 80, C % 4 == 0 and a last group of 4),
# a near 1 (slow decay: |h| grows to ~sqrt(S)), recurrentgemma-2b's prefill
# (4 prompts of 1024, d_rnn 2560), also with a near 1
RGLRU_SHAPES = [(2, 256, 128, False), (1, 128, 512, False),
                (3, 64, 96, False), (2, 37, 70, False), (4, 100, 2562, False),
                (3, 50, 2564, True), (2, 256, 128, True),
                (4, 1024, 2560, False), (4, 1024, 2560, True)]
# (BH, S, hd, logw value or None): test_wkv6_kernel's sweep, a ragged
# length, the edges (S = 1; logw all -5, all -1e-4, all -40: far below the
# model's clamp, 640 nats a chunk), rwkv6-7b's prefill (4
# prompts of 1024, 64 heads of 64)
WKV6_SHAPES = [(2, 128, 32, None), (4, 256, 64, None), (1, 64, 16, None),
               (2, 96, 32, None), (3, 37, 64, None), (3, 1, 64, None),
               (2, 33, 16, -1e-4), (4, 512, 64, -5.0), (4, 1024, 64, -1e-4),
               (2, 64, 32, -40.0),
               (256, 1024, 64, None)]
# the kernel counters a prefill must move, by the layer kinds that launch
# them (the earlier recurrent designs by none)
KINDS = {"flash_attention": ("global", "local"), "rglru_scan": ("rglru",),
         "rglru_scan:grouped": ("rglru",), "rglru_scan:thread": (),
         "wkv6": ("rwkv",), "wkv6:chunk": ("rwkv",), "wkv6:seq": ()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    which = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert variant(dtype, hd) == which
    before = dict(cuda_lib.launches)
    o = flash_attention_bkg(q, k, v, **kw)
    torch.cuda.synchronize()
    for name, n in (("flash_attention", 1), ("flash_attention:wgmma",
                                             which == "wgmma"),
                    ("flash_attention:fma", which == "fma")):
        assert cuda_lib.launches[name] == before.get(name, 0) + n, name
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,near_one", RGLRU_SHAPES)
def test_rglru_kernel_matches_plain(cuda_device, B, S, C, near_one):
    """The channel-group kernel (the wrapper's route) and the earlier
    one-thread-per-channel kernel, each against the plain version run in
    f64 (in f32 its own rounding drifts past 2e-5 where a is near 1)."""
    x = _randn((B, S, C), torch.float32, cuda_device, 0)
    a = 1 - torch.sigmoid(x) * 1e-3 if near_one else torch.sigmoid(x)
    b = _randn((B, S, C), torch.float32, cuda_device, 1)
    before = dict(cuda_lib.launches)
    h, h_thread = rglru_scan_bsc(a, b), rglru_scan_thread(a, b)
    torch.cuda.synchronize()
    for name, n in (("rglru_scan", 2), ("rglru_scan:grouped", 1),
                    ("rglru_scan:thread", 1)):
        assert cuda_lib.launches[name] == before.get(name, 0) + n, name
    assert h.dtype == torch.float32 and h.shape == a.shape
    ref = rglru_scan_ref(a.double(), b.double())
    for got in (h, h_thread):
        torch.testing.assert_close(got.double(), ref, atol=2e-5, rtol=2e-5)
        # both carry h in f64 and round it once, where it is stored: within
        # f32's unit roundoff of the recurrence (the f64 plain version's own
        # error is ~1e-13)
        assert ((got.double() - ref).abs()
                <= 2.0 ** -24 * ref.abs() + 1e-9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,hd,logw_value", WKV6_SHAPES)
def test_wkv6_kernel_matches_plain(cuda_device, BH, S, hd, logw_value):
    """The tensor-core kernel (the wrapper's route) and the earlier
    sequential kernel, each against the plain version run in f64: y and
    final state."""
    r, k, v = (_randn((BH, S, hd), torch.float32, cuda_device, i)
               for i in range(3))
    logw = torch.clamp(-torch.exp(
        _randn((BH, S, hd), torch.float32, cuda_device, 3) * 0.5), -5.0, -1e-4)
    if logw_value is not None:
        logw = torch.full_like(logw, logw_value)
    u = _randn((BH, hd), torch.float32, cuda_device, 4) * 0.1
    before = dict(cuda_lib.launches)
    y, st = wkv6_bh(r, k, v, logw, u)
    y_seq, st_seq = wkv6_seq(r, k, v, logw, u)
    torch.cuda.synchronize()
    for name, n in (("wkv6", 2), ("wkv6:chunk", 1), ("wkv6:seq", 1)):
        assert cuda_lib.launches[name] == before.get(name, 0) + n, name
    assert y.shape == r.shape and st.shape == (BH, hd, hd)
    # the plain version in f64: in f32 its own rounding, added to a kernel's,
    # passes 1e-3 where y crosses 0 after 1024 steps of slow decay
    y_ref, st_ref = wkv6_ref(*(t.double() for t in (r, k, v, logw, u)))
    for got, want in ((y, y_ref), (st, st_ref), (y_seq, y_ref),
                      (st_seq, st_ref)):
        torch.testing.assert_close(got.double(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_recurrent_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(2, 16, 8, device=cuda_device)
    with pytest.raises(TypeError):
        rglru_scan_bsc(a.bfloat16(), a.bfloat16())
    strided = a.transpose(1, 2).contiguous().transpose(1, 2)    # same shape
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_bsc(strided, a)
    x = torch.zeros(2, 16, 32, device=cuda_device)
    u = torch.zeros(2, 32, device=cuda_device)
    with pytest.raises(TypeError):
        wkv6_bh(x.bfloat16(), x, x, x, u)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)    # same shape
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_bh(strided, x, x, x, u)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(2, 16, 48, device=cuda_device)
        wkv6_bh(big, big, big, big, torch.zeros(2, 48, device=cuda_device))


def _leaves(cache):
    return [e[n] for part in ("blocks", "tail") for e in cache[part]
            for n in sorted(e)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b",
                                  "h2o-danube-1.8b", "gemma2-9b",
                                  "recurrentgemma-2b", "rwkv6-7b"])
def test_prefill_on_card_matches_cpu(cuda_device, arch):
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    cl, ccache = forward_prefill(model, cfg, {"tokens": tok})
    before = dict(cuda_lib.launches)
    gl, gcache = forward_prefill(model.to(cuda_device), cfg,
                                 {"tokens": tok.to(cuda_device)})
    torch.cuda.synchronize()
    for name, kinds in KINDS.items():
        want = sum(kind in kinds for kind in cfg.layer_kinds())
        assert cuda_lib.launches[name] - before.get(name, 0) == want, name
    np.testing.assert_allclose(gl.float().cpu().numpy(), cl.float().numpy(),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for g, c in zip(_leaves(gcache), _leaves(ccache)):
        g, c = g.float().cpu(), c.float()
        assert (torch.linalg.vector_norm(g - c) /
                torch.linalg.vector_norm(c)).item() <= MODEL_TOL


def _flood_inputs():
    """Each body's input (the CPU chain's outputs, at 10 MB: 2441 frames)."""
    payload = wf.make_payload(10e6, device="cpu")
    w = wf.flood_weights("cpu")
    ingested = wf.ingest_fn(payload)
    detected = wf.detect_fn(ingested, w)
    mapped = wf.map_fn(detected, w)
    return {"ingest": payload, "detect": ingested, "map": detected,
            "alarm": mapped}


def _same_as_cpu(got, want):
    """A flood body's card output against its CPU output: the keep mask
    exactly, tensors to 1e-5, the score to 1e-4, every tensor on the card."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w):
            assert type(g) is type(w)
            assert g == w if isinstance(w, bool) else abs(g - w) <= 1e-4, k
            continue
        assert g.device.type == "cuda" and g.shape == w.shape, k
        if w.dtype == torch.bool:
            assert torch.equal(g.cpu(), w), k
        else:
            torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-5)


def _run_body(body, inp, device):
    fn = {"ingest": wf.ingest_fn, "detect": wf.detect_fn, "map": wf.map_fn,
          "alarm": wf.alarm_fn}[body]
    args = (wf.flood_weights(device),) if body in ("detect", "map") else ()
    return fn({k: v.to(device) for k, v in inp.items()}, *args)


@pytest.fixture
def torch_default_tf32():
    """A CUDA device with cuDNN's TF32 at PyTorch's default (allowed), as in
    a process that never touches the flag; the caller's setting comes back
    after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = before


class _StepClock:
    """The engine's clock, stepped by a fixed amount at each reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.125
        return self.t


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["ingest", "detect", "map", "alarm"])
def test_flood_body_on_card_matches_cpu(cuda_device, body):
    inp = _flood_inputs()[body]
    want = _run_body(body, inp, "cpu")
    got = _run_body(body, inp, cuda_device)
    torch.cuda.synchronize()
    _same_as_cpu(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["ingest", "detect", "map", "alarm"])
def test_flood_body_at_torch_default_tf32_matches_cpu(torch_default_tf32,
                                                      body):
    """The bodies pin their convolutions to f32 themselves."""
    inp = _flood_inputs()[body]
    want = _run_body(body, inp, "cpu")
    got = _run_body(body, inp, torch_default_tf32)
    torch.cuda.synchronize()
    _same_as_cpu(got, want)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
def test_launch_flood_at_torch_default_tf32_matches_cpu(torch_default_tf32,
                                                        monkeypatch):
    """``launch.flood`` on the card and on the CPU, the engine's clock
    stepped: identical metrics, and each body's output the same."""
    from repro_torch.launch import flood
    from repro_torch.serverless import engine as engine_mod

    outputs = {"cpu": {}, "cuda": {}}
    where = ["cpu"]
    for name in ("ingest_fn", "detect_fn", "map_fn", "alarm_fn"):
        def record(*args, body=getattr(wf, name), name=name):
            out = body(*args)
            outputs[where[0]][name] = out
            return out
        monkeypatch.setattr(wf, name, record)
    metrics = {}
    for where[0] in ("cpu", "cuda"):
        monkeypatch.setattr(engine_mod, "_time", _StepClock())
        metrics[where[0]] = dataclasses.asdict(
            flood.main(["--device", where[0]]))
    assert metrics["cuda"] == metrics["cpu"]
    assert sorted(outputs["cuda"]) == sorted(outputs["cpu"]) == \
        ["alarm_fn", "detect_fn", "ingest_fn", "map_fn"]
    for name, want in outputs["cpu"].items():
        _same_as_cpu(outputs["cuda"][name], want)
    assert torch.backends.cudnn.allow_tf32
