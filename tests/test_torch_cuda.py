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
end to end with the engine's clock stepped.  Adafactor's chunked two-pass
update on the card is held against the CPU (1e-5), and ``moe_layer`` under
sharding rules on one NCCL rank against ``moe_dense`` (bit for bit).
``_softmax_backward_data``'s peak memory on the card equals the one
``OpTrace`` counts on meta, at three shapes, in f32 and bf16, for a
contiguous and a strided gradient.
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
from repro_torch.models.io import make_batch  # noqa: E402
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
    # the MoE and encoder-decoder paths: qwen3-moe (G 16 at hd 128), arctic
    # (G 7: 128-row tiles that split a position's heads), whisper's decoder
    # (G 1 at hd 64, 256 positions), at their prefill shapes and ragged
    (16, 1024, 1024, 16, 128, 0, 0.0),
    (32, 1024, 1024, 7, 128, 0, 0.0),
    (48, 256, 256, 1, 64, 0, 0.0),
    (2, 100, 100, 16, 128, 0, 0.0),
    (3, 77, 77, 7, 128, 0, 0.0),
    (2, 201, 201, 1, 64, 0, 0.0),
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


# (BK, S, G, hd, window): Sq = S / 4 rows at a q-row offset q0 in {S/4,
# S/2, 3S/4} against S keys (a rank's block on flash's q-rows route)
Q0_SHAPES = [(2, 512, 2, 64, 0), (2, 512, 4, 64, 96), (1, 512, 3, 128, 0),
             (1, 512, 4, 128, 200), (1, 512, 2, 256, 0),
             (1, 512, 2, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("BK,S,G,hd,win", Q0_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_a_row_offset_matches_plain(cuda_device, BK, S, G, hd, win,
                                              dtype):
    """Both kernels (f32: the CUDA-core one; bf16: the tensor-core one at hd
    64, 128, 256) with q's rows at q0 against their plain versions at the
    same q0, at flash's tolerances."""
    from repro_torch.kernels.flash_attention import flash_attention_wgmma_ref
    k = _randn((BK, S, hd), dtype, cuda_device, 1)
    v = _randn((BK, S, hd), dtype, cuda_device, 2)
    for i, q0 in enumerate((S // 4, S // 2, 3 * S // 4)):
        q = _randn((BK, S // 4, G, hd), dtype, cuda_device, 10 + i)
        kw = dict(scale=hd ** -0.5, window=win, q0=q0)
        o = flash_attention_bkg(q, k, v, **kw)
        torch.cuda.synchronize()
        assert o.dtype == dtype and o.shape == q.shape
        err = (o.float() - flash_attention_ref(q, k, v, **kw).float()).abs()
        assert err.max().item() <= TOL[dtype], q0
        if dtype == torch.bfloat16:
            emu = flash_attention_wgmma_ref(q, k, v, **kw)
            assert (o.float() - emu.float()).abs().max().item() <= \
                TOL[dtype], q0


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
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "qwen3-moe-235b-a22b", "arctic-480b",
                                  "whisper-small", "paligemma-3b"])
def test_prefill_on_card_matches_cpu(cuda_device, arch):
    """The MoE archs in f32: in bf16 a router's near-tie, moved by rounding,
    picks another expert for a token (tests/test_torch_moe.py).  Flash runs
    on causal self-attention only: whisper's decoder, not its encoder or
    cross-attention; not paligemma's prefix-LM mask."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, param_dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, torch.Generator().manual_seed(0), 2, 64)
    cl, ccache = forward_prefill(model, cfg, batch)
    before = dict(cuda_lib.launches)
    gl, gcache = forward_prefill(model.to(cuda_device), cfg,
                                 {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    for name, kinds in KINDS.items():
        want = sum(kind in kinds for kind in cfg.layer_kinds())
        if name == "flash_attention" and cfg.frontend == "vision":
            want = 0
        assert cuda_lib.launches[name] - before.get(name, 0) == want, name
    np.testing.assert_allclose(gl.float().cpu().numpy(), cl.float().numpy(),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for g, c in zip(_leaves(gcache), _leaves(ccache)):
        g, c = g.float().cpu(), c.float()
        assert (torch.linalg.vector_norm(g - c) /
                torch.linalg.vector_norm(c)).item() <= MODEL_TOL


def _flood_inputs():
    """Each body's input (the CPU chain's outputs, at 10 MB: 2441 frames)."""
    payload = wf.make_payload(10e6)
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
    return fn({k: torch.as_tensor(v).to(device) for k, v in inp.items()},
              *args)


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


# ---------------------------------------------------------------------------
# training: the kernels' autograd functions and a train step on the card
# ---------------------------------------------------------------------------
ARCHS = ["gemma3-1b", "internlm2-20b", "h2o-danube-1.8b", "gemma2-9b",
         "recurrentgemma-2b", "rwkv6-7b"]
# (B, S, K, G, hd, window, softcap) in the model's layout: the danube head
# dim with a window, the smoke head dim with a softcap, recurrentgemma's G
FLASH_GRAD_SHAPES = [(2, 128, 2, 2, 64, 0, 0.0), (1, 100, 2, 4, 80, 32, 0.0),
                     (2, 64, 1, 4, 16, 0, 50.0), (1, 77, 1, 10, 256, 50, 0.0)]


def _grads(fn, inputs, cotangents):
    """Autograd of fn at detached copies of ``inputs`` against cotangents."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return out, torch.autograd.grad(out, leaves, cotangents)


def _assert_grads_close(got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,G,hd,win,cap", FLASH_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_grads_match_plain(cuda_device, B, S, K, G,
                                                    hd, win, cap, dtype):
    """The forward launches the kernel once; the grads are autograd of the
    eager attention the reference trains through."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import plain_attention
    kw = dict(window=win, softcap=cap, scale=hd ** -0.5)
    ins = (_randn((B, S, K, G, hd), dtype, cuda_device, 0),
           _randn((B, S, K, hd), dtype, cuda_device, 1),
           _randn((B, S, K, hd), dtype, cuda_device, 2))
    go = (_randn((B, S, K, G, hd), dtype, cuda_device, 3),)
    before = cuda_lib.launches["flash_attention"]
    (o,), got = _grads(lambda *t: flash_attention(*t, q_block=512, pack=True, **kw), ins,
                        go)
    assert cuda_lib.launches["flash_attention"] == before + 1
    assert o.grad_fn is not None
    (ref,), want = _grads(lambda *t: plain_attention(*t, **kw), ins, go)
    torch.testing.assert_close(o.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _assert_grads_close(got, want, TOL[dtype])


# (S, window, q0, q_block): the backward's dispatch packs (S 256, no
# window), scans q blocks (a window) or takes the rows at q0 as one
# rectangle
FLASH_DISPATCH = [(256, 0, 0, 64), (256, 48, 0, 64), (192, 0, 0, 64),
                  (64, 0, 192, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,win,q0,qb", FLASH_DISPATCH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_through_the_dispatch(cuda_device, S, win, q0, qb,
                                             dtype):
    """The autograd function's backward recomputes through the reference's
    q-block dispatch (``causal_attention`` at ``q_block``, packing on); its
    output and gradients equal the whole-square eager attention's: at q0
    > 0, of q0 + S rows (the first q0 fixed) with the last S sliced out of
    its output, so no row offset is on that side."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import plain_attention
    kw = dict(window=win, scale=64 ** -0.5)
    ins = (_randn((2, S, 1, 4, 64), dtype, cuda_device, 0),
           _randn((2, q0 + S, 1, 64), dtype, cuda_device, 1),
           _randn((2, q0 + S, 1, 64), dtype, cuda_device, 2))
    go = (_randn((2, S, 1, 4, 64), dtype, cuda_device, 3),)
    head = _randn((2, q0, 1, 4, 64), dtype, cuda_device, 4)
    before = cuda_lib.launches["flash_attention"]
    (o,), got = _grads(lambda *t: flash_attention(*t, q0=q0, q_block=qb,
                                                  pack=True, **kw), ins, go)
    assert cuda_lib.launches["flash_attention"] == before + 1
    (w,), want = _grads(lambda q, k, v: plain_attention(
        torch.cat([head, q], dim=1), k, v, **kw)[:, q0:], ins, go)
    _assert_grads_close((o, *got), (w, *want), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,near_one", RGLRU_SHAPES[:6])
def test_rglru_function_grads_match_plain(cuda_device, B, S, C, near_one):
    from repro_torch.kernels.rglru_scan import rglru_scan
    x = _randn((B, S, C), torch.float32, cuda_device, 0)
    a = 1 - torch.sigmoid(x) * 1e-3 if near_one else torch.sigmoid(x)
    b = _randn((B, S, C), torch.float32, cuda_device, 1)
    go = (_randn((B, S, C), torch.float32, cuda_device, 2),)
    before = cuda_lib.launches["rglru_scan:grouped"]
    (h,), got = _grads(rglru_scan, (a, b), go)
    assert cuda_lib.launches["rglru_scan:grouped"] == before + 1
    (_,), want = _grads(lambda a, b: rglru_scan_ref(a.double(), b.double()),
                        (a, b), (go[0].double(),))
    _assert_grads_close(got, want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd", [(2, 128, 2, 32), (1, 96, 4, 64),
                                      (2, 37, 3, 16), (1, 64, 2, 64)])
def test_wkv6_function_grads_match_plain(cuda_device, B, S, H, hd):
    """Grads of y and of the final state, through the model-facing wrapper."""
    from repro_torch.kernels.rwkv6_chunk import wkv6
    from repro_torch.kernels.rwkv6_chunk.ref import wkv6_ref
    r, k, v = (_randn((B, S, H, hd), torch.float32, cuda_device, i)
               for i in range(3))
    logw = torch.clamp(-torch.exp(_randn((B, S, H, hd), torch.float32,
                                         cuda_device, 3) * 0.5), -5.0, -1e-4)
    u = _randn((H, hd), torch.float32, cuda_device, 4) * 0.1
    go = (_randn((B, S, H, hd), torch.float32, cuda_device, 5),
          _randn((B, H, hd, hd), torch.float32, cuda_device, 6))
    before = cuda_lib.launches["wkv6:chunk"]
    _, got = _grads(wkv6, (r, k, v, logw, u), go)
    assert cuda_lib.launches["wkv6:chunk"] == before + 1

    def plain(r, k, v, logw, u):
        fold = lambda t: t.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        y, st = wkv6_ref(fold(r), fold(k), fold(v), fold(logw),
                         u[None].expand(B, H, hd).reshape(B * H, hd))
        return (y.reshape(B, H, S, hd).permute(0, 2, 1, 3),
                st.reshape(B, H, hd, hd))
    _, want = _grads(plain, tuple(t.double() for t in (r, k, v, logw, u)),
                     tuple(g.double() for g in go))
    _assert_grads_close(got, want, 1e-3)


def _train_batch(cfg, device, B=2, S=64):
    from repro_torch.data import SyntheticTokens
    return {k: torch.from_numpy(v).to(device) for k, v in
            SyntheticTokens(cfg, B, S, seed=0).batch_for_step(0).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_card_gives_every_parameter_a_grad(cuda_device, arch):
    """Through the kernels, no parameter's grad is lost: each kernel's
    autograd function carries the gradient past the kernel's ctypes call."""
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step, init_train_state
    cfg = get_smoke_config(arch)
    state = init_train_state(torch.Generator(device=cuda_device).manual_seed(0),
                             cfg, adamw(), device=cuda_device)
    before = dict(cuda_lib.launches)
    state, metrics = build_train_step(cfg, adamw(), lambda s: 1e-3)(
        state, _train_batch(cfg, cuda_device))
    torch.cuda.synchronize()
    for name, kinds in KINDS.items():
        n = sum(kind in kinds for kind in cfg.layer_kinds())
        assert (cuda_lib.launches[name] - before.get(name, 0) > 0) == (n > 0), \
            name
    assert np.isfinite(float(metrics["loss"]))
    for name, p in state["params"].named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b",
                                  "rwkv6-7b", "qwen3-moe-235b-a22b",
                                  "arctic-480b", "whisper-small",
                                  "paligemma-3b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One f32 train step from the same weights and batch on the card
    (kernels) and on the CPU (plain versions): the loss to 1e-4 relative,
    each grad leaf to 1e-3 in relative norm, tf32 off."""
    import dataclasses
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step, init_train_state
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    out = {}
    for dev in ("cpu", cuda_device):
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        state = init_train_state(None, cfg, adamw(), params=model.to(dev))
        state, metrics = build_train_step(cfg, adamw(max_grad_norm=1e9),
                                          lambda s: 1e-3)(
            state, _train_batch(cfg, dev))
        out[str(dev)] = (float(metrics["loss"]),
                         {n: p.grad.cpu() for n, p in
                          state["params"].named_parameters()})
    (cl, cg), (gl, gg) = out["cpu"], out[str(cuda_device)]
    assert abs(gl - cl) <= 1e-4 * abs(cl)
    for n, c in cg.items():
        err = (torch.linalg.vector_norm(gg[n] - c) /
               torch.linalg.vector_norm(c)).item()
        assert err <= 1e-3, (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_adafactor_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """Two Adafactor updates over the stacked view, cut into chunks of a few
    experts (so both passes run chunk by chunk), on the card and on the CPU
    from the same f32 weights and grads: new weights and state to 1e-5
    relative (elementwise, or the leaf's largest element near zero)."""
    from repro_torch.optim import adafactor, optimizers
    monkeypatch.setattr(optimizers, "_CHUNK", 3 * 64 * 64)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    out = {}
    for dev in ("cpu", cuda_device):
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        params = {n: p.to(dev) for n, p in model.named_parameters()}
        opt = adafactor(clip_thresh=0.1, cfg=cfg)
        st = opt.init(params)
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            grads = {n: torch.randn(p.shape, generator=gen).to(dev)
                     for n, p in params.items()}
            params, st, _ = opt.update(grads, st, params, 0.01)
        out[str(dev)] = ({n: p.cpu() for n, p in params.items()},
                         {f"{k}/{n}": t.cpu() for k, s in st["vs"].items()
                          for n, t in s.items()})
    (cp, cs), (gp, gs) = out["cpu"], out[str(cuda_device)]
    for name, c in list(cp.items()) + list(cs.items()):
        g = gp[name] if name in gp else gs[name]
        torch.testing.assert_close(g, c, rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()),
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("decode", [False, True])
def test_moe_sharded_on_one_nccl_rank_matches_dense(cuda_device, tmp_path,
                                                    decode):
    """moe_layer under sharding rules on a 1 x 1 mesh over one NCCL rank
    takes moe_sharded, whose collectives are identities there: the same
    values as moe_dense, bit for bit, in f32."""
    import torch.distributed as dist
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.distributed import context
    from repro_torch.distributed.layouts import choose_layout
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"),
                              param_dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = moe.init_moe(cfg, gen, cuda_device)
    x = torch.randn((2, 1 if decode else 64, cfg.d_model), generator=gen,
                    device=cuda_device)
    want = moe.moe_dense(p, x, cfg)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with context.use_rules(choose_layout(cfg, LM_SHAPES["train_4k"],
                                             mesh)):
            got = moe.moe_layer(p, x, cfg, decode=decode)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_predicts_the_peak_memory_of_a_step(cuda_device, kind):
    """A step's traced peak (``launch.dryrun.trace_cell`` on the meta
    device, arguments included) against ``max_memory_allocated`` over the
    same step on the card, above what was allocated before its arguments:
    within ``roofline.analysis.PEAK_BAND``.  h2o-danube-1.8b at full width,
    2 layers; 2 x 512 positions (train: 2 x 256, AdamW)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import init_cache
    from repro_torch.optim import adamw
    from repro_torch.roofline.analysis import PEAK_BAND
    from repro_torch.serving.steps import build_decode_step, build_prefill_step
    from repro_torch.train.steps import build_train_step, init_train_state
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), n_layers=2)
    B, S = (2, 256) if kind == "train" else (2, 512)
    rec = trace_cell(cfg, ShapeConfig(kind, kind, S, B),
                     AbstractMesh(("data", "model"), (1, 1)), grad_accum=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if kind == "train":
        state = init_train_state(gen, cfg, adamw(), device=cuda_device)
        args = (state, _train_batch(cfg, cuda_device, B, S))
        step = build_train_step(cfg, adamw(), lambda s: 1e-3)
    else:
        model = init_params(cfg, gen, cuda_device)
        if kind == "prefill":
            args = (model, make_batch(cfg, gen, B, S))
            step = build_prefill_step(cfg)
        else:
            args = (model, init_cache(cfg, B, S, device=cuda_device),
                    torch.zeros((B, 1), dtype=torch.int32, device=cuda_device),
                    S - 1)
            step = build_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    step(*args)
    torch.cuda.synchronize()
    measured = (torch.cuda.max_memory_allocated(cuda_device) - base) / 1e9
    ratio = measured / rec["memory"]["peak_gb"]
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], (measured, rec["memory"])


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,T", [(2, 32, 2048, 2048),
                                     (1, 8, 1024, 4096), (4, 16, 512, 512)])
def test_softmax_backward_holds_what_the_trace_counts(cuda_device, B, H, S,
                                                      T, dtype, strided):
    """``_softmax_backward_data``'s peak above its inputs on the card equals
    ``OpTrace``'s on meta: its output, grad * output, and that product's
    contiguous copy where the gradient is strided
    (``roofline.trace._hidden_bytes``; the first shape is h2o-danube-1.8b's
    f32 attention backward at 2 x 2048, the last one a softmax of the
    short rows that CUDA runs in one warp)."""
    from repro_torch.roofline.trace import OpTrace

    def grad(device):
        shape = (B, S, H, T) if strided else (B, H, S, T)
        g = torch.empty(shape, dtype=dtype, device=device)
        return g.transpose(1, 2) if strided else g
    s = _randn((B, H, S, T), torch.float32, cuda_device, 0).softmax(-1).to(
        dtype)
    g = grad(cuda_device).normal_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = torch.ops.aten._softmax_backward_data(g, s, -1, dtype)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(cuda_device) - base
    meta = grad("meta"), torch.empty_like(s, device="meta")
    with OpTrace() as trace:
        torch.ops.aten._softmax_backward_data(*meta, -1, dtype)
    assert out.is_contiguous()
    assert measured == trace.peak_bytes, (measured, trace.peak_bytes)
