"""Wrappers of the flash attention kernels.

``flash_attention_bkg`` takes the kernel layout, q (BK, Sq, G, hd) and k, v
(BK, Skv, hd).  On a CUDA tensor it launches one of two kernels or raises;
on a CPU tensor it runs the plain version (``ref.py``).  Nothing else is on
that route: there is no fallback.  Which kernel a CUDA call launches is
decided by dtype and head dim alone (``variant``):

- ``"wgmma"``: bf16 at a head dim in ``WGMMA_HEAD_DIMS`` goes to the
  tensor-core kernel, ``csrc/flash_attention_wgmma.cu`` (P rounded to bf16
  before the P·V product; its plain version is ``flash_attention_wgmma_ref``);
- ``"fma"``: f32, and bf16 at any other head dim, go to the CUDA-core
  kernel, ``csrc/flash_attention.cu`` (all f32: TF32 would break the
  reference's 3e-5 f32 tolerance).

On a meta tensor it launches nothing: ``flash_attention_meta`` returns
the output's shape and dtype and adds the kernel's work to the active
``roofline.trace.OpTrace``, so a dry-run counts what the card runs.

``cuda_lib.launches["flash_attention"]`` counts every launch, and
``launches["flash_attention:<variant>"]`` the launches of each kernel.

``flash_attention`` is the model-facing GQA wrapper: it folds (B, S, K, G,
hd) into the kernel layout (B*K, S, G, hd), as the reference's ``ops.py``
does, and unfolds the result.  Every call takes a q-row offset ``q0``: row
i of q sits at position ``q0 + i`` under the causal mask (both kernels take
it).  On a CUDA tensor it goes through ``FlashAttention``, an autograd
function whose forward launches the kernel and whose backward is the
gradient of the attention the reference trains through, recomputed from
the saved q, k, v: ``models.attention.causal_attention``, the reference's
q-block dispatch (its ``_sdpa``, ``_qblock_scan`` or ``_causal_packed``) at
the layer's ``q_block`` and ``pack``.  The reference's kernel has no VJP,
so no backward kernel is owed.  On a CPU tensor it calls the plain version
directly, which autograd differentiates as it is.  On a DTensor it runs
all of that on each rank's local shard through ``local_map``
(``distributed.context.run_local``): the batch and the kv heads may be
sharded, the sequence, the group and the head dim may not (a shard of
those raises, with the placements in the message), and each rank launches
its kernel, and counts the launch, on its own shard.  Where a mesh dim
cuts the q heads and not the kv heads (gemma2-9b's 16 heads and 8 kv heads
over 16 ``model`` ranks), the model hands q over flat, (B, S, H, hd): each
rank runs its H / tp q heads against the one kv head they read, and k's
and v's gradients are summed over that dim.  Where ``model`` does not
divide the q heads (the internlm2-20b smoke config's 4 heads over 16
ranks; recurrentgemma-2b's 10), q comes flat too and each rank runs one
block of one group of heads' rows at its ``q0`` (the q-rows route).
``distributed.heads.head_split`` says which layouts split how; any other
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed import context, heads
from repro_torch.distributed.heads import splits_q_rows
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline.bounds import causal_pairs, flash_work
from repro_torch.roofline.trace import record_kernel

NAME = "flash_attention"
WGMMA = "flash_attention_wgmma"     # the tensor-core kernel's library
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # its instances


def variant(dtype, hd: int) -> str:
    """The kernel a CUDA call on ``dtype`` inputs of head dim ``hd``
    launches: ``"wgmma"`` (tensor cores) for bf16 at a head dim in
    ``WGMMA_HEAD_DIMS``, else ``"fma"`` (CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS \
        else "fma"


@functools.cache
def _kernel(name: str):
    if name == NAME:
        fn = cuda_lib.load(NAME).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn = cuda_lib.load(WGMMA).flash_attention_wgmma_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q0: int = 0):
    if not isinstance(q0, int) or q0 < 0:
        raise ValueError(f"q0 must be an int >= 0, got {q0!r}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    cuda = q.device.type == "cuda"
    if cuda and q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash attention takes f32 or bf16 of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q (BK,Sq,G,hd), k and v (BK,Skv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BK, Sq, G, hd = q.shape
    if k.shape[0] != BK or k.shape[2] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (0 < hd <= MAX_HEAD_DIM and hd % 4 == 0):
        raise ValueError(f"head dim {hd} not a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}")
    if min(BK, Sq, G, k.shape[1]) == 0 or BK > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or (cuda and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention_bkg(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True, q0: int = 0):
    """q: (BK, Sq, G, hd); k,v: (BK, Skv, hd) -> (BK, Sq, G, hd); row i of
    q at position ``q0 + i`` under the causal mask."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   window=window, causal=causal, q0=q0)
    if q.device.type == "meta":
        return flash_attention_meta(q, k, v, window=window, causal=causal,
                                    q0=q0)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    launch = flash_attention_wgmma if variant(q.dtype, q.shape[-1]) == "wgmma" \
        else flash_attention_fma
    return launch(q, k, v, scale=scale, softcap=softcap, window=window,
                  causal=causal, q0=q0)


def flash_attention_meta(q, k, v, *, window: int = 0, causal: bool = True,
                         q0: int = 0):
    """The kernel's output on the meta device: launches nothing, and adds
    the kernel to the active ``OpTrace`` as one op doing the work of its
    bound (the allowed (q, kv) pairs of the rows at ``q0``.. only; one exp
    a pair)."""
    _check(q, k, v, q0)
    BK, Sq, G, hd = q.shape
    Skv = k.shape[1]
    flops, nbytes = flash_work(BK, Sq, Skv, G, hd, window, causal,
                               q.element_size(), q0)
    return record_kernel(NAME, flops, nbytes, torch.empty_like(q),
                         BK * G * causal_pairs(Sq, Skv, window, causal, q0))


def _launched(err: int, which: str):
    if err:
        raise RuntimeError(f"flash attention kernel ({which}) launch failed: "
                           f"cudaError {err}")
    cuda_lib.launches[NAME] += 1
    cuda_lib.launches[f"{NAME}:{which}"] += 1


def flash_attention_fma(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True, q0: int = 0):
    """Launch the CUDA-core kernel on CUDA tensors (f32 or bf16)."""
    _check(q, k, v, q0)
    BK, Sq, G, hd = q.shape
    o = torch.empty_like(q)
    err = _kernel(NAME)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        BK, Sq, k.shape[1], G, hd, float(scale),
                        float(softcap), int(window), int(causal), q0,
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    _launched(err, "fma")
    return o


def flash_attention_wgmma(q, k, v, *, scale: float, softcap: float = 0.0,
                          window: int = 0, causal: bool = True, q0: int = 0):
    """Launch the tensor-core kernel on CUDA bf16 tensors whose head dim is
    in ``WGMMA_HEAD_DIMS``."""
    _check(q, k, v, q0)
    BK, Sq, G, hd = q.shape
    if variant(q.dtype, hd) != "wgmma":
        raise ValueError(f"the tensor-core flash kernel takes bf16 at head "
                         f"dims {WGMMA_HEAD_DIMS}, got {q.dtype} at {hd}")
    o = torch.empty_like(q)
    err = _kernel(WGMMA)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), BK, Sq, k.shape[1], G, hd, float(scale),
                         float(softcap), int(window), int(causal), q0,
                         torch.cuda.current_stream().cuda_stream)
    _launched(err, "wgmma")
    return o


def _flash_gqa(q, k, v, *, window: int, softcap: float, scale: float,
               causal: bool, q0: int = 0):
    """Fold (B,S,K,G,hd) into the kernel layout, run the wrapper, unfold."""
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    qf = q.permute(0, 2, 1, 3, 4).reshape(B * K, Sq, G, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    o = flash_attention_bkg(qf, kf, vf, scale=scale, softcap=softcap,
                            window=window, causal=causal, q0=q0)
    return o.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the attention the
    reference trains through, recomputed from the saved inputs under
    ``torch.enable_grad`` (backward runs without grad): for a causal mask
    ``models.attention.causal_attention``, the reference's q-block
    dispatch at the layer's ``q_block`` and ``pack`` (a masked ``_sdpa``
    of the whole square where S <= 2 q_block, else the q-block scan or the
    causal packing; the rows at ``q0`` against their keys where ``q0`` >
    0); unmasked, the plain attention."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, scale, causal, q0, q_block,
                pack):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        ctx.kw = dict(window=window, softcap=softcap, scale=scale, q0=q0)
        ctx.dispatch = dict(q_block=q_block, pack=pack)
        return _flash_gqa(q, k, v, causal=causal, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_o):
        from repro_torch.models.attention import (causal_attention,
                                                  plain_attention)
        qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), \
                torch.profiler.record_function("attention backward (eager)"):
            o = causal_attention(*qkv, **ctx.kw, **ctx.dispatch) \
                if ctx.causal else plain_attention(*qkv, **ctx.kw,
                                                   causal=False)
            grads = torch.autograd.grad(o, qkv, grad_o)
        return (*grads, None, None, None, None, None, None, None)


# the axes a DTensor's shard may cut: batch and kv heads
_SPLITS = {"batch": 0, "kv_heads": 2}


def _flash_q_heads(q, k, v, **kw):
    """Flash's q-heads route (``distributed.heads.run_q_heads``): each
    rank's own q heads through the kernel against the one kv head they
    read."""
    return heads.run_q_heads("flash attention",
                             functools.partial(flash_attention, **kw), q, k,
                             v)


def _flash_rows(q, k, v, *, q0: int, **kw):
    """The kernel on one rank's rows at positions ``q0``.. against the keys
    up to their last row."""
    end = q0 + q.shape[1]
    return flash_attention(q, k.narrow(1, 0, end), v.narrow(1, 0, end),
                           q0=q0, **kw)


def _flash_q_rows(q, k, v, **kw):
    """Flash's q-rows route (``distributed.heads.run_q_rows``): each
    rank's block of one head group's rows through the kernel at its
    ``q0``."""
    return heads.run_q_rows("flash attention",
                            functools.partial(_flash_rows, **kw), q, k, v)


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                    scale: float, causal: bool = True, q0: int = 0,
                    q_block: int, pack: bool):
    """q: (B,S,K,G,hd); k,v: (B,Skv,K,hd) -> (B,S,K,G,hd); row i of q at
    position ``q0 + i``.  ``q_block`` and ``pack`` (no defaults: every
    caller names them) are the layer's ``attn_q_block`` and the reference's
    ``pack_ok``: the dispatch the backward recomputes through
    (``FlashAttention``).  On DTensors q may
    also be flat, (B,S,H,hd) -> (B,S,H,hd): the q-heads route
    (``splits_q_heads``) or the q-rows route (``splits_q_rows``)."""
    kw = dict(window=window, softcap=softcap, scale=scale, causal=causal)
    dispatch = dict(q_block=q_block, pack=pack)
    if context.is_dtensor(q):
        if q.dim() == 4:
            route = _flash_q_rows if splits_q_rows(q, k) else _flash_q_heads
            return route(q, k, v, **kw, **dispatch)
        return context.run_local(
            "flash attention", functools.partial(flash_attention, q0=q0,
                                                 **kw, **dispatch),
            {"q": q, "k": k, "v": v}, dict.fromkeys("qkv", _SPLITS), _SPLITS)
    if q.device.type == "cpu":
        return _flash_gqa(q, k, v, q0=q0, **kw)
    return FlashAttention.apply(q, k, v, window, softcap, scale, causal, q0,
                                q_block, pack)
