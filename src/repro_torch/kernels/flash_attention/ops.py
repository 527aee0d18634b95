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

``cuda_lib.launches["flash_attention"]`` counts every launch, and
``launches["flash_attention:<variant>"]`` the launches of each kernel.

``flash_attention`` is the model-facing GQA wrapper: it folds (B, S, K, G,
hd) into the kernel layout (B*K, S, G, hd), as the reference's ``ops.py``
does, and unfolds the result.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

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
            [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    else:
        fn = cuda_lib.load(WGMMA).flash_attention_wgmma_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.index != torch.cuda.current_device():
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention_bkg(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True):
    """q: (BK, Sq, G, hd); k,v: (BK, Skv, hd) -> (BK, Sq, G, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, softcap=softcap,
                                   window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    launch = flash_attention_wgmma if variant(q.dtype, q.shape[-1]) == "wgmma" \
        else flash_attention_fma
    return launch(q, k, v, scale=scale, softcap=softcap, window=window,
                  causal=causal)


def _launched(err: int, which: str):
    if err:
        raise RuntimeError(f"flash attention kernel ({which}) launch failed: "
                           f"cudaError {err}")
    cuda_lib.launches[NAME] += 1
    cuda_lib.launches[f"{NAME}:{which}"] += 1


def flash_attention_fma(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True):
    """Launch the CUDA-core kernel on CUDA tensors (f32 or bf16)."""
    _check(q, k, v)
    BK, Sq, G, hd = q.shape
    o = torch.empty_like(q)
    err = _kernel(NAME)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        BK, Sq, k.shape[1], G, hd, float(scale),
                        float(softcap), int(window), int(causal),
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    _launched(err, "fma")
    return o


def flash_attention_wgmma(q, k, v, *, scale: float, softcap: float = 0.0,
                          window: int = 0, causal: bool = True):
    """Launch the tensor-core kernel on CUDA bf16 tensors whose head dim is
    in ``WGMMA_HEAD_DIMS``."""
    _check(q, k, v)
    BK, Sq, G, hd = q.shape
    if variant(q.dtype, hd) != "wgmma":
        raise ValueError(f"the tensor-core flash kernel takes bf16 at head "
                         f"dims {WGMMA_HEAD_DIMS}, got {q.dtype} at {hd}")
    o = torch.empty_like(q)
    err = _kernel(WGMMA)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), BK, Sq, k.shape[1], G, hd, float(scale),
                         float(softcap), int(window), int(causal),
                         torch.cuda.current_stream().cuda_stream)
    _launched(err, "wgmma")
    return o


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                    scale: float, causal: bool = True):
    """q: (B,S,K,G,hd); k,v: (B,Skv,K,hd) -> (B,S,K,G,hd)."""
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    qf = q.permute(0, 2, 1, 3, 4).reshape(B * K, Sq, G, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * K, Skv, hd).contiguous()
    o = flash_attention_bkg(qf, kf, vf, scale=scale, softcap=softcap,
                            window=window, causal=causal)
    return o.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4)
