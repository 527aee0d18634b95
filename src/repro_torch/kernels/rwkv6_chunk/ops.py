"""Wrappers of the RWKV-6 wkv kernels.

``wkv6_bh`` takes the kernel layout, r, k, v, logw (BH, S, hd) f32 and u
(BH, hd) f32, and returns y (BH, S, hd) and the final state (BH, hd, hd).
On a CUDA tensor it launches ``csrc/wkv6_chunk.cu`` (the chunked form on
the tensor cores, in 3xTF32; its numerics' plain version is
``ref.wkv6_chunk_ref``) or raises; on a CPU tensor it runs the plain
version (``ref.wkv6_ref``).  Nothing else is on that route: there is no
fallback.  ``wkv6_seq`` launches the earlier design, ``csrc/wkv6.cu`` (the
sequential form on the CUDA cores); no model path calls it, it is kept to
be timed and checked beside the new one.

``cuda_lib.launches["wkv6"]`` counts every launch, and
``launches["wkv6:chunk"]`` / ``["wkv6:seq"]`` the launches of each kernel.

``wkv6`` is the model-facing wrapper: it folds (B, S, H, hd) into the kernel
layout (B*H, S, hd) in f32 and broadcasts u, as the reference's ``ops.py``
does, and unfolds y to (B, S, H, hd) and the state to (B, H, hd, hd).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_ref

NAME = "wkv6"
CHUNK = "wkv6_chunk"                # the tensor-core kernel's library
HEAD_DIMS = (16, 32, 64)


@functools.cache
def _kernel(name: str):
    lib = cuda_lib.load(name)
    fn = lib.wkv6_chunk_fwd if name == CHUNK else lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, logw, u):
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u))
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the wkv6 kernel takes f32, {name} is {t.dtype}")
    if r.device.index != torch.cuda.current_device():
        raise ValueError(f"r is on {r.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if r.dim() != 3 or not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(f"want r, k, v, logw (BH,S,hd) of one shape; got "
                         f"{[tuple(t.shape) for _, t in named[:4]]}")
    BH, S, hd = r.shape
    if tuple(u.shape) != (BH, hd):
        raise ValueError(f"want u ({BH}, {hd}), got {tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not one of {HEAD_DIMS}")
    if min(BH, S) == 0:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def wkv6_bh(r, k, v, logw, u):
    """r, k, v, logw: (BH, S, hd) f32; u: (BH, hd) f32 ->
    (y (BH, S, hd) f32, S_last (BH, hd, hd) f32)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"the wkv6 kernel runs on cuda or cpu, not {r.device}")
    return wkv6_chunk(r, k, v, logw, u)


def _launch(name, which, r, k, v, logw, u):
    _check(r, k, v, logw, u)
    BH, S, hd = r.shape
    y = torch.empty_like(r)
    st = torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device)
    err = _kernel(name)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                        st.data_ptr(), BH, S, hd,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel ({which}) launch failed: "
                           f"cudaError {err}")
    cuda_lib.launches[NAME] += 1
    cuda_lib.launches[f"{NAME}:{which}"] += 1
    return y, st


def wkv6_chunk(r, k, v, logw, u):
    """Launch the chunked tensor-core kernel on CUDA tensors."""
    return _launch(CHUNK, "chunk", r, k, v, logw, u)


def wkv6_seq(r, k, v, logw, u):
    """Launch the earlier sequential kernel on CUDA tensors."""
    return _launch(NAME, "seq", r, k, v, logw, u)


def wkv6(r, k, v, logw, u):
    """r, k, v, logw: (B, S, H, hd); u: (H, hd) ->
    (y (B, S, H, hd) f32, S_last (B, H, hd, hd) f32)."""
    B, S, H, hd = r.shape

    def fold(t):
        return t.float().permute(0, 2, 1, 3).reshape(B * H, S, hd).contiguous()

    uf = u.float()[None].expand(B, H, hd).reshape(B * H, hd).contiguous()
    y, st = wkv6_bh(fold(r), fold(k), fold(v), fold(logw), uf)
    return (y.reshape(B, H, S, hd).permute(0, 2, 1, 3),
            st.reshape(B, H, hd, hd))
