"""Wrappers of the RWKV-6 wkv kernel.

``wkv6_bh`` takes the kernel layout, r, k, v, logw (BH, S, hd) f32 and u
(BH, hd) f32, and returns y (BH, S, hd) and the final state (BH, hd, hd).
On a CUDA tensor it launches ``csrc/wkv6.cu`` or raises; on a CPU tensor it
runs the plain version (``ref.py``).  Nothing else is on that route: there
is no fallback.

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
HEAD_DIMS = (16, 32, 64)


@functools.cache
def _kernel():
    fn = cuda_lib.load(NAME).wkv6_fwd
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
    _check(r, k, v, logw, u)
    BH, S, hd = r.shape
    y = torch.empty_like(r)
    st = torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device)
    err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    u.data_ptr(), y.data_ptr(), st.data_ptr(), BH, S, hd,
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err}")
    cuda_lib.launches[NAME] += 1
    return y, st


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
