"""Wrappers of the RG-LRU scan kernel.

``rglru_scan_bsc`` takes the kernel layout, a and b (B, S, C) f32.  On a
CUDA tensor it launches ``csrc/rglru_scan.cu`` or raises; on a CPU tensor it
runs the plain version (``ref.py``).  Nothing else is on that route: there
is no fallback.

``rglru_scan`` is the model-facing wrapper: it casts to f32, as the
reference's ``ops.py`` does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

NAME = "rglru_scan"


@functools.cache
def _kernel():
    fn = cuda_lib.load(NAME).rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    if a.device != b.device:
        raise ValueError(f"a and b on different devices: {a.device}, {b.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"a is on {a.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the RG-LRU scan takes f32, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"want a and b (B,S,C) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, C = a.shape
    if min(B, S, C) == 0 or B > 65535:
        raise ValueError(f"unsupported shape {tuple(a.shape)}")
    # the kernel reads one float per thread: f32 tensors are always aligned
    # to their element, so only the layout needs checking
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan_bsc(a, b):
    """a, b: (B, S, C) f32 -> inclusive scan h (B, S, C) f32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not {a.device}")
    _check(a, b)
    B, S, C = a.shape
    h = torch.empty_like(a)
    err = _kernel()(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, C,
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"RG-LRU scan kernel launch failed: cudaError {err}")
    cuda_lib.launches[NAME] += 1
    return h


def rglru_scan(a, b):
    """a, b: (B, S, C) gates and inputs -> recurrence output h (B, S, C) f32."""
    return rglru_scan_bsc(a.float().contiguous(), b.float().contiguous())
