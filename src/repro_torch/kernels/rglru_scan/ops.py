"""Wrappers of the RG-LRU scan kernels.

``rglru_scan_bsc`` takes the kernel layout, a and b (B, S, C) f32.  On a
CUDA tensor it launches ``csrc/rglru_scan_grouped.cu`` (channel groups in
one wave, fed by a TMA ring; ``plan`` sizes it) or raises; on a CPU
tensor it runs the plain version (``ref.py``).  Nothing else is on that
route: there is no fallback.  ``rglru_scan_thread`` launches the earlier
design, ``csrc/rglru_scan.cu`` (one thread per channel); no model path
calls it, it is kept to be timed and checked beside the new one.

``cuda_lib.launches["rglru_scan"]`` counts every launch, and
``launches["rglru_scan:grouped"]`` / ``["rglru_scan:thread"]`` the launches
of each kernel.

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
GROUPED = "rglru_scan_grouped"      # the channel-group kernel's library
MAX_GROUP = 128                     # channels a CTA, one thread each


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def plan(B: int, C: int, sms: int) -> int:
    """G, the channels a CTA of the channel-group kernel walks: a multiple of
    4 (so that TMA boxes start 16-byte aligned), at most ``MAX_GROUP``, and
    as large as B * ceil(C / G) CTAs filling ``sms`` SMs about once needs."""
    per_row = _cdiv(sms, B)                      # groups per batch row
    return min(MAX_GROUP, 4 * _cdiv(_cdiv(C, per_row), 4))


@functools.cache
def _kernel(name: str):
    if name == GROUPED:
        fn = cuda_lib.load(GROUPED).rglru_scan_grouped_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    else:
        fn = cuda_lib.load(NAME).rglru_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
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
    # the kernels take any f32 alignment (the grouped one loads by TMA where
    # C % 4 == 0 and the tensors are 16-byte aligned, 4 bytes a lane
    # elsewhere), so only the layout needs checking
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan_bsc(a, b):
    """a, b: (B, S, C) f32 -> inclusive scan h (B, S, C) f32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not {a.device}")
    return rglru_scan_grouped(a, b)


def _launched(err: int, which: str):
    if err:
        raise RuntimeError(f"RG-LRU scan kernel ({which}) launch failed: "
                           f"cudaError {err}")
    cuda_lib.launches[NAME] += 1
    cuda_lib.launches[f"{NAME}:{which}"] += 1


def rglru_scan_grouped(a, b):
    """Launch the channel-group kernel on CUDA tensors."""
    _check(a, b)
    B, S, C = a.shape
    G = plan(B, C, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    h = torch.empty_like(a)
    err = _kernel(GROUPED)(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, C,
                           G, torch.cuda.current_stream().cuda_stream)
    _launched(err, "grouped")
    return h


def rglru_scan_thread(a, b):
    """Launch the earlier one-thread-per-channel kernel on CUDA tensors."""
    _check(a, b)
    B, S, C = a.shape
    h = torch.empty_like(a)
    err = _kernel(NAME)(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, C,
                        torch.cuda.current_stream().cuda_stream)
    _launched(err, "thread")
    return h


def rglru_scan(a, b):
    """a, b: (B, S, C) gates and inputs -> recurrence output h (B, S, C) f32."""
    return rglru_scan_bsc(a.float().contiguous(), b.float().contiguous())
