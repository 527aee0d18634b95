"""Wrappers of the RG-LRU scan kernels.

``rglru_scan_bsc`` takes the kernel layout, a and b (B, S, C) f32.  On a
CUDA tensor it launches ``csrc/rglru_scan_grouped.cu`` (channel groups in
one wave, fed by a TMA ring; ``plan`` sizes it) or raises; on a CPU
tensor it runs the plain version (``ref.py``); on a meta tensor it
launches nothing and records the kernel's work in the active
``roofline.trace.OpTrace`` (``rglru_scan_meta``).  Nothing else is on that
route: there is no fallback.  ``rglru_scan_thread`` launches the earlier
design, ``csrc/rglru_scan.cu`` (one thread per channel); no model path
calls it, it is kept to be timed and checked beside the new one.

``cuda_lib.launches["rglru_scan"]`` counts every launch, and
``launches["rglru_scan:grouped"]`` / ``["rglru_scan:thread"]`` the launches
of each kernel.

``rglru_scan`` is the model-facing wrapper: it casts to f32, as the
reference's ``ops.py`` does.  On a CUDA tensor it goes through
``RGLRUScan``, an autograd function whose forward launches the kernel and
whose backward is autograd of the plain version (``rglru_scan_ref``)
recomputed from the saved a and b in f64, as the kernel carries h (in f32
the ladder's gradient drifts past the scan's 2e-5 where a is near 1): the
reference's kernel has no VJP, so no backward kernel is owed.  On a CPU
tensor it calls the plain version directly.  On a DTensor it runs on each
rank's local shard through ``local_map`` (``distributed.context.
run_local``): the batch and the channels may be sharded, the sequence may
not.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed import context
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.roofline.bounds import rglru_work
from repro_torch.roofline.trace import record_kernel

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
    if a.device.type == "cuda" and \
            a.device.index != torch.cuda.current_device():
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
    if a.device.type == "meta":
        return rglru_scan_meta(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the RG-LRU scan runs on cuda, cpu or meta, not "
                         f"{a.device}")
    return rglru_scan_grouped(a, b)


def rglru_scan_meta(a, b):
    """The kernel's output on the meta device: launches nothing, and adds
    the kernel to the active ``OpTrace`` as one op doing its bound's work."""
    _check(a, b)
    return record_kernel(NAME, *rglru_work(*a.shape), torch.empty_like(a))


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


class RGLRUScan(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of ``rglru_scan_ref`` in
    f64, cast back to f32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return rglru_scan_bsc(a, b)

    @staticmethod
    def backward(ctx, grad_h):
        a, b = (t.detach().double().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad(), \
                torch.profiler.record_function("rglru_scan backward (plain)"):
            grads = torch.autograd.grad(rglru_scan_ref(a, b), (a, b),
                                        grad_h.double())
        return tuple(g.float() for g in grads)


def rglru_scan(a, b):
    """a, b: (B, S, C) gates and inputs -> recurrence output h (B, S, C) f32."""
    if context.is_dtensor(a):
        splits = {"batch": 0, "channels": 2}
        return context.run_local("the RG-LRU scan", rglru_scan,
                                 {"a": a, "b": b},
                                 {"a": splits, "b": splits}, splits)
    a, b = a.float().contiguous(), b.float().contiguous()
    if a.device.type == "cpu":
        return rglru_scan_bsc(a, b)
    return RGLRUScan.apply(a, b)
