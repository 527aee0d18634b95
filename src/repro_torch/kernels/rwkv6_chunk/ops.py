"""Wrappers of the RWKV-6 wkv kernels.

``wkv6_bh`` takes the kernel layout, r, k, v, logw (BH, S, hd) f32 and u
(BH, hd) f32, and returns y (BH, S, hd) and the final state (BH, hd, hd).
On a CUDA tensor it launches ``csrc/wkv6_chunk.cu`` (the chunked form on
the tensor cores, in 3xTF32; its numerics' plain version is
``ref.wkv6_chunk_ref``) or raises; on a CPU tensor it runs the plain
version (``ref.wkv6_ref``); on a meta tensor it launches nothing and
records the kernel's work in the active ``roofline.trace.OpTrace``
(``wkv6_meta``).  Nothing else is on that route: there is no fallback.
``wkv6_seq`` launches the earlier design, ``csrc/wkv6.cu`` (the sequential
form on the CUDA cores); no model path calls it, it is kept to be timed and
checked beside the new one.

``cuda_lib.launches["wkv6"]`` counts every launch, and
``launches["wkv6:chunk"]`` / ``["wkv6:seq"]`` the launches of each kernel.

``wkv6`` is the model-facing wrapper: it folds (B, S, H, hd) into the kernel
layout (B*H, S, hd) in f32 and broadcasts u, as the reference's ``ops.py``
does, and unfolds y to (B, S, H, hd) and the state to (B, H, hd, hd).  On a
CUDA tensor it goes through ``WKV6``, an autograd function whose forward
launches the kernel and whose backward is autograd of the plain chunked
version (``wkv6_ref``) recomputed from the saved inputs in f64, as the
kernel carries its state: the reference's kernel has no VJP, so no backward
kernel is owed.  On a CPU tensor it calls the plain version directly.  On a DTensor it runs on each
rank's local shard through ``local_map`` (``distributed.context.
run_local``): the batch and the heads may be sharded (u by its heads), the
sequence and the head dim may not.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed import context
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_ref
from repro_torch.roofline.bounds import wkv6_work
from repro_torch.roofline.trace import record_kernel

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
    cuda = r.device.type == "cuda"
    if cuda and r.device.index != torch.cuda.current_device():
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
        if not t.is_contiguous() or (cuda and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def wkv6_bh(r, k, v, logw, u):
    """r, k, v, logw: (BH, S, hd) f32; u: (BH, hd) f32 ->
    (y (BH, S, hd) f32, S_last (BH, hd, hd) f32)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u)
    if r.device.type == "meta":
        return wkv6_meta(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"the wkv6 kernel runs on cuda, cpu or meta, not "
                         f"{r.device}")
    return wkv6_chunk(r, k, v, logw, u)


def wkv6_meta(r, k, v, logw, u):
    """The kernel's outputs on the meta device: launches nothing, and adds
    the kernel to the active ``OpTrace`` as one op doing its bound's work
    (one exp a key channel a step)."""
    _check(r, k, v, logw, u)
    BH, S, hd = r.shape
    out = (torch.empty_like(r),
           torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device))
    return record_kernel(NAME, *wkv6_work(BH, S, hd), out, BH * S * hd)


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


class WKV6(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of ``wkv6_ref`` (y and the
    final state) in f64, cast back to f32."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        return wkv6_bh(r, k, v, logw, u)

    @staticmethod
    def backward(ctx, grad_y, grad_st):
        ins = [t.detach().double().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), \
                torch.profiler.record_function("wkv6 backward (plain)"):
            grads = torch.autograd.grad(wkv6_ref(*ins), ins,
                                        (grad_y.double(), grad_st.double()))
        return tuple(g.float() for g in grads)


def wkv6(r, k, v, logw, u):
    """r, k, v, logw: (B, S, H, hd); u: (H, hd) ->
    (y (B, S, H, hd) f32, S_last (B, H, hd, hd) f32)."""
    if context.is_dtensor(r):
        seq = {"batch": 0, "heads": 2}
        return context.run_local(
            "the wkv6 kernel", wkv6,
            {"r": r, "k": k, "v": v, "logw": logw, "u": u},
            dict.fromkeys(("r", "k", "v", "logw"), seq) | {"u": {"heads": 0}},
            (seq, {"batch": 0, "heads": 1}))
    B, S, H, hd = r.shape

    def fold(t):
        return t.float().permute(0, 2, 1, 3).reshape(B * H, S, hd).contiguous()

    uf = u.float()[None].expand(B, H, hd).reshape(B * H, hd).contiguous()
    ins = (fold(r), fold(k), fold(v), fold(logw), uf)
    y, st = wkv6_bh(*ins) if r.device.type == "cpu" else WKV6.apply(*ins)
    return (y.reshape(B, H, S, hd).permute(0, 2, 1, 3),
            st.reshape(B, H, hd, hd))
