"""Gradient compression with error feedback for the data-parallel
all-reduce.  Port of ``repro.distributed.compression``.

int8 quantization (per-leaf absmax scale) + residual error feedback: the
quantization error of step k is added back to the gradient at step k+1, so
the compressed optimizer tracks the exact one.  Wire cost of the
data-parallel all-reduce drops 4x (f32) / 2x (bf16).

``compressed_psum`` runs on a process group (a mesh dim's,
``mesh.get_group("data")``) where the reference's runs inside
``shard_map`` over a named axis; ``compress_tree`` and
``wire_bytes_saved`` take dicts of tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x):
    """-> (int8 q, f32 0-d scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_tree(grads: dict, residual: dict):
    """Returns (quantized dict, scales dict, new residual dict)."""
    q, s, res = {}, {}, {}
    for n, g in grads.items():
        gf = g.float() + residual[n]
        q[n], s[n] = quantize_int8(gf)
        res[n] = gf - dequantize_int8(q[n], s[n])
    return q, s, res


def compressed_psum(g, group, residual):
    """int8 all-reduce with error feedback over ``group``.

    g: local gradient; residual: error-feedback carry.
    Returns (mean gradient f32, new residual).
    """
    gf = g.float() + residual
    q, scale = quantize_int8(gf)
    deq = dequantize_int8(q, scale)
    new_residual = gf - deq
    # int8 payloads sum without overflow in i32
    summed = q.to(torch.int32)
    dist.all_reduce(summed, group=group)
    scale_sum = scale.clone()
    dist.all_reduce(scale_sum, group=group)  # conservative shared scale
    n = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(n, group=group)
    mean = summed.float() * (scale_sum / n) / n
    return mean, new_residual


def wire_bytes_saved(tree: dict, from_dtype=torch.float32) -> int:
    """Bytes saved per all-reduce by int8 compression."""
    total = sum(x.numel() for x in tree.values())
    return total * (torch.empty((), dtype=from_dtype).element_size() - 1)
