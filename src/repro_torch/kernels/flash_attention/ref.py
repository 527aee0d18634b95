"""Plain PyTorch versions of the flash attention kernels.

``flash_attention_ref`` is the function both kernels compute, as the
reference computes it: f32 scores and f32 PV product, the output cast to
q's dtype at the end.  It is the CPU route of the wrapper, and
``chip_smoke.py`` holds both kernels against it on the card.

``flash_attention_wgmma_ref`` repeats the tensor-core kernel's numerics
(``csrc/flash_attention_wgmma.cu``): an online softmax over KV tiles of 64
positions with f32 m, l and acc, whose probabilities are rounded to bf16
before the P·V product.  The CPU tests hold it against the reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
KV_TILE = 64          # the tensor-core kernel's KV tile


def flash_attention_ref(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True, q0: int = 0):
    """q: (BK, Sq, G, hd); k,v: (BK, Skv, hd) -> (BK, Sq, G, hd).

    Row i of q sits at position q0 + i: it attends to kv positions
    <= q0 + i, and with a window also only to positions > q0 + i - window
    (``q0 = 0``: causality aligned top-left).
    """
    Sq, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bsgd,btd->bsgt", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        q_pos = q0 + torch.arange(Sq, device=q.device)[:, None]
        kv_pos = torch.arange(Skv, device=q.device)[None, :]
        allow = kv_pos <= q_pos
        if window:
            allow &= kv_pos > q_pos - window
        s = torch.where(allow[None, :, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bsgt,btd->bsgd", a, v.float())
    return o.to(q.dtype)


def flash_attention_wgmma_ref(q, k, v, *, scale: float, softcap: float = 0.0,
                              window: int = 0, causal: bool = True,
                              q0: int = 0):
    """q: (BK, Sq, G, hd); k,v: (BK, Skv, hd) -> (BK, Sq, G, hd), with P
    rounded to bf16 before each tile's P·V product, as the tensor-core
    kernel does; row i of q at position q0 + i."""
    BK, Sq, G, hd = q.shape
    Skv = k.shape[1]
    qf = q.float().reshape(BK, Sq * G, hd)
    pos = q0 + torch.arange(Sq * G, device=q.device)[:, None] // G
    m = torch.full((BK, Sq * G, 1), NEG_INF, device=q.device)
    l = torch.zeros((BK, Sq * G, 1), device=q.device)
    acc = torch.zeros((BK, Sq * G, hd), device=q.device)
    for kv0 in range(0, Skv, KV_TILE):
        kt = k[:, kv0:kv0 + KV_TILE].float()
        vt = v[:, kv0:kv0 + KV_TILE].float()
        s = torch.einsum("brd,btd->brt", qf, kt) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            col = torch.arange(kv0, kv0 + kt.shape[1], device=q.device)[None, :]
            allow = col <= pos
            if window:
                allow &= col > pos - window
            s = torch.where(allow[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "brt,btd->brd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)
    return o.reshape(BK, Sq, G, hd).to(q.dtype)
