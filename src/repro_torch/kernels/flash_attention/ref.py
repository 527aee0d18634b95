"""Plain PyTorch version of the flash attention kernel.

The same function as ``csrc/flash_attention.cu``: f32 scores and f32 PV
product, the output cast to q's dtype at the end.  The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale: float, softcap: float = 0.0,
                        window: int = 0, causal: bool = True):
    """q: (BK, Sq, G, hd); k,v: (BK, Skv, hd) -> (BK, Sq, G, hd).

    Causality is aligned top-left: row i attends to kv positions <= i, and
    with a window also to positions > i - window.
    """
    Sq, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bsgd,btd->bsgt", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        kv_pos = torch.arange(Skv, device=q.device)[None, :]
        allow = kv_pos <= q_pos
        if window:
            allow &= kv_pos > q_pos - window
        s = torch.where(allow[None, :, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bsgt,btd->bsgd", a, v.float())
    return o.to(q.dtype)
