"""Losses and metrics.  Port of ``repro.models.losses``."""
from __future__ import annotations

import torch


def softmax_xent(logits, labels, ignore_index: int = -1):
    """logits: (B,S,V); labels: (B,S) integer with ignore_index masked out.

    Computed in f32; returns (mean loss, token count).
    """
    lf = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, safe[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1)
    return per_tok.sum() / n, n
