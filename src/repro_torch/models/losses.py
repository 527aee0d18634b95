"""Losses and metrics.  Port of ``repro.models.losses``."""
from __future__ import annotations

import torch

from repro_torch.distributed.context import is_dtensor


def softmax_xent(logits, labels, ignore_index: int = -1):
    """logits: (B,S,V); labels: (B,S) integer with ignore_index masked out.

    Computed in f32; returns (mean loss, token count).  The label's logit
    is a gather; on DTensor logits whose vocab is sharded (DTensor cannot
    gather along a sharded dim), it is the sum over the vocab of the
    logits where the index equals the label, which adds only zeros to it
    and so gives the same value.
    """
    lf = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(lf, dim=-1)
    if is_dtensor(lf) and any(p.is_shard(lf.dim() - 1)
                              for p in lf.placements):
        hit = torch.arange(lf.shape[-1], device=lf.device) == safe[..., None]
        ll = torch.where(hit, lf, 0.0).sum(-1)
    else:
        ll = torch.gather(lf, -1, safe[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1)
    return per_tok.sum() / n, n
