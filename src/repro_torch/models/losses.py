"""Losses and metrics.  Port of ``repro.models.losses``.

On DTensor logits whose vocab is sharded (the head's output under the
reference's rules, ``vocab`` on ``model``), the cross-entropy is
vocab-parallel: each rank works on its own columns through ``local_map``
and the ranks of the vocab's mesh dim exchange three (B, S) f32 tensors
(a max, a sum of exponentials, the label's logit), never the logits.  Its
backward is local, so the logits' gradient stays sharded on the vocab and
the head's backward products stay on each rank's columns, as the
reference's partitioner keeps its ``take_along_axis``.  Logits whose
vocab is whole and whose rows are cut (a vocab that does not split, its
head on each rank's rows) take each rank's rows' loss, with no collective
but the sum.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.context import (is_dtensor, redistribute,
                                             rows_cut, summed)


def softmax_xent(logits, labels, ignore_index: int = -1):
    """logits: (B,S,V); labels: (B,S) integer with ignore_index masked out.

    Computed in f32; returns (mean loss, token count).  On DTensor logits
    sharded on the vocab, the per-token loss is ``vocab_parallel_nll``'s;
    on DTensor logits whose rows are cut (the head on each rank's rows,
    ``transformer._unembed``), each rank's rows' loss against its rows of
    the labels.
    """
    lf = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    n = torch.clamp(summed(mask.sum()), min=1)
    if is_dtensor(lf) and any(p.is_shard(lf.dim() - 1)
                              for p in lf.placements):
        nll = vocab_parallel_nll(lf, safe)
    else:
        if rows_cut(lf):
            # the labels at the logits' rows: a local cut
            mask, safe = (redistribute(t, lf.placements)
                          for t in (mask, safe))
        lse = torch.logsumexp(lf, dim=-1)
        nll = lse - torch.gather(lf, -1, safe[..., None])[..., 0]
    per_tok = nll * mask
    return per_tok.sum() / n, n


def vocab_parallel_nll(lf, safe):
    """-log softmax(lf)[safe] of DTensor f32 logits ``lf`` (B,S,V) sharded
    on V over one mesh dim, ``safe`` (B,S) the labels (a DTensor, or a
    plain tensor taken as replicated) -> (B,S), laid out as ``lf`` is
    without the vocab shard (replicated over the vocab's ranks)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, last = lf.device_mesh, lf.dim() - 1
    on = [m for m, p in enumerate(lf.placements) if p.is_shard(last)]
    if len(on) != 1 or lf.shape[-1] % mesh.size(on[0]):
        raise ValueError(f"vocab-parallel cross-entropy: the vocab of "
                         f"{lf.shape[-1]} is cut on mesh dims {on}, the "
                         f"loss takes one that divides it; placements "
                         f"{tuple(lf.placements)}")
    m = on[0]
    rows = tuple(Replicate() if p.is_shard(last) else p
                 for p in lf.placements)
    if not is_dtensor(safe):
        safe = DTensor.from_local(safe, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)
    offset = mesh.get_local_rank(m) * (lf.shape[-1] // mesh.size(m))
    group = mesh.get_group(m)
    run = local_map(
        lambda lf, safe: _VocabParallelNLL.apply(lf, safe, offset, group),
        out_placements=(rows,), in_placements=(tuple(lf.placements), rows),
        in_grad_placements=(tuple(lf.placements), rows), device_mesh=mesh,
        redistribute_inputs=True)
    return run(lf, safe)


class _VocabParallelNLL(torch.autograd.Function):
    """One rank's columns ``lf`` (B,S,Vr) of the logits, starting at vocab
    index ``offset``; ``safe`` (B,S) the labels.  Forward: the max, the sum
    of exp(logit - max) and the label's logit (0 where the label is another
    rank's), each all-reduced over ``group`` (``torch.distributed.
    all_reduce``: MAX, SUM, SUM) -> log(sum) + max - label's logit.
    Backward, with no collective: g (softmax - onehot) on these columns."""

    @staticmethod
    def forward(ctx, lf, safe, offset, group):
        mx = lf.amax(-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        p = torch.exp(lf - mx[..., None])
        se = p.sum(-1)
        dist.all_reduce(se, op=dist.ReduceOp.SUM, group=group)
        local = safe - offset
        hit = (local >= 0) & (local < lf.shape[-1])
        idx = torch.where(hit, local, 0)[..., None]
        ll = torch.where(hit, torch.gather(lf, -1, idx)[..., 0], 0.0)
        dist.all_reduce(ll, op=dist.ReduceOp.SUM, group=group)
        p /= se[..., None]
        ctx.save_for_backward(p, idx, hit)
        return torch.log(se) + mx - ll

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, idx, -(g * hit)[..., None])
        return d, None, None, None
