"""GPipe-style pipeline parallelism over a ``pp`` mesh axis.  Port of
``repro.distributed.pipeline``.

Stages live on consecutive ranks of the ``pp`` axis; microbatches stream
through with the classic (P + M - 1)-tick schedule.  Activations hop
stage-to-stage on a ring of ``dist.batch_isend_irecv`` (the reference's
``ppermute``) — the Databelt Offload phase: the producer pushes its output
state to the node that will run the consumer, ahead of the consumer's turn.

Where the reference's ``shard_map`` takes the stacked stage params and
hands each rank its own stage, ``pipeline_apply`` takes only this rank's
stage params: each rank holds its own stage.  ``pipeline_stages`` splits
stacked ``(R, ...)`` params into stage groups (each rank keeps its row).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.context import axis_sizes


def _ring(state, group, rank: int, pp: int):
    """Sends ``state`` to the next stage's rank and returns the previous
    stage's."""
    if pp == 1:
        return state
    nxt = dist.get_global_rank(group, (rank + 1) % pp)
    prv = dist.get_global_rank(group, (rank - 1) % pp)
    out = torch.empty_like(state)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, state.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, out, prv, group)]):
        w.wait()
    return out


def pipeline_apply(stage_params, x, stage_fn: Callable, mesh,
                   axis: str = "pp", microbatches: int = 0):
    """Run ``stage_fn(params_p, x_mb)`` through P pipeline stages.

    stage_params: this rank's stage params; x: the (B, ...) batch, the same
    on every rank, split into M microbatches along dim 0.  Returns f(x) with
    the same layout as a sequential stack would produce, on every rank.
    """
    pp = axis_sizes(mesh)[axis]
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)
    B = x.shape[0]
    M = microbatches or pp
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mbs = x.reshape(M, B // M, *x.shape[1:])
    state = torch.zeros_like(mbs[0])          # activation in flight
    out = torch.zeros_like(mbs)
    for t in range(pp + M - 1):
        # stage 0 ingests microbatch t (when in window)
        if rank == 0 and t < M:
            state = mbs[t]
        if 0 <= t - rank < M:                 # live: this stage's turn
            state = stage_fn(stage_params, state)
            if rank == pp - 1:                # last stage banks its result
                out[t - (pp - 1)] = state
        # Offload: push the activation to the next stage's rank
        state = _ring(state, group, rank, pp)
    # results live on the last rank; sum so every rank returns them
    if rank != pp - 1:
        out.zero_()
    dist.all_reduce(out, group=group)
    return out.reshape(B, *x.shape[1:])


def pipeline_stages(stacked_params, n_stages: int):
    """Split (R, ...) scanned-superblock params into ``n_stages`` contiguous
    groups: returns params with leading dims (n_stages, R//n_stages, ...)."""
    def split(t):
        R = t.shape[0]
        if R % n_stages:
            raise ValueError(f"{R} layers do not split into {n_stages} "
                             f"stages")
        return t.reshape(n_stages, R // n_stages, *t.shape[1:])
    if isinstance(stacked_params, dict):
        return {k: pipeline_stages(v, n_stages)
                for k, v in stacked_params.items()}
    return split(stacked_params)
