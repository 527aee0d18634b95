"""Collectives over named mesh axes, differentiable: what the reference's
``shard_map`` bodies call as ``lax.all_gather(tiled=True)``,
``lax.psum_scatter(tiled=True)`` and ``lax.psum``.

Each takes one mesh-axis name or a tuple of them; over a tuple the axes
act as one axis in mesh order (the first major), as the reference's do:
a gather runs over the last axis first, a scatter over the first.  The
backward of a gather is a reduce-scatter of the gradient, of a
reduce-scatter a gather, of a sum a sum (the reference's transposes).

Over a group of one rank each is the identity and copies nothing (a view
of its input, so that autograd sees a new tensor), as the reference's
collectives over a size-1 axis compile to nothing.  On more ranks a gather
is one ``all_gather_into_tensor`` along a leading dim, moved into place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _gather(x, dim: int, group):
    n = dist.get_world_size(group)
    if n == 1:
        return x.view_as(x)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x, dim: int, group):
    n = dist.get_world_size(group)
    if n == 1:
        return x.view_as(x)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xs.shape[0]} does not split "
                         f"over {n} ranks")
    out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _sum(x, group):
    if dist.get_world_size(group) == 1:
        return x.view_as(x)
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x, axes, dim: int, mesh):
    """Concatenates the ranks' ``x`` along ``dim`` over the mesh axes."""
    for ax in reversed(_axes(axes)):
        x = _AllGather.apply(x, dim, mesh.get_group(ax))
    return x


def reduce_scatter(x, axes, dim: int, mesh):
    """Sums ``x`` over the mesh axes and keeps this rank's block of
    ``dim``."""
    for ax in _axes(axes):
        x = _ReduceScatter.apply(x, dim, mesh.get_group(ax))
    return x


def all_reduce(x, axes, mesh):
    """Sums ``x`` over the mesh axes."""
    for ax in _axes(axes):
        x = _AllReduce.apply(x, mesh.get_group(ax))
    return x
