"""Minimal functional optimizers.  Port of ``repro.optim.optimizers``.

* ``adamw``     — f32 m/v (+ optional f32 master weights), decoupled decay.
* ``adafactor`` — factored second moment (f32 row/col vectors).

Params and grads are dicts keyed by parameter name
(``dict(model.named_parameters())``).  ``update(grads, state, params, lr)``
returns ``(params, state, grad_norm)`` as the reference's does, but writes
the new values into the given tensors in place (under ``torch.no_grad``)
and returns the same dicts: JAX builds new arrays, the port keeps one copy
of each.  Each update is the reference's arithmetic in the same dtypes (the
bf16 grad times a Python scalar stays bf16, as a weakly typed scalar leaves
it in JAX), so ``torch.optim.AdamW`` (no master copy, decay applied in
another order) is not used.

AdamW is elementwise: its state mirrors the params, name for name
(``models.weights.params_to_numpy`` stacks it into the reference's tree).

Adafactor works on the reference's tree, whose superblock leaves stack the
R layers' tensors as ``(R, ...)``: given the model's config,
``models.weights.stacked_view`` groups the port's per-layer tensors into
those leaves, and the state ``vs`` is keyed by leaf key
(``blocks/0/attn/wq``) with the reference's shapes (``weights.reference_tree``
gives its ``opt["vs"]``).  So, as in the reference, a leaf of 2 or more
stacked dims is factored over its last two dims (a stacked norm ``(R, D)``
gets ``vr (R,)`` and ``vc (D,)``: a 1-dim layer tensor is factored across
the layers), a 1-dim leaf keeps a full ``v``, and the update's RMS clip
spans the whole leaf.  Without a config every name is a leaf of its own.
The update runs in two passes over chunks of the leading axes that are not
factored (the layers, then the experts) so that no f32 temporary spans a
whole leaf: arctic-480b's stacked ``w_gate`` is 4.5e9 elements a layer.
The first pass updates the moments and sums the squared update, the second
applies the update clipped by the leaf's RMS.

On the sharded model (DTensor params and grads) the same arithmetic runs on
DTensors, under ``distributed.context.replicate_made_tensors``.  Both take
``update_constraint`` ({parameter name: placements}, ``opt_pspecs``' ZeRO
layout through ``distributed.layouts.param_placements``), the reference's
sharding constraint on the update: the state is made at those placements
and each layer's update is computed there and then copied into the
parameter at its own placements.  ``global_norm`` reduces a ``Partial``
grad once and sums each group of equally sharded grads on its shards with
one reduction.  Adafactor's state takes its leaf's placements (past the
layer axis, which is never sharded), and a DTensor leaf's layers are not
cut into chunks.  On plain tensors none of this changes anything.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context
from repro_torch.models import weights


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state, gnorm)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step (int or 0-d tensor) -> lr as an f32 0-d tensor on step's device."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


_CHUNK = 1 << 28  # elements of a chunk's f32 temporaries (1 GiB)


def _reduced(g):
    """A DTensor's ``Partial`` placements reduced (to ``Replicate``), in
    one collective (``context.redistribute``)."""
    if not context.is_dtensor(g) or not any(p.is_partial()
                                             for p in g.placements):
        return g
    from torch.distributed.tensor import Replicate
    return context.redistribute(g, tuple(
        Replicate() if p.is_partial() else p for p in g.placements))


def global_norm(tree: dict):
    """The f32 norm of every leaf together, summed over chunks of ``_CHUNK``
    elements: an f32 copy of a whole leaf (arctic-480b's expert grads, 4.5e9
    elements) does not fit beside the params and grads.  A DTensor leaf is
    summed on its local shard, and the sums of the leaves sharded over the
    same mesh dims are added over those ranks in one reduction (one
    collective over those dims, ``context.summed``)."""
    sums = {}
    for x in tree.values():
        group = None
        if context.is_dtensor(x):
            x = _reduced(x)
            mesh = x.device_mesh
            group = (mesh, tuple(m for m, p in enumerate(x.placements)
                                 if p.is_shard() and mesh.size(m) > 1))
            x = x.to_local()
        sums.setdefault(group, []).extend(
            torch.sum(torch.square(c.float())) for c in x.reshape(-1).split(
                _CHUNK))
    total = 0
    for group, parts in sums.items():
        part = sum(parts)
        if group is not None and group[1]:
            from torch.distributed.tensor import DTensor, Partial, Replicate
            mesh, on = group
            part = context.summed(DTensor.from_local(part, mesh, tuple(
                Partial() if m in on else Replicate()
                for m in range(mesh.ndim)), run_check=False)).to_local()
        total = total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales the grads in place, in their own dtype (an f32 copy of every
    grad at once would add 2 bytes a parameter of live memory for
    nothing); returns (grads, norm before the clip).  ``Partial`` DTensor
    grads are reduced first, and the returned dict holds them."""
    grads = {n: _reduced(g) for n, g in grads.items()}
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _check_grads(grads: dict, params: dict):
    missing = sorted(n for n in params if grads.get(n) is None)
    if missing:
        raise RuntimeError(f"no gradient for {missing}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _device(params: dict):
    """The device of the parameters' data (a DTensor's local shard's)."""
    return context.local_device(next(iter(params.values())))


def _update_fn(update):
    """``update(grads, state, params, lr)`` under ``no_grad`` and
    ``replicate_made_tensors`` of the first parameter."""
    @torch.no_grad()
    def run(grads: dict, st: dict, params: dict, lr):
        with context.replicate_made_tensors(next(iter(params.values()))):
            return update(grads, st, params, lr)
    return run


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0,
          master: bool = True, update_constraint=None) -> Optimizer:
    """``update_constraint``: {parameter name: placements} at which m, v,
    the master copy and each update live (module docstring)."""
    uc = update_constraint or {}

    def init(params: dict) -> dict:
        def placed(t, n):
            return context.redistribute(t, uc.get(n))
        st = {
            "m": {n: placed(torch.zeros_like(p, dtype=torch.float32), n)
                  for n, p in params.items()},
            "v": {n: placed(torch.zeros_like(p, dtype=torch.float32), n)
                  for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params)),
        }
        if master:
            st["master"] = {n: placed(p.detach().float().clone(), n)
                            for n, p in params.items()}
        return st

    @_update_fn
    def update(grads: dict, st: dict, params: dict, lr):
        _check_grads(grads, params)
        grads, gn = clip_by_global_norm(grads, max_grad_norm)
        st["count"] += 1
        c = st["count"].float()
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        for n, p in params.items():
            g, m, v = grads[n], st["m"][n], st["v"][n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1
            vh = v / bc2
            base = st["master"][n] if master else \
                context.redistribute(p.float(), uc.get(n))
            new = base - lr * (mh / (torch.sqrt(vh) + eps)
                               + weight_decay * base)
            new = context.redistribute(new, uc.get(n))
            if master:
                base.copy_(new)
            p.copy_(new)
        return params, st, gn

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum, no master copy)
# ---------------------------------------------------------------------------
def _chunks(n: int, per: int) -> list:
    """Slices of range(n), each of at most ``per`` rows' worth (>= 1 row)."""
    step = max(1, min(n, _CHUNK // max(per, 1)))
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def _state_zeros(shape: tuple, like, place, stacked: bool, drop=None):
    """f32 zeros of ``shape`` on ``like``'s device: an Adafactor moment of a
    leaf of ``len(shape) + (drop is not None)`` dims whose dim ``drop`` was
    averaged out.  Where ``like`` is a DTensor, a DTensor at ``place`` (its
    layer's placements), shifted past R where the leaf is stacked, dim
    ``drop`` replicated and the dims after it moved down one."""
    f32 = dict(dtype=torch.float32)
    if not context.is_dtensor(like):
        return torch.zeros(shape, device=like.device, **f32)
    from torch.distributed.tensor import Replicate, Shard
    nd = len(shape) + (drop is not None)
    drop = None if drop is None else drop % nd
    out = []
    for p in place:
        d = p.dim % (nd - stacked) + stacked if p.is_shard() else None
        if d is None or d == drop:
            out.append(Replicate())
        else:
            out.append(Shard(d - (drop is not None and d > drop)))
    # made whole on each rank and cut (a moment is a leaf less one dim):
    # torch.distributed.tensor.zeros would make it on the mesh's device
    # type, not the parameter's
    return context.redistribute(like.new_zeros(shape, **f32), out)


def _assign(dst, value):
    """``dst.copy_(value)``; a DTensor ``value`` laid out as ``dst`` first (a
    mean over a sharded dim is a partial sum until it is reduced)."""
    dst.copy_(context.redistribute(value, getattr(dst, "placements", None)))


def adafactor(eps: float = 1e-30, clip_thresh: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0,
              cfg: ModelConfig | None = None,
              update_constraint=None) -> Optimizer:
    """``cfg``: the config of the model trained, whose stacked view groups
    its tensors into the reference's leaves (module docstring).
    ``update_constraint``: {parameter name: placements} at which the state
    and each update live."""
    uc = update_constraint or {}

    def leaves(named: dict) -> dict:
        return weights.stacked_view(named, cfg)

    def init(params: dict) -> dict:
        vs = {}
        for key, names in leaves(params).items():
            p = params[names[0]]
            stacked = weights.is_stacked(key)
            shape = ((len(names),) if stacked else ()) + tuple(p.shape)
            place = uc.get(names[0]) or getattr(p, "placements", None)

            def zeros(sub, drop=None):
                return _state_zeros(sub, p, place, stacked, drop)
            if len(shape) >= 2:
                vs[key] = {"vr": zeros(shape[:-1], -1),
                           "vc": zeros(shape[:-2] + shape[-1:], -2)}
            else:
                vs[key] = {"v": zeros(shape)}
        return {"vs": vs,
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    def moments(g, s, beta):
        """Updates the chunk's moments in place; returns its update u (f32)."""
        g2 = torch.square(g).add_(eps)
        if "v" in s:
            _assign(s["v"], beta * s["v"] + (1 - beta) * g2.float())
        else:
            # .float(): beta is a strongly typed f32 in the reference, which
            # promotes the bf16 means to f32 (a 0-d tensor would not)
            _assign(s["vr"], beta * s["vr"] + (1 - beta) * g2.mean(-1).float())
            _assign(s["vc"], beta * s["vc"] + (1 - beta) * g2.mean(-2).float())
        return unclipped(g, s)

    def unclipped(g, s):
        if "v" in s:
            return g * torch.rsqrt(s["v"])
        denom = s["vr"].mean(-1, keepdim=True)
        u = g * torch.rsqrt(s["vr"] / torch.clamp(denom, min=eps))[..., None]
        return u.mul_(torch.rsqrt(s["vc"])[..., None, :])

    def pieces(key, names, grads, params, s):
        """(name, g, p, state views) chunks of the leaf, the name where the
        piece is a whole layer tensor (else None); a leaf whose layer
        tensors have fewer than 2 dims is stacked whole (norms, biases:
        small) and written back by the caller."""
        ps = [params[n] for n in names]
        if ps[0].dim() < 2:
            return [(None if weights.is_stacked(key) else names[0],
                     weights.stack(key, [grads[n] for n in names]),
                     weights.stack(key, ps), s)]
        out = []
        for r, n in enumerate(names):
            sr = {k: v[r] for k, v in s.items()} if weights.is_stacked(key) \
                else s
            g, p = grads[n], params[n]
            if p.dim() == 2 or context.is_dtensor(p):
                out.append((n, g, p, sr))
                continue
            for sl in _chunks(p.shape[0], p[0].numel()):
                out.append((None, g[sl], p[sl],
                            {k: v[sl] for k, v in sr.items()}))
        return out

    @_update_fn
    def update(grads: dict, st: dict, params: dict, lr):
        _check_grads(grads, params)
        grads, gn = clip_by_global_norm(grads, max_grad_norm)
        st["count"] += 1
        beta = 1.0 - st["count"].float() ** -decay_pow
        for key, names in leaves(params).items():
            s = st["vs"][key]
            chunks = pieces(key, names, grads, params, s)
            # pass 1: the moments and the leaf's mean squared update
            sq, n = 0.0, 0
            for _, g, _, sc in chunks:
                u = moments(g, sc, beta)
                sq = sq + torch.sum(torch.square(u), dtype=torch.float64)
                n += u.numel()
            # update clipping (RMS), over the whole leaf
            rms = torch.sqrt((sq / n).float() + 1e-12)
            clip = torch.clamp(rms / clip_thresh, min=1.0)
            # pass 2: apply, in place where the arithmetic is the same
            for name, g, p, sc in chunks:
                pf = context.redistribute(p.float(), uc.get(name))
                u = context.redistribute(unclipped(g, sc).div_(clip),
                                         getattr(pf, "placements", None))
                if weight_decay:
                    u.add_(weight_decay * pf)
                p.copy_(pf.sub_(u.mul_(lr)))
            if params[names[0]].dim() < 2 and weights.is_stacked(key):
                for name, new in zip(names, weights.unstack(key,
                                                            chunks[0][2])):
                    params[name].copy_(context.redistribute(new,
                                                            uc.get(name)))
        return params, st, gn

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, cfg: ModelConfig | None = None,
                   update_constraint=None, **kw) -> Optimizer:
    """``cfg``: the model's config, which Adafactor needs to see the
    reference's stacked leaves (AdamW is elementwise and takes none).
    ``update_constraint``: {parameter name: placements} (module
    docstring)."""
    if name == "adamw":
        return adamw(update_constraint=update_constraint, **kw)
    if name == "adafactor":
        return adafactor(cfg=cfg, update_constraint=update_constraint, **kw)
    raise ValueError(name)
