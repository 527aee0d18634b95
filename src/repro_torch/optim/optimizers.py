"""Minimal functional optimizers.  Port of ``repro.optim.optimizers``.

* ``adamw``     — f32 m/v (+ optional f32 master weights), decoupled decay.
* ``adafactor`` — factored second moment (f32 row/col vectors).

Params, grads and state are dicts keyed by parameter name
(``dict(model.named_parameters())``); the state mirrors the reference's
tree leaf by leaf (``models.weights.params_to_numpy`` stacks it into the
reference's layout).  ``update(grads, state, params, lr)`` returns
``(params, state, grad_norm)`` as the reference's does, but writes the new
values into the given tensors in place (under ``torch.no_grad``) and returns
the same dicts: JAX builds new arrays, the port keeps one copy of each.
Each update is the reference's arithmetic per tensor, in the same dtypes
(the bf16 grad times a Python scalar stays bf16, as a weakly typed scalar
leaves it in JAX), so ``torch.optim.AdamW`` (no master copy, decay applied
in another order) is not used.

The reference factors Adafactor's second moment over the last two dims of
each leaf of its tree, whose superblock leaves are stacked (R, ...) layer
tensors; the port factors each layer's own tensor.  The two agree wherever
a layer tensor has 2 or more dims and its update's RMS clip does not bind,
and differ for stacked 1-dim leaves (norms, biases), which the reference
factors across layers.  No ported config trains with Adafactor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


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


def global_norm(tree: dict):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales the grads in place, in their own dtype (an f32 copy of every
    grad at once would add 2 bytes a parameter of live memory for
    nothing); returns (grads, norm before the clip)."""
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
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0,
          master: bool = True) -> Optimizer:
    def init(params: dict) -> dict:
        st = {
            "m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device),
        }
        if master:
            st["master"] = {n: p.detach().float().clone()
                            for n, p in params.items()}
        return st

    @torch.no_grad()
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
            base = st["master"][n] if master else p.float()
            new = base - lr * (mh / (torch.sqrt(vh) + eps)
                               + weight_decay * base)
            if master:
                base.copy_(new)
            p.copy_(new)
        return params, st, gn

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum, no master copy)
# ---------------------------------------------------------------------------
def adafactor(eps: float = 1e-30, clip_thresh: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    def factored(p):
        return p.dim() >= 2

    def init(params: dict) -> dict:
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"vs": {n: st(p) for n, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=next(iter(params.values())).device)}

    @torch.no_grad()
    def update(grads: dict, st: dict, params: dict, lr):
        _check_grads(grads, params)
        grads, gn = clip_by_global_norm(grads, max_grad_norm)
        st["count"] += 1
        beta = 1.0 - st["count"].float() ** -decay_pow
        for n, p in params.items():
            g, s = grads[n], st["vs"][n]
            g2 = torch.square(g) + eps
            if factored(p):
                # .float(): beta is a strongly typed f32 in the reference,
                # which promotes the bf16 means to f32 (a 0-d tensor would not)
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(-1).float())
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(-2).float())
                denom = s["vr"].mean(-1, keepdim=True)
                u = g * torch.rsqrt(s["vr"] / torch.clamp(denom, min=eps))[
                    ..., None] * torch.rsqrt(s["vc"])[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2.float())
                u = g * torch.rsqrt(s["v"])
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            pf = p.float()
            p.copy_(pf - lr * (u + weight_decay * pf))
        return params, st, gn

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
