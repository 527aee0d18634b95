"""Top-k mixture-of-experts: the port of ``repro.models.moe``'s dense path.

``moe_dense`` is the reference's oracle: tokens are routed to their top-k
experts, sorted by expert (stably, so a token's slots keep their order),
placed into per-expert buffers of ``_capacity`` slots, run through every
expert's gated FFN, and combined with their gate weights.  A token past its
expert's capacity is dropped there (GShard: it keeps the residual path).
``groups`` splits the tokens into contiguous capacity groups, each dropping
on its own.

Where the reference leans on XLA's index semantics the port is explicit:

- ``.at[e, p].set(mode="drop")`` and ``.get(mode="fill")`` with an
  out-of-range index for dropped slots: the port writes and reads only the
  kept slots, selected by a mask.
- ``lax.top_k`` breaks ties toward the lower expert index: the port takes
  the first k of a stable descending sort, which does the same.
- The combine ``zeros.at[tok].add(contrib * w)`` adds each token's k
  contributions one at a time in the activation dtype, in the sorted order,
  which for one token is its experts in ascending order.  The port gathers
  them as (T, k, D) in that order and sums left to right, which is
  deterministic on every device (``index_add_`` on CUDA is atomic, so
  unordered).
- The router's product is f32 in the reference.  The port computes it in
  f64 and rounds to f32, so routing does not depend on PyTorch's TF32
  switches (PyTorch raises where its legacy and new TF32 flags are mixed,
  so a flag set around the product could break a caller using the other).

Expert weights are drawn one expert at a time into a tensor of the
parameter dtype: the f32 transient of a draw is one expert's
(``modules.normal`` draws in f32; arctic's ``w_gate`` in f32 would be 17.9
GB).

``moe_layer`` is ``moe_dense``, as the reference's is without a device mesh.
The sharded path (``moe_sharded``, expert parallelism over a mesh) is not
ported: ``moe_layer`` raises where a multi-process group is initialised
rather than run the dense path on each rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.modules import (MLP, ParamModule, activation, mlp,
                                        normal, pdtype)


class MoE(ParamModule):
    """``router`` (D, E) f32, the experts' ``w_gate`` and ``w_up`` (E, D, F)
    and ``w_down`` (E, F, D), and arctic's parallel dense FFN ``dense``."""

    def __init__(self, params: dict, dense: MLP | None = None):
        super().__init__(params)
        if dense is not None:
            self.dense = dense


def _stacked_normal(generator, n: int, shape, scale: float, dtype, device):
    out = torch.empty((n, *shape), dtype=dtype, device=device)
    for e in range(n):
        out[e] = normal(generator, shape, scale, dtype, device)
    return out


def init_moe(cfg: ModelConfig, generator: torch.Generator, device) -> MoE:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    dt = pdtype(cfg)
    p = {
        "router": normal(generator, (d, e), d ** -0.5, torch.float32, device),
        "w_gate": _stacked_normal(generator, e, (d, f), d ** -0.5, dt, device),
        "w_up": _stacked_normal(generator, e, (d, f), d ** -0.5, dt, device),
        "w_down": _stacked_normal(generator, e, (f, d), f ** -0.5, dt, device),
    }
    dense = None
    if m.dense_residual:
        fd = m.d_ff_dense or cfg.d_ff
        dense = MLP({
            "w_gate": normal(generator, (d, fd), d ** -0.5, dt, device),
            "w_up": normal(generator, (d, fd), d ** -0.5, dt, device),
            "w_down": normal(generator, (fd, d), fd ** -0.5, dt, device),
        })
    return MoE(p, dense)


def _route(x_flat, router, k: int):
    """Returns (gate weights (T,k) f32, expert idx (T,k), probs (T,E))."""
    logits = (x_flat.double() @ router.double()).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx, probs


def _aux_loss(probs, idx, n_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    k = idx.shape[1]
    f = F.one_hot(idx, n_experts).float().sum(1).mean(0) / k
    return n_experts * torch.sum(f * probs.mean(0))


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(T * k / E * cf))
    c = max(c, min(T * k, 8))
    return min(c, T)


def _expert_ffn(bufs, p: MoE, act):
    h = torch.bmm(bufs, p.w_gate)
    u = torch.bmm(bufs, p.w_up)
    return torch.bmm(act(h) * u, p.w_down)


def _dispatch_group(p: MoE, xg, gate_g, idx_g, C: int, act):
    """One capacity group: xg (Tg, D), gate_g and idx_g (Tg, k) -> (Tg, D)."""
    Tg, k = idx_g.shape
    E = p.w_gate.shape[0]
    dev = xg.device
    flat_e = idx_g.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    slot = torch.arange(Tg * k, device=dev) - starts[sorted_e]
    keep = slot < C
    tok = order // k
    e_kept, s_kept = sorted_e[keep], slot[keep]

    buf = xg.new_zeros((E, C, xg.shape[1]))
    buf[e_kept, s_kept] = xg[tok[keep]]
    out_buf = _expert_ffn(buf, p, act)
    contrib = out_buf.new_zeros((Tg * k, out_buf.shape[-1]))
    contrib[keep] = out_buf[e_kept, s_kept]
    w = gate_g.reshape(-1)[order][:, None] * keep[:, None]
    vals = (contrib * w).to(xg.dtype)              # in the sorted order
    # back to (token, slot), then each token's slots by ascending expert
    per_tok = torch.empty_like(vals)
    per_tok[order] = vals
    rank = torch.argsort(idx_g, dim=1, stable=True)
    per_tok = torch.gather(per_tok.reshape(Tg, k, -1), 1,
                           rank[..., None].expand(Tg, k, per_tok.shape[-1]))
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y


def moe_dense(p: MoE, x, cfg: ModelConfig, groups: int = 1):
    """x: (B,S,D) -> (y (B,S,D), aux load-balance loss).  ``groups`` splits
    the tokens into that many contiguous capacity groups."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    if groups < 1 or T % groups != 0:
        raise ValueError(f"groups={groups} must evenly divide the {T} tokens")
    xf = x.reshape(T, D)
    gate, idx, probs = _route(xf, p.router, m.experts_per_token)
    Tg = T // groups
    C = _capacity(Tg, m.experts_per_token, m.n_experts, m.capacity_factor)
    act = activation(cfg.act)
    y = torch.cat([
        _dispatch_group(p, xf[g * Tg:(g + 1) * Tg], gate[g * Tg:(g + 1) * Tg],
                        idx[g * Tg:(g + 1) * Tg], C, act)
        for g in range(groups)]).reshape(B, S, D)
    if hasattr(p, "dense"):
        y = y + mlp(p.dense, x, cfg.act)
    return y, _aux_loss(probs, idx, m.n_experts)


def moe_layer(p: MoE, x, cfg: ModelConfig):
    """The MoE of a layer: ``moe_dense``, as in the reference without a
    mesh (the reference's ``decode`` flag picks a sharded layout only)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "moe_sharded (expert parallelism across processes) is not ported; "
            "moe_layer runs the dense path in one process only")
    return moe_dense(p, x, cfg)
