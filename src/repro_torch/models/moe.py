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

``moe_sharded`` is the reference's expert parallelism: experts over the
``model`` mesh axis, their ff dim over ``data`` (ZeRO-3).  Where the
reference's ``shard_map`` hands its body each rank's block of the inputs
by their in_specs, the port's ``moe_sharded`` takes and returns those
blocks (``distributed.context.local_shard`` cuts them): ``x`` by
``in_spec``, the experts' weights by ``("experts", None, "moe_ff")`` and
``("experts", "moe_ff", None)``, the router whole; ``y`` comes back by
``out_spec``, ``aux`` the same on every rank.  Its collectives run over the
mesh's process groups (``distributed.collectives``).  Both paths dispatch
through ``_dispatch``: the dense path is the sharded one with every expert
local.

``moe_layer`` takes ``moe_sharded`` while sharding rules are active
(``distributed.context.use_rules``) and ``moe_dense`` otherwise, as the
reference's does.  In the sharded model (DTensor parameters, placed by
``distributed.layouts.shard_params``, whose expert specs are the ones
``moe_sharded`` reads) ``moe_layer`` hands ``moe_sharded`` local shards, as
the reference's ``shard_map`` does: x redistributed to its in_spec and
``to_local``, each weight's ``to_local`` (the router whole), and wraps y
(by the out_spec) and aux (replicated) back as DTensors.  The collectives
inside give each rank's result a gradient of its own, the loss being the
sum over ranks; a replicated DTensor is one value with one gradient.  So
the gradient entering y and aux is divided by the number of ranks that
hold the same block of them, and an input replicated over a mesh dim takes
its gradient as a ``Partial`` there (the ranks' contributions summed).
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context
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


def _expert_ffn(bufs, w_gate, w_up, w_down, act):
    h = torch.bmm(bufs, w_gate)
    u = torch.bmm(bufs, w_up)
    return torch.bmm(act(h) * u, w_down)


def _dispatch(xf, gate, idx, C: int, e0: int, e_loc: int, n_experts: int):
    """Sort-based dispatch of the tokens ``xf`` (T, D) to the local experts
    ``e0 .. e0 + e_loc``.  Returns (buf (e_loc, C, D), combine(out_buf) ->
    (T, D))."""
    T, k = idx.shape
    dev = xf.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev))
    slot = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = (slot < C) & (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    tok = order // k
    e_kept, s_kept = sorted_e[keep] - e0, slot[keep]

    buf = xf.new_zeros((e_loc, C, xf.shape[1]))
    buf[e_kept, s_kept] = xf[tok[keep]]

    def combine(out_buf):
        # dropped and other ranks' slots read 0 (the reference's fill)
        contrib = out_buf.new_zeros((T * k, out_buf.shape[-1]))
        contrib[keep] = out_buf[e_kept, s_kept]
        w = gate.reshape(-1)[order][:, None] * keep[:, None]
        vals = (contrib * w).to(xf.dtype)           # in the sorted order
        # back to (token, slot), then each token's slots by ascending expert
        per_tok = torch.empty_like(vals)
        per_tok[order] = vals
        rank = torch.argsort(idx, dim=1, stable=True)
        per_tok = torch.gather(per_tok.reshape(T, k, -1), 1,
                               rank[..., None].expand(T, k, per_tok.shape[-1]))
        y = per_tok[:, 0]
        for j in range(1, k):
            y = y + per_tok[:, j]
        return y

    return buf, combine


def _dispatch_group(p: MoE, xg, gate_g, idx_g, C: int, act):
    """One capacity group on every expert: xg (Tg, D) -> (Tg, D)."""
    E = p.w_gate.shape[0]
    buf, combine = _dispatch(xg, gate_g, idx_g, C, 0, E, E)
    return combine(_expert_ffn(buf, p.w_gate, p.w_up, p.w_down, act))


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


def moe_sharded(p: MoE, x, cfg: ModelConfig, decode: bool = False):
    """Expert parallelism over ``model`` with expert-ff FSDP over ``data``,
    on this rank's blocks (module docstring).

    * train/prefill: tokens stay data-sharded; each rank all-gathers its
      local experts' ff-shards over ``data`` (ZeRO-3 weight gather) and
      processes all its tokens for its experts; outputs are summed over
      ``model`` (reduce-scattered over the sequence where the heads divide
      the axis: the sequence-parallel boundary).
    * decode: tokens are tiny — all-gather *tokens* over data instead, keep
      weights fully sharded (2D expert TP: experts x ff-shard),
      reduce-scatter the partial FFN outputs back, sum over ``model``.
    """
    rules = context.current()
    if rules is None:
        return moe_dense(p, x, cfg)
    m = cfg.moe
    mesh = rules.mesh
    sizes = context.axis_sizes(mesh)
    ep_axis = rules.moe_axis
    ep = sizes[ep_axis]
    fsdp_axis = rules.rules.get("moe_ff")
    if m.n_experts % ep != 0:
        return moe_dense(p, x, cfg)
    da = tuple(a for a in (rules.rules.get("batch") or ()) if a in sizes)
    sp = _sequence_parallel(rules, cfg, decode)
    act = activation(cfg.act)
    k_top = m.experts_per_token
    e_loc = m.n_experts // ep
    e0 = mesh.get_local_rank(ep_axis) * e_loc
    wg, wu, wd = p.w_gate, p.w_up, p.w_down

    B, S, D = x.shape
    xl = x
    if decode and da:
        # 2D-TP: gather tokens over the data axes, partial-ff FFN
        xf = coll.all_gather(xl.reshape(B * S, D), da, 0, mesh)
    else:
        if sp:
            xl = coll.all_gather(xl, ep_axis, 1, mesh)
            S = xl.shape[1]
        xf = xl.reshape(B * S, D)
        if fsdp_axis:
            # ZeRO-3: reassemble this rank's expert ff-shards
            wg = coll.all_gather(wg, fsdp_axis, 2, mesh)
            wu = coll.all_gather(wu, fsdp_axis, 2, mesh)
            wd = coll.all_gather(wd, fsdp_axis, 1, mesh)
    T = xf.shape[0]
    gate, idx, probs = _route(xf, p.router, k_top)
    C = _capacity(T, k_top, m.n_experts, m.capacity_factor)
    buf, combine = _dispatch(xf, gate, idx, C, e0, e_loc, m.n_experts)
    y = combine(_expert_ffn(buf, wg, wu, wd, act))
    if decode and da:
        y = coll.reduce_scatter(y, da, 0, mesh)
        y = coll.all_reduce(y, ep_axis, mesh).reshape(B, S, D)
    elif sp:
        y = coll.reduce_scatter(y.reshape(B, S, D), ep_axis, 1, mesh)
    else:
        y = coll.all_reduce(y, ep_axis, mesh).reshape(B, S, D)
    aux = _aux_loss(probs, idx, m.n_experts)
    aux = coll.all_reduce(aux, mesh.mesh_dim_names, mesh) / mesh.size()
    if hasattr(p, "dense"):
        y = y + mlp(p.dense, x, cfg.act)
    return y, aux


def _sequence_parallel(rules, cfg: ModelConfig, decode: bool) -> bool:
    """The reference's sequence-parallel boundary, gated on head
    divisibility as there (repro/models/moe.py:195-208)."""
    ep = context.axis_sizes(rules.mesh)[rules.moe_axis]
    return (not decode and rules.rules.get("act_seq") == rules.moe_axis
            and cfg.n_heads % ep == 0)


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _to_dtensor(t, mesh, place):
    """A rank's result ``t`` as a DTensor at ``place``, its gradient divided
    by the ranks that hold the same block (module docstring)."""
    from torch.distributed.tensor import DTensor
    n = 1
    for m, pl in enumerate(place):
        if pl.is_replicate():
            n *= mesh.size(m)
    if n > 1:
        t = _GradScale.apply(t, 1.0 / n)
    return DTensor.from_local(t, mesh, place, run_check=False)


def _moe_sharded_dtensor(p: MoE, x, cfg: ModelConfig, decode: bool):
    """``moe_sharded`` in the DTensor model (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate
    rules = context.current()
    mesh = x.device_mesh
    ep = context.axis_sizes(mesh)[rules.moe_axis]
    if cfg.moe.n_experts % ep:
        return _moe_dense_dtensor(p, x, cfg)

    def local(t, place):
        t = t.redistribute(mesh, place)
        return t.to_local(grad_placements=tuple(
            Partial() if pl.is_replicate() else pl for pl in place))
    x_pl = rules.placements(("batch", "act_seq" if _sequence_parallel(
        rules, cfg, decode) else "seq", None))         # its in/out spec
    w_in = rules.placements(("experts", None, "moe_ff"))
    lp = types.SimpleNamespace(
        router=local(p.router, rules.placements((None, None))),
        w_gate=local(p.w_gate, w_in), w_up=local(p.w_up, w_in),
        w_down=local(p.w_down, rules.placements(("experts", "moe_ff",
                                                 None))))
    y, aux = moe_sharded(lp, local(x, x_pl), cfg, decode=decode)
    y = _to_dtensor(y, mesh, x_pl)
    aux = _to_dtensor(aux, mesh, (Replicate(),) * mesh.ndim)
    if hasattr(p, "dense"):
        y = y + _dense_ffn(p, x, cfg, y.placements)
    return y, aux


def _moe_dense_dtensor(p: MoE, x, cfg: ModelConfig):
    """``moe_dense`` in the DTensor model, the reference's fallback where
    the experts do not split over the expert axis: every rank runs it on
    whole copies of the tokens and weights (gathered; their gradients are
    the replicated ones) and keeps its block of the output."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim

    def full(t):
        return t.redistribute(mesh, whole).to_local()
    lp = types.SimpleNamespace(**{n: full(getattr(p, n)) for n in (
        "router", "w_gate", "w_up", "w_down")})
    y, aux = moe_dense(lp, full(x), cfg)
    y = DTensor.from_local(y, mesh, whole, run_check=False).redistribute(
        mesh, x.placements)
    aux = DTensor.from_local(aux, mesh, whole, run_check=False)
    if hasattr(p, "dense"):
        y = y + _dense_ffn(p, x, cfg, y.placements)
    return y, aux


def _dense_ffn(p: MoE, x, cfg: ModelConfig, place):
    """arctic's parallel dense FFN on the DTensor ``x``, its rows gathered
    over ``act_seq`` first, as the layer gathers every sublayer's input
    (``transformer._gathered``; a no-op on the layer's own input), its
    output laid out at ``place`` (the experts' output, which it is added
    to) by a redistribution of its own, whose backward gathers the
    gradient's rows again.  torch 2.11's DTensor refuses to view a
    (B, S, D) tensor cut on its sequence as one dim of rows for a product,
    in the forward (x) and in the backward (the gradient that the add's
    own redistribution would hand the product), where 2.13 lays the view
    out itself (C18)."""
    o = mlp(p.dense, context.constrain(x, ("batch", "seq", None)), cfg.act)
    return context.redistribute(o, place)


def moe_layer(p: MoE, x, cfg: ModelConfig, decode: bool = False):
    """The MoE of a layer: ``moe_sharded`` under active sharding rules (on
    local shards in the DTensor model), ``moe_dense`` otherwise, as the
    reference's."""
    if context.current() is not None:
        if context.is_dtensor(x):
            return _moe_sharded_dtensor(p, x, cfg, decode)
        return moe_sharded(p, x, cfg, decode=decode)
    return moe_dense(p, x, cfg)
