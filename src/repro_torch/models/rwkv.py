"""RWKV-6 (Finch): time-mix with data-dependent decay + channel-mix.

Port of the serving part of ``repro.models.rwkv``.  The sequence time-mix
(``time_mix_seq``, in the place of the reference's ``wkv_chunked``) runs the
wkv recurrence through the wkv6 wrapper (``repro_torch.kernels.rwkv6_chunk``):
the hand-written kernel on a CUDA tensor, its plain (chunked) version on a
CPU tensor.  Decode is the single-step update, in plain torch as in the
reference, and updates its cache in place.  ``log w`` is clamped to
[-5, -1e-4] as in the reference.  ``wkv_scan`` is the reference's exact
sequential oracle, a loop over time in plain torch, which
``forward_train(seq_exact=True)`` runs.

Under DTensor, where the input's rows are cut as the residual stream's
(``act_seq``: ``context.rows_cut``), the mixes run each rank's own rows, as
the reference's partitioner does: the token shift takes the row before a
rank's block from the rank before it (``_shifted_rows``), and the
products whose rows the reference keeps cut run there against the whole
weight (``context.on_rows``: the time mix's LoRAs and its five d x d
projections, the channel mix's receptance); only the wkv6 lays its
inputs out by heads, and its output comes back to the rows.  The channel
mix's ``wk`` and ``wv`` stay split on ``ff`` over all rows (Megatron), as
in the reference.  A decode step's token is whole over ``model`` and its
cached shift cut on the model dim: the LoRAs run on each rank's block of
that dim against the small weights cut the same way (``context.cut_as``,
their partial sums reduced by ``context.reduced``), and the recurrence on
each rank's rows and heads (``run_local``).

Recurrence (per head, k/v/r in R^hd):
    y_t = r_t^T (S_{t-1} + diag(u*k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (ROWS, axis_size, constrain,
                                             cut_as, flatten, grad_like,
                                             is_dtensor, on_rows,
                                             redistribute, reduced,
                                             replicate_dim, replicated,
                                             row_block, rows_cut, run_local,
                                             unflatten)
from repro_torch.kernels.rwkv6_chunk import wkv6
from repro_torch.models.modules import (ParamModule, group_norm_heads, normal,
                                        pdtype)

_LORA_MIX = 32
_LORA_DECAY = 64
_LOGW_MIN, _LOGW_MAX = -5.0, -1e-4


class TimeMix(ParamModule):
    """Token-shift mixes ``mu_x``, ``mu``, LoRA ``tm_w1``, ``tm_w2``, decay
    ``w0``, ``dw1``, ``dw2``, bonus ``u``, ``ln_x`` ``lnx_s``, ``lnx_b`` (all
    f32) and projections ``wr``, ``wk``, ``wv``, ``wg``, ``wo``."""


class ChannelMix(ParamModule):
    """``mu_k``, ``mu_r`` (f32) and ``wk``, ``wv``, ``wr``."""


def init_time_mix(cfg: ModelConfig, generator: torch.Generator,
                  device) -> TimeMix:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = pdtype(cfg)
    f32 = torch.float32
    return TimeMix({
        "mu_x": torch.zeros((d,), dtype=f32, device=device),
        "mu": torch.zeros((5, d), dtype=f32, device=device),   # r,k,v,w,g
        "tm_w1": normal(generator, (d, 5 * _LORA_MIX), 1e-2, f32, device),
        "tm_w2": normal(generator, (5, _LORA_MIX, d), 1e-2, f32, device),
        "w0": torch.linspace(-1.0, 1.5, d, dtype=f32, device=device),
        "dw1": normal(generator, (d, _LORA_DECAY), 1e-2, f32, device),
        "dw2": normal(generator, (_LORA_DECAY, d), 1e-2, f32, device),
        "u": normal(generator, (h, hd), 1e-2, f32, device),
        "wr": normal(generator, (d, d), d ** -0.5, dt, device),
        "wk": normal(generator, (d, d), d ** -0.5, dt, device),
        "wv": normal(generator, (d, d), d ** -0.5, dt, device),
        "wg": normal(generator, (d, d), d ** -0.5, dt, device),
        "wo": normal(generator, (d, d), d ** -0.5, dt, device),
        "lnx_s": torch.ones((d,), dtype=f32, device=device),
        "lnx_b": torch.zeros((d,), dtype=f32, device=device),
    })


def init_channel_mix(cfg: ModelConfig, generator: torch.Generator,
                     device) -> ChannelMix:
    d, f = cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)
    return ChannelMix({
        "mu_k": torch.zeros((d,), dtype=torch.float32, device=device),
        "mu_r": torch.zeros((d,), dtype=torch.float32, device=device),
        "wk": normal(generator, (d, f), d ** -0.5, dt, device),
        "wv": normal(generator, (f, d), f ** -0.5, dt, device),
        "wr": normal(generator, (d, d), d ** -0.5, dt, device),
    })


def _ddlerp(p: TimeMix, x, xs):
    """Data-dependent token-shift interpolation -> xr, xk, xv, xw, xg."""
    diff = (xs - x).float()
    xf = x.float()
    xxx = xf + diff * p.mu_x
    a = reduced(xxx @ cut_as(p.tm_w1, 0, xxx, -1))
    a = torch.tanh(grad_like(a)).reshape(*a.shape[:-1], 5, _LORA_MIX)
    m = torch.einsum("...fl,fld->...fd", a, cut_as(p.tm_w2, 2, diff, -1))
    mixed = xf[..., None, :] + diff[..., None, :] * (p.mu + m)
    return [mixed[..., i, :].to(x.dtype) for i in range(5)]


def _projections(p: TimeMix, x, xs, n_heads: int, hd: int):
    xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
    nd = x.dim() - 1
    r = unflatten(xr @ p.wr, nd, (n_heads, hd))
    k = unflatten(xk @ p.wk, nd, (n_heads, hd))
    v = unflatten(xv @ p.wv, nd, (n_heads, hd))
    g = F.silu((xg @ p.wg).float())
    xw = xw.float()
    lora = grad_like(reduced(xw @ cut_as(p.dw1, 0, xw, -1)))
    logw = -torch.exp(lora @ cut_as(p.dw2, 1, xw, -1) + p.w0)
    logw = torch.clamp(logw, _LOGW_MIN, _LOGW_MAX)
    logw = unflatten(logw, nd, (n_heads, hd))
    return r, k, v, g, logw


def _finish(p: TimeMix, y, g, x_dtype, n_heads: int):
    y = flatten(y, -2)
    y = group_norm_heads(y.float(), p.lnx_s, p.lnx_b, n_heads)
    y = (y * g).to(x_dtype)
    return y @ p.wo


def _shifted(x, x_prev):
    first = x_prev[:, None] if x_prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _shift_local(x, tails, *, j: int):
    """Block ``j`` of the rows (B, s, D) shifted by one: its first row is
    the last row of block j - 1 (``tails`` (B, blocks, D)), zero for the
    first block.  Every block reads ``tails`` (the first its zero row), so
    that every rank's backward issues the same collectives."""
    return torch.cat([_shifted(tails, None)[:, j:j + 1], x[:, :-1]], dim=1)


def _shifted_rows(x):
    """The token shift of the DTensor x (B,S,D) whose rows are cut
    (``rows_cut``) -> (x shifted by one row, a zero first row; x's last
    row (B,D)).  Each rank's block needs one row of the block before it:
    the blocks' last rows are gathered (B x blocks x D, no more), and the
    gradient of the row a rank lent comes back summed."""
    tails = run_local("rwkv token shift", lambda t: t[:, -1:], {"x": x},
                      {"x": ROWS}, ROWS)
    tails = replicate_dim(tails, 1)
    xs = run_local("rwkv token shift",
                   functools.partial(_shift_local, j=row_block(x)),
                   {"x": x, "tails": tails},
                   {"x": ROWS, "tails": {"batch": 0}}, ROWS)
    return xs, tails[:, -1]


def _weights_on_rows(name: str, fn, p, weights: tuple, *rows, n_out=1):
    """``fn(p', *rows)`` on each rank's rows (``context.on_rows``), where
    ``p'`` holds the named ``weights`` of ``p`` whole."""
    def local(*ts):
        return fn(SimpleNamespace(**dict(zip(weights, ts[len(rows):]))),
                  *ts[:len(rows)])
    return on_rows(name, local, rows, {n: getattr(p, n) for n in weights},
                   n_out)


_PROJECTION_WEIGHTS = ("mu_x", "mu", "tm_w1", "tm_w2", "w0", "dw1", "dw2",
                       "wr", "wk", "wv", "wg")
_FINISH_WEIGHTS = ("lnx_s", "lnx_b", "wo")


def _wkv6_block(r, k, v, logw, u):
    """One rank's block of rows (B, s, H, hd): the wkv6 from a zero state
    -> (y, its final state (B, 1, H, hd, hd), its summed logw (B, 1, H,
    hd))."""
    y, st = wkv6(r, k, v, logw, u)
    return y, st[:, None], logw.float().sum(1, keepdim=True)


def _carry_in(y, r, logw, states, decays, *, j: int):
    """Block ``j``'s output with the state carried into it, and the state
    after it: the blocks' final states from zero ``states`` (B, n, H, hd,
    hd) and summed logw ``decays`` (B, n, H, hd) make the incoming states
    S_in(0) = 0, S_in(i + 1) = exp(L_i) * S_in(i) + S_i (the decay on the
    key dim), of which step t of block j sees S_in(j) decayed by exp(sum
    of its logw before t), as ``time_mix_seq`` adds a ``state0``.  Every
    rank runs the whole chain and takes its own entries: its graph reads
    every block's state and decay, so that every rank's backward issues
    the same collectives."""
    carried = [torch.zeros_like(states[:, 0])]
    for i in range(states.shape[1]):
        carried.append(torch.exp(decays[:, i])[..., None] * carried[-1] +
                       states[:, i])
    carried = torch.stack(carried, 1)
    lw = logw.float()
    y = y + torch.einsum("bshi,bhij->bshj",
                         r.float() * torch.exp(torch.cumsum(lw, 1) - lw),
                         carried[:, j])
    return y, carried[:, j + 1:j + 2]


def _wkv6_rows(r, k, v, logw, u):
    """The wkv6 of the DTensors r, k, v, logw (B,S,H,hd) at the rows' cuts
    (``rows_cut``) where ``model`` does not divide the heads -> (y (B,S,H,hd)
    at the same cuts, the final state (B,H,hd,hd)).  Each rank runs the
    kernel on its own block of rows from a zero state (``run_local``); the
    blocks' final states and summed logw, (B, H, hd, hd) and (B, H, hd) f32
    a rank, are gathered over the blocks' ranks, and each rank adds the
    state carried into its block (``_carry_in``), as the reference's
    partitioner splits its chunked scan over ``model``.  The sequence's
    final state is the last block's.  Gradients flow through the kernel's
    autograd function, the gather and the correction; the kernel's
    contract does not change."""
    u = replicated(u)
    y, states, decays = run_local(
        "the wkv6 kernel", _wkv6_block,
        {"r": r, "k": k, "v": v, "logw": logw, "u": u},
        dict.fromkeys(("r", "k", "v", "logw"), ROWS) | {"u": {}},
        (ROWS, ROWS, ROWS))
    states, decays = replicate_dim(states, 1), replicate_dim(decays, 1)
    batch = {"batch": 0}
    y, out = run_local(
        "rwkv state carry", functools.partial(_carry_in, j=row_block(r)),
        {"y": y, "r": r, "logw": logw, "states": states, "decays": decays},
        {"y": ROWS, "r": ROWS, "logw": ROWS, "states": batch,
         "decays": batch}, (ROWS, ROWS))
    return y, replicate_dim(out, 1)[:, -1]


def time_mix_seq(p: TimeMix, x, cfg: ModelConfig, state0=None, x_prev=None):
    """x: (B,S,D) -> (out (B,S,D), S_last (B,H,hd,hd) f32, x_last (B,D)),
    as the reference's ``wkv_chunked`` returns them.

    The kernel starts from a zero state; a ``state0`` (B,H,hd,hd) is carried
    in outside it: step t sees it decayed by exp(sum of logw before t), and
    the final state holds it decayed by exp(sum of all logw).
    """
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    rows = x_prev is None and rows_cut(x)
    if rows:
        xs, x_last = _shifted_rows(x)
        r, k, v, g, logw = _weights_on_rows(
            "rwkv time mix", functools.partial(_projections, n_heads=H,
                                               hd=hd),
            p, _PROJECTION_WEIGHTS, x, xs, n_out=5)
    else:
        r, k, v, g, logw = _projections(p, x, _shifted(x, x_prev), H, hd)
        x_last = x[:, -1].clone()
    if rows and H % axis_size("model"):
        # ``model`` does not divide the heads: each rank the wkv of its own
        # block of rows, the state carried across the blocks
        y, st = _wkv6_rows(r, k, v, logw, p.u)
    else:
        # the kernel cannot split the sequence, which the residual stream
        # shards (act_seq): its inputs are laid out by heads first
        r, k, v, logw = (constrain(t, ("batch", "seq", "heads", None))
                         for t in (r, k, v, logw))
        y, st = wkv6(r, k, v, logw, p.u)
    if state0 is not None:
        lp = torch.cumsum(logw, dim=1)                     # (B,S,H,hd)
        y = y + torch.einsum("bshi,bhij->bshj", r.float() * torch.exp(lp - logw),
                             state0)
        st = torch.exp(lp[:, -1])[..., None] * state0 + st
    if rows:
        # back to the rows (an all-to-all) for the norm, the gate and wo
        return _weights_on_rows(
            "rwkv time mix", functools.partial(_finish, x_dtype=x.dtype,
                                               n_heads=H),
            p, _FINISH_WEIGHTS, redistribute(y, x.placements), g), st, x_last
    return _finish(p, y, g, x.dtype, H), st, x_last


def wkv_scan(p: TimeMix, x, cfg: ModelConfig, state0=None, x_prev=None):
    """The exact sequential recurrence, one step at a time in f32.  Same
    arguments and results as ``time_mix_seq``."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    r, k, v, g, logw = _projections(p, x, _shifted(x, x_prev), H, hd)
    st = state0 if state0 is not None else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, st + p.u[:, :, None] * kv))
        st = torch.exp(logw[:, t])[..., :, None] * st + kv
    y = torch.stack(ys, dim=1)                               # (B,S,H,hd)
    return _finish(p, y, g, x.dtype, H), st, x[:, -1].clone()


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {
        "state": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                             device=device),
        "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _decode_step(r, k, v, logw, u, state):
    """One step of the recurrence: r, k, v, logw (B,H,hd), the state
    (B,H,hd,hd) f32 -> (y (B,H,hd), the new state)."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", rf, state + u[:, :, None] * kv)
    return y, torch.exp(logw)[..., :, None] * state + kv


def time_mix_decode(p: TimeMix, x, cfg: ModelConfig, cache: dict):
    """x: (B,1,D) single step; cache: {'state', 'tm_x', ...}.

    Writes the new ``state`` and ``tm_x`` into ``cache`` in place (the
    reference returns them) and returns (out (B,1,D), cache).
    """
    B, _, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    xt = x[:, 0]
    r, k, v, g, logw = _projections(p, xt, cache["tm_x"], H, hd)
    st = cache["state"]
    if is_dtensor(st):
        # each rank its own rows and heads (``run_local``; every head where
        # ``model`` does not divide them): DTensor's einsum would flatten a
        # batch and heads cut over three mesh dims (``multipod``) into
        # strided shards, minutes an op to propagate.  The new state goes
        # back to the cache's placements, which an in-place copy keeps
        heads = {"batch": 0, "heads": 1}
        y, new = run_local(
            "rwkv decode step", _decode_step,
            {n: constrain(t, ("batch", "heads", None)) for n, t in
             (("r", r), ("k", k), ("v", v), ("logw", logw))} |
            {"u": p.u,
             "state": constrain(st, ("batch", "heads", None, None))},
            dict.fromkeys(("r", "k", "v", "logw", "state"), heads) |
            {"u": {"heads": 0}}, (heads, heads))
        new = redistribute(new, st.placements)
    else:
        y, new = _decode_step(r, k, v, logw, p.u, st)
    st.copy_(new)
    cache["tm_x"].copy_(xt)
    return _finish(p, y[:, None], g[:, None], x.dtype, H), cache


def _mixes(p: ChannelMix, x, xs):
    """The channel mix's key input and its receptance gate."""
    diff = xs - x
    xk = x + diff * p.mu_k.to(x.dtype)
    xr = x + diff * p.mu_r.to(x.dtype)
    return xk, torch.sigmoid(grad_like(xr @ p.wr).float()).to(x.dtype)


def channel_mix(p: ChannelMix, x, x_prev=None):
    """x: (B,S,D) (or (B,1,D) in decode with x_prev (B,D) from the cache)
    -> (out (B,S,D), x_last (B,D)).  Rows cut (module docstring): the
    gate on each rank's rows, the keys' input gathered for ``wk`` and
    ``wv`` (split on ``ff``), their product reduce-scattered to the
    rows."""
    if x_prev is None and rows_cut(x):
        xs, x_last = _shifted_rows(x)
        xk, gate = _weights_on_rows("rwkv channel mix", _mixes, p,
                                    ("mu_k", "mu_r", "wr"), x, xs, n_out=2)
        k = torch.square(F.relu(replicate_dim(xk, 1) @ p.wk))
        return gate * redistribute(k @ p.wv, x.placements), x_last
    xk, gate = _mixes(p, x, _shifted(x, x_prev))
    k = torch.square(F.relu(xk @ p.wk))
    return gate * (k @ p.wv), x[:, -1].clone()
