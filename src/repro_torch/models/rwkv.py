"""RWKV-6 (Finch): time-mix with data-dependent decay + channel-mix.

Port of the serving part of ``repro.models.rwkv``.  The sequence time-mix
(``time_mix_seq``, in the place of the reference's ``wkv_chunked``) runs the
wkv recurrence through the wkv6 wrapper (``repro_torch.kernels.rwkv6_chunk``):
the hand-written kernel on a CUDA tensor, its plain (chunked) version on a
CPU tensor.  Decode is the single-step update, in plain torch as in the
reference, and updates its cache in place.  ``log w`` is clamped to
[-5, -1e-4] as in the reference.  The exact sequential oracle ``wkv_scan``
belongs to the training path and is not ported yet.

Recurrence (per head, k/v/r in R^hd):
    y_t = r_t^T (S_{t-1} + diag(u*k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
    a = torch.tanh(xxx @ p.tm_w1)
    a = a.reshape(*a.shape[:-1], 5, _LORA_MIX)
    m = torch.einsum("...fl,fld->...fd", a, p.tm_w2)
    mixed = xf[..., None, :] + diff[..., None, :] * (p.mu + m)
    return [mixed[..., i, :].to(x.dtype) for i in range(5)]


def _projections(p: TimeMix, x, xs, n_heads: int, hd: int):
    xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
    lead = x.shape[:-1]
    r = (xr @ p.wr).reshape(*lead, n_heads, hd)
    k = (xk @ p.wk).reshape(*lead, n_heads, hd)
    v = (xv @ p.wv).reshape(*lead, n_heads, hd)
    g = F.silu((xg @ p.wg).float())
    logw = -torch.exp(xw.float() @ p.dw1 @ p.dw2 + p.w0)
    logw = torch.clamp(logw, _LOGW_MIN, _LOGW_MAX)
    logw = logw.reshape(*lead, n_heads, hd)
    return r, k, v, g, logw


def _finish(p: TimeMix, y, g, x_dtype, n_heads: int):
    lead = y.shape[:-2]
    d = y.shape[-2] * y.shape[-1]
    y = y.reshape(*lead, d)
    y = group_norm_heads(y.float(), p.lnx_s, p.lnx_b, n_heads)
    y = (y * g).to(x_dtype)
    return y @ p.wo


def _shifted(x, x_prev):
    first = x_prev[:, None] if x_prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix_seq(p: TimeMix, x, cfg: ModelConfig):
    """x: (B,S,D) -> (out (B,S,D), S_last (B,H,hd,hd) f32, x_last (B,D)),
    as the reference's ``wkv_chunked`` returns them."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    r, k, v, g, logw = _projections(p, x, _shifted(x, None), H, hd)
    y, st = wkv6(r, k, v, logw, p.u)
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
    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]
    st = cache["state"]
    y = torch.einsum("bhi,bhij->bhj", rf, st + p.u[:, :, None] * kv)
    cache["state"].copy_(torch.exp(logw)[..., :, None] * st + kv)
    cache["tm_x"].copy_(xt)
    return _finish(p, y[:, None], g[:, None], x.dtype, H), cache


def channel_mix(p: ChannelMix, x, x_prev=None):
    """x: (B,S,D) (or (B,1,D) in decode with x_prev (B,D) from the cache)
    -> (out (B,S,D), x_last (B,D))."""
    xs = _shifted(x, x_prev)
    diff = xs - x
    xk = x + diff * p.mu_k.to(x.dtype)
    xr = x + diff * p.mu_r.to(x.dtype)
    k = torch.square(F.relu(xk @ p.wk))
    return torch.sigmoid((xr @ p.wr).float()).to(x.dtype) * (k @ p.wv), \
        x[:, -1].clone()
