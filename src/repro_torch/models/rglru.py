"""Griffin recurrent block: temporal conv1d + RG-LRU (real-gated LRU).

Port of ``repro.models.rglru``.  The reference runs the sequence recurrence
as ``lax.associative_scan``; here it goes through the RG-LRU scan wrapper
(``repro_torch.kernels.rglru_scan``): the hand-written kernel on a CUDA
tensor, its plain version on a CPU tensor.  Decode is the single-step
recurrence ``h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t*x_t)`` with
``a_t = exp(-c*softplus(L)*sigmoid(Wa x))``, in plain torch as in the
reference, and updates its cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.modules import ParamModule, normal, pdtype

_C = 8.0  # Griffin's fixed recurrence sharpness


class RGLRU(ParamModule):
    """``w_y``, ``w_x``, ``wa``, ``wi``, ``w_out`` in the param dtype;
    ``conv_w``, ``conv_b``, ``ba``, ``bi``, ``lam`` in f32."""


def init_rglru(cfg: ModelConfig, generator: torch.Generator, device) -> RGLRU:
    d, dr, cw = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
    dt = pdtype(cfg)
    f32 = torch.float32

    def zeros():
        return torch.zeros((dr,), dtype=f32, device=device)
    return RGLRU({
        "w_y": normal(generator, (d, dr), d ** -0.5, dt, device),
        "w_x": normal(generator, (d, dr), d ** -0.5, dt, device),
        "conv_w": normal(generator, (cw, dr), cw ** -0.5, f32, device),
        "conv_b": zeros(),
        "wa": normal(generator, (dr, dr), dr ** -0.5, dt, device),
        "ba": zeros(),
        "wi": normal(generator, (dr, dr), dr ** -0.5, dt, device),
        "bi": zeros(),
        # Lambda init so that a^c=sigmoid(lam)^8 spreads over (0.9, 0.999)
        "lam": torch.linspace(2.2, 6.9, dr, dtype=f32, device=device),
        "w_out": normal(generator, (dr, d), dr ** -0.5, dt, device),
    })


def _gates(p: RGLRU, xi):
    r = torch.sigmoid((xi @ p.wa).float() + p.ba)
    i = torch.sigmoid((xi @ p.wi).float() + p.bi)
    log_a = -_C * F.softplus(p.lam) * r                  # < 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i * xi.float()


def _gelu_f32(t):
    return F.gelu(t.float(), approximate="tanh")


def rglru_seq(p: RGLRU, x, cfg: ModelConfig, h0=None):
    """x: (B,S,D) -> (y (B,S,D), h_last (B,dr) f32, conv_tail (B,cw-1,dr))."""
    B, S, D = x.shape
    cw = cfg.conv_width
    y_br = _gelu_f32(x @ p.w_y)
    xi = x @ p.w_x                                       # (B,S,dr)
    # causal depthwise conv; x's dtype times f32 conv_w promotes to f32
    pad = torch.zeros((B, cw - 1, xi.shape[-1]), dtype=xi.dtype,
                      device=xi.device)
    xp = torch.cat([pad, xi], dim=1)
    conv = sum(xp[:, i:i + S] * p.conv_w[i] for i in range(cw))
    conv = (conv.float() + p.conv_b).to(x.dtype)

    a, b = _gates(p, conv)                               # (B,S,dr) f32
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0.float()
    h = rglru_scan(a, b)
    y = (h * y_br).to(x.dtype) @ p.w_out
    return y, h[:, -1].clone(), xp[:, -(cw - 1):].clone()


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    dr, cw = cfg.d_rnn or cfg.d_model, cfg.conv_width
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, dr), dtype=dtype, device=device)}


def rglru_decode(p: RGLRU, x, cfg: ModelConfig, cache: dict):
    """x: (B,1,D) single step; cache: {'h', 'conv'}.

    Writes the new state into ``cache`` in place (the reference returns a
    new cache) and returns (y (B,1,D), cache).
    """
    y_br = _gelu_f32(x[:, 0] @ p.w_y)
    xi = x[:, 0] @ p.w_x                                 # (B,dr)
    win = torch.cat([cache["conv"], xi[:, None]], dim=1)  # (B,cw,dr)
    conv = torch.einsum("bcd,cd->bd", win.float(), p.conv_w) + p.conv_b
    conv = conv.to(x.dtype)
    a, b = _gates(p, conv)
    h = a * cache["h"] + b
    y = ((h * y_br).to(x.dtype) @ p.w_out)[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return y, cache
