"""Shared building blocks: norms, rotary embeddings, activations, the MLP.

Port of ``repro.models.modules``.  Norms, rope and activations are plain
functions on tensors; parameters live in ``nn.Module`` containers built from
named tensors (``ParamModule``), so that random init (``init_*``) and weights
imported from the reference (``models.weights``) build the same modules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(generator: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn on the generator's device, then moved."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * scale
    return t.to(device=device, dtype=dtype)


class ParamModule(nn.Module):
    """A module whose parameters are the given named tensors.

    The modules hold parameters; the functions named after the reference's
    (``mlp``, ``attention_seq``, ``forward_prefill`` ...) apply them.  The
    port serves only, so parameters do not require gradients.
    """

    def __init__(self, params: dict):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in the ``(1 + scale)`` form, computed in f32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def group_norm_heads(x, scale, bias, n_heads: int, eps: float = 1e-5):
    """GroupNorm with one group per head over the last dim (RWKV ``ln_x``),
    computed in f32 (population variance, as ``jnp.var``)."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, n_heads, d // n_heads)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x.reshape(*lead, d)
    return (x * scale.float() + bias.float()).to(dt)


def init_norm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """NeoX-style (split halves) rope.  x: (..., S, H, hd); positions:
    (..., S) integer.  Angles are computed in f32."""
    hd = x.shape[-1]
    half = hd // 2
    # made on x's device: a host-to-device copy here would stall the stream
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., None].float() * freq                    # (..., S, half)
    ang = ang[..., None, :]                                      # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------
def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_plain": lambda x: F.gelu(x, approximate="tanh"),
        "relu_sq": lambda x: torch.square(F.relu(x)),
    }[name]


class MLP(ParamModule):
    """Gated (``w_gate``, ``w_up``, ``w_down``) or plain (``w_up``,
    ``w_down``) feed-forward block."""


def init_mlp(cfg: ModelConfig, generator: torch.Generator, device,
             d_ff: int | None = None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    if cfg.act == "gelu_plain":  # non-gated
        return MLP({
            "w_up": normal(generator, (d, f), s_in, dt, device),
            "w_down": normal(generator, (f, d), s_out, dt, device),
        })
    return MLP({
        "w_gate": normal(generator, (d, f), s_in, dt, device),
        "w_up": normal(generator, (d, f), s_in, dt, device),
        "w_down": normal(generator, (f, d), s_out, dt, device),
    })


def mlp(p: MLP, x, act_name: str):
    act = activation(act_name)
    if hasattr(p, "w_gate"):
        h = act(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = act(x @ p.w_up)
    return h @ p.w_down
