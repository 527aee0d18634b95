"""Shared building blocks: norms, rotary embeddings, activations, the MLP.

Port of ``repro.models.modules``.  Norms, rope and activations are plain
functions on tensors; parameters live in ``nn.Module`` containers built from
named tensors (``ParamModule``), so that random init (``init_*``) and weights
imported from the reference (``models.weights``) build the same modules.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import constrain, flatten, unflatten


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class BlockDraws:
    """A seeded source of weights that ``init_params`` takes in place of a
    ``torch.Generator``: the values of each ``normal`` call come in blocks
    of ``BLOCK``, each block ``N(0, 1)`` from a CPU generator of its own,
    seeded by (seed, call, block), and the blocks are drawn on a thread
    pool.  The values do not depend on the device the weights go to or on
    the number of threads, and a host with n cores draws them about n
    times as fast as one generator's sequence, which cannot be split (a
    full-width model's billion values take a second on 8 cores)."""

    BLOCK = 1 << 20

    def __init__(self, seed: int, threads: int | None = None):
        if not 0 <= seed < 1 << 23:
            raise ValueError(f"seed {seed} outside [0, 2**23)")
        self.seed, self.calls = seed, 0
        self.threads = threads or os.cpu_count() or 1

    def _block_seed(self, call: int, block: int) -> int:
        if call >= 1 << 20 or block >= 1 << 20:
            raise ValueError(f"call {call} or block {block} past 2**20")
        return (self.seed << 40) | (call << 20) | block

    def normal(self, shape, scale: float, dtype, device) -> torch.Tensor:
        """The next call's ``scale * N(0, 1)``, drawn on the host in f32 (the
        product rounded there), then moved and cast."""
        call, self.calls = self.calls, self.calls + 1
        t = torch.empty(shape, dtype=torch.float32)
        flat = t.view(-1)
        n = -(-flat.numel() // self.BLOCK)

        def fill(b):
            g = torch.Generator().manual_seed(self._block_seed(call, b))
            block = flat[b * self.BLOCK:(b + 1) * self.BLOCK]
            block.normal_(generator=g).mul_(scale)
        if n <= 1 or self.threads == 1:
            for b in range(n):
                fill(b)
        else:
            with ThreadPoolExecutor(min(self.threads, n)) as pool:
                list(pool.map(fill, range(n)))
        return t.to(device=device, dtype=dtype)


def normal(generator: torch.Generator | BlockDraws, shape, scale: float,
           dtype, device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn on the generator's device, then moved (a
    ``BlockDraws`` draws on the host).  On the meta device nothing is drawn
    (shapes only; ``generator`` may be None)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if isinstance(generator, BlockDraws):
        return generator.normal(shape, scale, dtype, device)
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * scale
    return t.to(device=device, dtype=dtype)


class ParamModule(nn.Module):
    """A module whose parameters are the given named tensors.

    The modules hold parameters; the functions named after the reference's
    (``mlp``, ``attention_seq``, ``forward_prefill`` ...) apply them.
    Parameters are made without ``requires_grad``, so serving builds no
    autograd graph; ``train.steps.init_train_state`` turns it on for the
    model it trains (``requires_grad_``).
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
    x = unflatten(x.float(), len(lead), (n_heads, d // n_heads))
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = flatten((x - mu) * torch.rsqrt(var + eps), -2)
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


def sinusoidal_pos_emb(seq_len: int, d: int, dtype=torch.float32,
                       device="cpu") -> torch.Tensor:
    """(seq_len, d) sin | cos table, computed in numpy float64 and then
    cast, as the reference computes it."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


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
    h = constrain(h, ("batch", "seq", "ff"))
    return h @ p.w_down
