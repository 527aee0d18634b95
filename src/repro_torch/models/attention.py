"""GQA attention: the full-sequence path (prefill) and the decode path.

Port of the main-path part of ``repro.models.attention``: causal and
sliding-window masks, logit softcap, qk-norm, the local/global rope theta,
the decode path over a plain or ring KV cache.  Not ported yet: the int8 KV
cache (``kv_quant``), cross-attention and the prefix/bidirectional masks.

``attention_seq`` hands causal attention to the hook set by
``set_attention_impl``.  By default the hook is the flash attention wrapper
(``repro_torch.kernels``): on a CUDA tensor it runs the hand-written kernel,
on a CPU tensor its plain version.  With the hook cleared, ``_sdpa`` is the
plain path; it keeps the reference's cast of the probabilities to
``v.dtype`` before the PV product.  Decode attention has no kernel in the
reference and is plain torch here too.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.modules import (ParamModule, init_norm, normal, pdtype,
                                        rms_norm, rope)

NEG_INF = -1e30

_ATTN_IMPL: Optional[Callable] = flash_attention


def set_attention_impl(fn: Optional[Callable]):
    global _ATTN_IMPL
    _ATTN_IMPL = fn


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class Attention(ParamModule):
    """Projections ``wq``, ``wk``, ``wv``, ``wo`` and, with qk-norm,
    ``q_norm`` and ``k_norm``."""


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   device) -> Attention:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = pdtype(cfg)
    p = {
        "wq": normal(generator, (d, h * hd), d ** -0.5, dt, device),
        "wk": normal(generator, (d, k * hd), d ** -0.5, dt, device),
        "wv": normal(generator, (d, k * hd), d ** -0.5, dt, device),
        "wo": normal(generator, (h * hd, d), (h * hd) ** -0.5, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, device)
        p["k_norm"] = init_norm(hd, device)
    return Attention(p)


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == ATTN_LOCAL or not cfg.rope_theta_global:
        return cfg.rope_theta
    return cfg.rope_theta_global


# ---------------------------------------------------------------------------
# masking: mask(q_pos, kv_pos) -> bool allow
# ---------------------------------------------------------------------------
def make_mask_fn(mode: str = "causal", window: int = 0):
    if mode != "causal":
        raise NotImplementedError(f"mask mode {mode!r} is not ported yet")

    def fn(q_pos, kv_pos):
        q = q_pos[:, None]
        kv = kv_pos[None, :]
        allow = kv <= q
        if window:
            allow &= kv > q - window
        allow &= kv >= 0
        return allow
    return fn


def _sdpa(q, k, v, mask, softcap: float, scale: float):
    """q: (B,Sq,K,G,hd)  k,v: (B,Skv,K,hd)  mask: (Sq,Skv) or None."""
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", a, v)


# ---------------------------------------------------------------------------
# full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def attention_seq(p: Attention, x, cfg: ModelConfig, kind: str, positions,
                  mask_mode: str = "causal"):
    """x: (B,S,D) -> (B,S,D); also returns (k, v) for cache building."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    window = cfg.window_size if kind == ATTN_LOCAL else 0
    theta = _theta(cfg, kind)

    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, K, hd)
    v = (x @ p.wv).reshape(B, S, K, hd)
    if hasattr(p, "q_norm"):
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    q = q.reshape(B, S, K, G, hd)
    scale = hd ** -0.5
    if _ATTN_IMPL is not None and mask_mode == "causal":
        o = _ATTN_IMPL(q, k, v, window=window, softcap=cfg.attn_logit_softcap,
                       scale=scale)
    else:
        pos = positions[0] if positions.dim() > 1 else positions
        mask = make_mask_fn(mask_mode, window)(pos, pos)
        o = _sdpa(q, k, v, mask, cfg.attn_logit_softcap, scale)
    o = o.reshape(B, S, H * hd)
    return o @ p.wo, (k, v)


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                    dtype=torch.bfloat16, device="cuda") -> dict:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    L = min(cfg.window_size, seq_len) if kind == ATTN_LOCAL else seq_len
    return {"k": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, L, K, hd), dtype=dtype, device=device)}


def attention_decode(p: Attention, x, cfg: ModelConfig, kind: str,
                     cache: dict, pos: int):
    """x: (B,1,D); cache holds K/V; pos: the current position.

    Writes the new token's K/V into ``cache`` in place (the reference returns
    an updated copy) and returns (out (B,1,D), cache).
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    theta = _theta(cfg, kind)
    scale = hd ** -0.5

    q = (x @ p.wq).reshape(B, 1, H, hd)
    kn = (x @ p.wk).reshape(B, 1, K, hd)
    vn = (x @ p.wv).reshape(B, 1, K, hd)
    if hasattr(p, "q_norm"):
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        kn = rms_norm(kn, p.k_norm, cfg.norm_eps)
    posv = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q = rope(q, posv, theta)
    kn = rope(kn, posv, theta)

    L = cache["k"].shape[1]
    ring = kind == ATTN_LOCAL and cfg.window_size and L <= cfg.window_size
    # The reference writes with lax.dynamic_update_slice, which clamps its
    # start index into range: decoding at pos >= L on a plain cache (right
    # after a prefill of L tokens) overwrites the last slot.  Mirror that.
    idx = pos % L if ring else min(max(pos, 0), L - 1)
    cache["k"][:, idx] = kn[:, 0]
    cache["v"][:, idx] = vn[:, 0]
    k, v = cache["k"], cache["v"]

    slot = torch.arange(L, device=x.device)
    if ring:
        kv_pos = pos - torch.remainder(idx - slot, L)     # absolute positions
        allow = kv_pos >= 0
    else:
        kv_pos = slot
        allow = kv_pos <= pos
        if kind == ATTN_LOCAL:
            allow &= kv_pos > pos - cfg.window_size

    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, 1, K, G, hd).float(),
                     k.float()) * scale
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(allow, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", a, v).reshape(B, 1, H * hd)
    return o @ p.wo, cache


def build_ring_cache(k_full, v_full, window: int) -> dict:
    """Convert full prefill K/V (B,S,K,hd) into the decode ring layout."""
    S = k_full.shape[1]
    if S > window:
        idx = (S - 1) % window
        slot = torch.arange(window, device=k_full.device)
        pos = (S - 1) - torch.remainder(idx - slot, window)
        k_full = k_full.index_select(1, pos)
        v_full = v_full.index_select(1, pos)
    return pack_kv(k_full, v_full)


def pack_kv(k, v) -> dict:
    return {"k": k, "v": v}
