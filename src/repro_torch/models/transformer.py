"""Model assembly: embeddings, the layer stack, the head.

Port of ``repro.models.transformer`` for attention layers (``global`` and
``local``) with a dense MLP, Griffin RG-LRU layers (``rglru``: recurrent
block + MLP) and RWKV-6 layers (``rwkv``: time-mix + channel-mix).  The
reference scans ``lax.scan`` over superblocks of ``cfg.layer_pattern`` and
then runs the tail; the port keeps one ``Layer`` module per layer in the same
order and walks them in a loop.

The cache keeps the reference's layout, so that both frameworks hand back
the same structure: ``{"blocks": tuple over pattern positions of the
layer's entry with a leading superblock axis R, "tail": tuple of entries}``,
where an attention entry is ``{"k", "v"}``, an RG-LRU entry ``{"h",
"conv"}`` and an RWKV entry ``{"state", "tm_x", "cm_x"}``.

Entry points:
    init_params(cfg, generator, device)            -> Transformer
    forward_prefill(model, cfg, batch)             -> (logits, cache)
    forward_decode(model, cfg, cache, tokens, pos) -> (logits, cache)
    init_cache(cfg, batch, seq_len, dtype, device) -> cache
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV,
                                      ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.modules import (ParamModule, init_mlp, init_norm, mlp,
                                        normal, pdtype, rms_norm)


class Layer(ParamModule):
    """One layer: norms ``ln1``, ``ln2`` (and ``post_ln1``, ``post_ln2`` on
    attention layers with post-norms) as parameters, and by kind the
    reference's sub-blocks: ``attn`` and ``mlp`` (attention), ``rec`` and
    ``mlp`` (RG-LRU), ``tm`` and ``cm`` (RWKV)."""

    def __init__(self, kind: str, norms: dict, blocks: dict):
        super().__init__(norms)
        self.kind = kind
        for name, block in blocks.items():
            self.add_module(name, block)


class Transformer(ParamModule):
    """``embed``, ``final_norm`` (and ``lm_head`` when untied) and the
    layers, in order."""

    def __init__(self, params: dict, layers: list):
        super().__init__(params)
        self.layers = nn.ModuleList(layers)


def check_supported(cfg: ModelConfig):
    """The port covers dense attention, RG-LRU and RWKV stacks so far."""
    kinds = set(cfg.layer_pattern) - {ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV}
    if kinds or cfg.moe is not None or cfg.encoder_decoder or cfg.frontend \
            or cfg.kv_quant:
        raise NotImplementedError(
            f"{cfg.name}: only dense attention, RG-LRU and RWKV layers are "
            f"ported so far")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, kind: str, generator, device) -> Layer:
    norms = {"ln1": init_norm(cfg.d_model, device),
             "ln2": init_norm(cfg.d_model, device)}
    if kind == RGLRU:
        return Layer(kind, norms, {
            "rec": rglru_mod.init_rglru(cfg, generator, device),
            "mlp": init_mlp(cfg, generator, device)})
    if kind == RWKV:
        return Layer(kind, norms, {
            "tm": rwkv_mod.init_time_mix(cfg, generator, device),
            "cm": rwkv_mod.init_channel_mix(cfg, generator, device)})
    if cfg.post_norms:
        norms["post_ln1"] = init_norm(cfg.d_model, device)
        norms["post_ln2"] = init_norm(cfg.d_model, device)
    return Layer(kind, norms, {
        "attn": attn.init_attention(cfg, generator, device),
        "mlp": init_mlp(cfg, generator, device)})


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """Random weights with the reference's shapes, scales and zero norms,
    drawn from ``generator`` (on its own device) and placed on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = pdtype(cfg)
    params = {
        "embed": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                        dev),
        "final_norm": init_norm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (cfg.vocab_size, cfg.d_model),
                                   0.02, dt, dev)
    layers = [_init_layer(cfg, kind, generator, dev)
              for kind in cfg.layer_kinds()]
    return Transformer(params, layers)


# ---------------------------------------------------------------------------
# single-layer application
# ---------------------------------------------------------------------------
def _layer_seq(p: Layer, x, cfg: ModelConfig, kind: str, positions):
    """Returns (x, cache_entry)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == RGLRU:
        o, h_last, conv_tail = rglru_mod.rglru_seq(p.rec, h, cfg)
        x = x + o
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        return x + mlp(p.mlp, h2, cfg.act), {"h": h_last, "conv": conv_tail}
    if kind == RWKV:
        # tm_x and cm_x are the last rows of the ln1 and ln2 outputs (the
        # mixes' inputs), not of the residual
        o, st, tm_x = rwkv_mod.time_mix_seq(p.tm, h, cfg)
        x = x + o
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        o2, cm_x = rwkv_mod.channel_mix(p.cm, h2)
        return x + o2, {"state": st, "tm_x": tm_x, "cm_x": cm_x}
    o, (k, v) = attn.attention_seq(p.attn, h, cfg, kind, positions)
    if cfg.post_norms:
        o = rms_norm(o, p.post_ln1, cfg.norm_eps)
    x = x + o
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    f = mlp(p.mlp, h2, cfg.act)
    if cfg.post_norms:
        f = rms_norm(f, p.post_ln2, cfg.norm_eps)
    x = x + f
    if kind == ATTN_LOCAL and cfg.window_size:
        return x, attn.build_ring_cache(k, v, cfg.window_size)
    return x, attn.pack_kv(k, v)


def _layer_decode(p: Layer, x, cfg: ModelConfig, kind: str, cache, pos):
    """x: (B,1,D); updates ``cache`` in place; returns x."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == RGLRU:
        o, _ = rglru_mod.rglru_decode(p.rec, h, cfg, cache)
        x = x + o
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        return x + mlp(p.mlp, h2, cfg.act)
    if kind == RWKV:
        o, _ = rwkv_mod.time_mix_decode(p.tm, h, cfg, cache)
        x = x + o
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        o2, cm_x = rwkv_mod.channel_mix(p.cm, h2, cache["cm_x"])
        cache["cm_x"].copy_(cm_x)
        return x + o2
    o, _ = attn.attention_decode(p.attn, h, cfg, kind, cache, pos)
    if cfg.post_norms:
        o = rms_norm(o, p.post_ln1, cfg.norm_eps)
    x = x + o
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    f = mlp(p.mlp, h2, cfg.act)
    if cfg.post_norms:
        f = rms_norm(f, p.post_ln2, cfg.norm_eps)
    return x + f


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _layer_cache(cache: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer i's entry of a cache: views into the stacked block leaves."""
    R, P = cfg.n_superblocks, cfg.pattern_len
    if i < R * P:
        r, j = divmod(i, P)
        return {name: t[r] for name, t in cache["blocks"][j].items()}
    return cache["tail"][i - R * P]


def _run_stack(model: Transformer, x, cfg: ModelConfig, positions):
    """All layers in order. Returns (x, cache)."""
    caches = []
    for layer in model.layers:
        x, c = _layer_seq(layer, x, cfg, layer.kind, positions)
        caches.append(c)
    R, P = cfg.n_superblocks, cfg.pattern_len
    blocks = tuple(
        {name: torch.stack([caches[r * P + j][name] for r in range(R)])
         for name in caches[j]}
        for j in range(P)) if R else ()
    return x, {"blocks": blocks, "tail": tuple(caches[R * P:])}


def _embed(model: Transformer, cfg: ModelConfig, tokens):
    x = F.embedding(tokens, model.embed)
    if cfg.embedding_scale:
        # the reference casts sqrt(d_model) to the activation dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(model: Transformer, cfg: ModelConfig, x):
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    w = model.embed if cfg.tie_embeddings else model.lm_head
    logits = x @ w.t()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.float() / c)).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def forward_prefill(model: Transformer, cfg: ModelConfig, batch):
    """batch["tokens"]: (B,S) integer -> (last-position logits (B,1,V),
    cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(model, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, cache = _run_stack(model, x, cfg, positions)
    return _unembed(model, cfg, x[:, -1:]), cache


def forward_decode(model: Transformer, cfg: ModelConfig, cache, tokens, pos):
    """tokens: (B,1); pos: int; cache from init_cache or prefill.

    The cache's tensors are updated in place; the returned cache holds them.
    """
    pos = int(pos)
    x = _embed(model, cfg, tokens)
    for i, layer in enumerate(model.layers):
        x = _layer_decode(layer, x, cfg, layer.kind, _layer_cache(cache, cfg, i),
                          pos)
    logits = _unembed(model, cfg, x)
    blocks = cache["blocks"] if cfg.n_superblocks else ()
    return logits, {"blocks": blocks, "tail": cache["tail"]}


def _kind_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                dtype, device) -> dict:
    if kind == RGLRU:
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    if kind == RWKV:
        return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device)
    return attn.init_attn_cache(cfg, kind, batch, seq_len, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    R = cfg.n_superblocks
    blocks = []
    for kind in cfg.layer_pattern:
        one = _kind_cache(cfg, kind, batch, seq_len, dtype, dev)
        blocks.append({name: torch.zeros((R,) + tuple(t.shape), dtype=t.dtype,
                                         device=dev) for name, t in one.items()}
                      if R else one)
    tail = tuple(_kind_cache(cfg, kind, batch, seq_len, dtype, dev)
                 for kind in cfg.tail_pattern)
    return {"blocks": tuple(blocks), "tail": tail}
