"""Model assembly: embeddings, the layer stack, the head.

Port of ``repro.models.transformer`` for all ten of the reference's
architectures: attention layers (``global`` and ``local``) with a dense MLP
or a mixture of experts (``models.moe``), Griffin RG-LRU layers (``rglru``:
recurrent block + MLP), RWKV-6 layers (``rwkv``: time-mix + channel-mix),
whisper's encoder-decoder (a bidirectional encoder over precomputed frame
embeddings through ``frontend_proj``, and decoder layers with
cross-attention, ``ln_x`` and ``xattn``; sinusoidal positions, no rope) and
paligemma's vision prefix (precomputed patch embeddings through
``frontend_proj``, prepended under a prefix-LM mask).  The reference scans
``lax.scan`` over superblocks of ``cfg.layer_pattern`` and then runs the
tail; the port keeps one ``Layer`` module per layer in the same order and
walks them in a loop.

The cache keeps the reference's layout, so that both frameworks hand back
the same structure: ``{"blocks": tuple over pattern positions of the
layer's entry with a leading superblock axis R, "tail": tuple of entries}``,
where an attention entry is ``{"k", "v"}`` (int8 ``k``, ``v`` with f32
``ksc``, ``vsc`` under ``cfg.kv_quant``; with the encoder's ``ck``, ``cv``
on an encoder-decoder), an RG-LRU entry ``{"h", "conv"}`` and an RWKV entry
``{"state", "tm_x", "cm_x"}``.

``forward_train`` runs the same layers without building caches and checkpoints
each superblock of ``cfg.layer_pattern`` as the reference's ``_remat_wrap``
does: ``remat="full"`` recomputes the block in backward
(``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of its weight
matmuls and recomputes the rest, ``"none"`` keeps everything.  Remat changes
memory, not values.

Entry points:
    init_params(cfg, generator, device)            -> Transformer
    forward_train(model, cfg, batch, seq_exact)    -> (logits, aux)
    forward_prefill(model, cfg, batch)             -> (logits, cache)
    forward_decode(model, cfg, cache, tokens, pos) -> (logits, cache)
    init_cache(cfg, batch, seq_len, dtype, device) -> cache

``batch`` is the reference's (``models.io.make_batch``): ``tokens``, and
``frames`` (whisper) or ``patches`` (paligemma).

The sharded model is this one with DTensor parameters
(``distributed.layouts.shard_params``), batch and cache, under
``distributed.context.use_rules``: ``constrain`` lays the activations out
at the reference's places (the residual ``("batch", "act_seq", None)``
after each layer and after the embedding, the logits ``("batch", None,
"vocab")``, decode's input ``("batch", "seq", None)``; the MLP's hidden,
attention's q, k, v and output and the RG-LRU's input in their modules),
and the entry points run under ``replicate_made_tensors``, so that the
tensors the model makes itself count as replicated.  With plain tensors
none of it changes anything.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV,
                                      ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.distributed.context import (constrain, grad_like,
                                             is_dtensor, on_rows,
                                             replicate_made_tensors,
                                             rows_cut, rows_product)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.modules import (BlockDraws, ParamModule, init_mlp,
                                        init_norm, mlp, normal, pdtype,
                                        rms_norm, sinusoidal_pos_emb)


class Layer(ParamModule):
    """One layer: norms ``ln1``, ``ln2`` (and ``post_ln1``, ``post_ln2`` on
    attention layers with post-norms, ``ln_x`` on decoder layers with
    cross-attention) as parameters, and by kind the reference's sub-blocks:
    ``attn`` and ``mlp`` or ``moe`` (attention; ``xattn`` with
    cross-attention), ``rec`` and ``mlp`` (RG-LRU), ``tm`` and ``cm``
    (RWKV)."""

    def __init__(self, kind: str, norms: dict, blocks: dict):
        super().__init__(norms)
        self.kind = kind
        for name, block in blocks.items():
            self.add_module(name, block)


class Transformer(ParamModule):
    """``embed``, ``final_norm`` (and ``lm_head`` when untied,
    ``frontend_proj`` with a frontend, ``enc_norm`` with an encoder), the
    layers, in order, and an encoder-decoder's encoder layers
    ``enc_blocks``."""

    def __init__(self, params: dict, layers: list, enc_blocks: list = ()):
        super().__init__(params)
        self.layers = nn.ModuleList(layers)
        if enc_blocks:
            self.enc_blocks = nn.ModuleList(enc_blocks)


def check_supported(cfg: ModelConfig):
    kinds = set(cfg.layer_pattern) - {ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV}
    if kinds:
        raise NotImplementedError(f"{cfg.name}: unknown layer kinds {kinds}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, kind: str, generator, device,
                cross: bool = False) -> Layer:
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
    blocks = {"attn": attn.init_attention(cfg, generator, device)}
    if cfg.moe is not None:
        blocks["moe"] = moe_mod.init_moe(cfg, generator, device)
    else:
        blocks["mlp"] = init_mlp(cfg, generator, device)
    if cross:
        norms["ln_x"] = init_norm(cfg.d_model, device)
        blocks["xattn"] = attn.init_attention(cfg, generator, device,
                                              cross=True)
    return Layer(kind, norms, blocks)


def init_params(cfg: ModelConfig, generator: torch.Generator | BlockDraws,
                device="cuda") -> Transformer:
    """Random weights with the reference's shapes, scales and zero norms,
    drawn from ``generator`` (on its own device; a ``BlockDraws`` on the
    host) and placed on ``device``."""
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
    layers = [_init_layer(cfg, kind, generator, dev, cfg.encoder_decoder)
              for kind in cfg.layer_kinds()]
    enc_blocks = []
    if cfg.encoder_decoder:
        enc_blocks = [_init_layer(cfg, ATTN_GLOBAL, generator, dev)
                      for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = init_norm(cfg.d_model, dev)
    if cfg.frontend:
        params["frontend_proj"] = normal(
            generator, (cfg.d_model, cfg.d_model), cfg.d_model ** -0.5, dt,
            dev)
    return Transformer(params, layers, enc_blocks)


# ---------------------------------------------------------------------------
# single-layer application
# ---------------------------------------------------------------------------
def _layer_seq(p: Layer, x, cfg: ModelConfig, kind: str, positions,
               mask_mode: str = "causal", prefix_len: int = 0, enc_out=None,
               want_cache: bool = True, seq_exact: bool = False):
    """Returns (x, aux, cache_entry): ``aux`` is the MoE load-balance loss
    (0.0 without MoE); the entry is None without ``want_cache``."""
    hn = rms_norm(x, p.ln1, cfg.norm_eps)
    h = _gathered(hn)
    if kind == RGLRU:
        o, h_last, conv_tail = rglru_mod.rglru_seq(p.rec, h, cfg)
        x = x + _scattered(o)
        h2 = _gathered(rms_norm(x, p.ln2, cfg.norm_eps))
        return _residual(x + _scattered(mlp(p.mlp, h2, cfg.act))), 0.0, \
            {"h": h_last, "conv": conv_tail}
    if kind == RWKV:
        # tm_x and cm_x are the last rows of the ln1 and ln2 outputs (the
        # mixes' inputs), not of the residual.  The mixes take their input
        # as the residual stream lays it out (``act_seq``): each rank runs
        # its own rows, as the reference's partitioner does
        # (``rwkv.time_mix_seq``)
        if seq_exact:
            o, st, tm_x = rwkv_mod.wkv_scan(p.tm, h, cfg)
        else:
            o, st, tm_x = rwkv_mod.time_mix_seq(p.tm, hn, cfg)
        x = x + _scattered(o)
        o2, cm_x = rwkv_mod.channel_mix(p.cm, rms_norm(x, p.ln2,
                                                        cfg.norm_eps))
        return _residual(x + _scattered(o2)), 0.0, {
            "state": st, "tm_x": tm_x, "cm_x": cm_x}
    cache = {}
    o, (k, v) = attn.attention_seq(p.attn, h, cfg, kind, positions, mask_mode,
                                   prefix_len)
    o = _scattered(o)
    if cfg.post_norms:
        o = rms_norm(o, p.post_ln1, cfg.norm_eps)
    x = x + o
    if hasattr(p, "xattn"):           # whisper's decoder: cross-attention
        hx = _gathered(rms_norm(x, p.ln_x, cfg.norm_eps))
        ox, (ck, cv) = attn.attention_seq(p.xattn, hx, cfg, ATTN_GLOBAL,
                                          positions, "bidir",
                                          kv_override=enc_out)
        x = x + _scattered(ox)
        cache = {"ck": ck, "cv": cv}
    h2 = _gathered(rms_norm(x, p.ln2, cfg.norm_eps))
    aux = 0.0
    if hasattr(p, "moe"):
        f, aux = moe_mod.moe_layer(p.moe, h2, cfg)
    else:
        f = mlp(p.mlp, h2, cfg.act)
    f = _scattered(f)
    if cfg.post_norms:
        f = rms_norm(f, p.post_ln2, cfg.norm_eps)
    x = _residual(x + f)
    if not want_cache:
        return x, aux, None
    if kind == ATTN_LOCAL and cfg.window_size:
        cache.update(attn.build_ring_cache(k, v, cfg.window_size, cfg.kv_quant))
    else:
        cache.update(attn.pack_kv(k, v, cfg.kv_quant))
    return x, aux, cache


def _gathered(h):
    """A sublayer's input, gathered over ``act_seq``: Megatron-SP's
    all-gather before the column-parallel projections (its gradient's
    reduce-scatter in the backward).  The reference's partitioner infers
    it from the sites below; DTensor, left to infer it, carries the
    sequence shard into the (B*S, D) products as a strided shard, whose
    sharding propagation on a 3-D mesh takes minutes an op."""
    return constrain(h, ("batch", "seq", None))


def _scattered(o):
    """A sublayer's output laid out as the residual stream it is added to
    (``act_seq``) where a backward follows: Megatron-SP's reduce-scatter
    after the row-parallel projection, whose gradient is the all-gather
    that keeps the strided shard out of the backward's products.  Without
    a backward, DTensor lays the sum out itself."""
    if not getattr(o, "requires_grad", False):
        return o
    return constrain(o, ("batch", "act_seq", None))


def _residual(x):
    """The sequence-parallel residual boundary between layers (Megatron-SP):
    sharded over ``act_seq``."""
    return constrain(x, ("batch", "act_seq", None))


def _layer_decode(p: Layer, x, cfg: ModelConfig, kind: str, cache, pos,
                  prefix_len: int = 0):
    """x: (B,1,D); updates ``cache`` in place; returns x.  Each sublayer's
    output is laid out as the residual stream (``_residual``: its partial
    sums over ``model``, from the row-parallel output projection, reduced)
    before it is added: a residual stream left ``Partial`` reaches the next
    products, where DTensor may gather a column-parallel weight (the MLP's
    gate and up) or the cache's slots rather than reduce the rows, and so
    run them whole on every rank."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind == RGLRU:
        o, _ = rglru_mod.rglru_decode(p.rec, h, cfg, cache)
        x = x + _residual(o)
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        return x + _residual(mlp(p.mlp, h2, cfg.act))
    if kind == RWKV:
        o, _ = rwkv_mod.time_mix_decode(p.tm, h, cfg, cache)
        x = x + _residual(o)
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        o2, cm_x = rwkv_mod.channel_mix(p.cm, h2, cache["cm_x"])
        cache["cm_x"].copy_(cm_x)
        return x + _residual(o2)
    o, _ = attn.attention_decode(p.attn, h, cfg, kind, cache, pos, prefix_len)
    o = _residual(o)
    if cfg.post_norms:
        o = rms_norm(o, p.post_ln1, cfg.norm_eps)
    x = x + o
    if hasattr(p, "xattn"):
        hx = rms_norm(x, p.ln_x, cfg.norm_eps)
        ox, _ = attn.attention_decode(p.xattn, hx, cfg, ATTN_GLOBAL, cache,
                                      pos, cross=True)
        x = x + _residual(ox)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        f, _ = moe_mod.moe_layer(p.moe, h2, cfg, decode=True)
    else:
        f = mlp(p.mlp, h2, cfg.act)
    f = _residual(f)
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


def _run_stack(model: Transformer, x, cfg: ModelConfig, positions,
               mask_mode: str, prefix_len: int, enc_out):
    """All layers in order. Returns (x, cache)."""
    caches = []
    for layer in model.layers:
        x, _, c = _layer_seq(layer, x, cfg, layer.kind, positions, mask_mode,
                             prefix_len, enc_out)
        caches.append(c)
    R, P = cfg.n_superblocks, cfg.pattern_len
    blocks = tuple(
        {name: torch.stack([caches[r * P + j][name] for r in range(R)])
         for name in caches[j]}
        for j in range(P)) if R else ()
    return x, {"blocks": blocks, "tail": tuple(caches[R * P:])}


# the matmuls of x with a weight: "dots" keeps their outputs, as the
# reference's dots_with_no_batch_dims_saveable does (the attention einsums,
# batched, are recomputed)
_WEIGHT_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _WEIGHT_MATMULS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_weight_matmuls))


def _train_stack(model: Transformer, x, cfg: ModelConfig, positions,
                 mask_mode: str, prefix_len: int, enc_out, seq_exact: bool):
    """Superblocks under ``_remat_wrap``, then the tail, without caches.
    Returns (x, the sum of the layers' aux losses)."""
    def block_fn(x, *block):
        aux = 0.0
        for layer in block:
            x, a, _ = _layer_seq(layer, x, cfg, layer.kind, positions,
                                 mask_mode, prefix_len, enc_out,
                                 want_cache=False, seq_exact=seq_exact)
            aux = aux + a
        return x, aux

    fn = _remat_wrap(block_fn, cfg)
    R, P = cfg.n_superblocks, cfg.pattern_len
    layers = list(model.layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(R):
        x, a = fn(x, *layers[r * P:(r + 1) * P])
        aux = aux + a
    x, a = block_fn(x, *layers[R * P:])
    return x, aux + a


def _embed(model: Transformer, cfg: ModelConfig, tokens):
    w = model.embed
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=w.dtype) \
        if cfg.embedding_scale else None
    if is_dtensor(w) and w.requires_grad and torch.is_grad_enabled():
        if _vocab_dim(w) is not None:
            return _vocab_parallel_lookup(w, tokens, scale)
        if cfg.tie_embeddings:
            # the table whole over ``model`` (a vocab that does not split),
            # its head on each rank's rows (``_unembed``): the lookup too,
            # so that both uses leave the table's gradient ``Partial``
            # over the rows' ranks
            return on_rows("embedding", functools.partial(
                _lookup, scale=scale), (constrain(tokens, (
                    "batch", "act_seq")),), {"w": w})
    return _lookup(tokens, w, scale)


def _lookup(tokens, w, scale):
    x = F.embedding(tokens, w)
    if scale is not None:
        # the reference casts sqrt(d_model) to the activation dtype first
        x = x * scale
    return x


def _vocab_dim(w):
    """The mesh dim of more than one rank that cuts the DTensor table
    ``w`` (V, D) on its vocab, or None."""
    on = [m for m, p in enumerate(w.placements)
          if p.is_shard(0) and w.device_mesh.size(m) > 1]
    return on[0] if on else None


def _vocab_parallel_lookup(w, tokens, scale):
    """The lookup of ``tokens`` (B,S) in the DTensor table ``w`` cut on its
    vocab over one mesh dim: each rank looks every token up in its own
    rows, a token of another rank's rows giving zeros, so the output is
    ``Partial`` there (what DTensor's own lookup gives, there a
    ``MaskPartial``).  Its backward is local: the gradient of the output,
    gathered, lands in the rank's own rows, so the table's gradient is
    cut on the vocab as the tied head's is (``_unembed``) and ``Partial``
    over the batch's ranks.  DTensor's own backward instead gives every
    rank the whole table's gradient of its rows of the sequence, which has
    to be reduce-scattered to be added to the head's: once a microbatch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, m = w.device_mesh, _vocab_dim(w)
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    tok = tuple(Replicate() if i == m else p
                for i, p in enumerate(tokens.placements))
    grad = tuple(p if i == m else Partial() if tok[i].is_shard()
                 else Replicate() for i, p in enumerate(w.placements))
    rows = w.shape[0] // mesh.size(m)
    offset = mesh.get_local_rank(m) * rows

    def lookup(w, tokens):
        local = tokens - offset
        hit = (local >= 0) & (local < rows)
        x = torch.where(hit[..., None],
                        F.embedding(torch.where(hit, local, 0), w), 0)
        return x if scale is None else x * scale
    run = local_map(lookup, out_placements=(tuple(
                        Partial() if i == m else p
                        for i, p in enumerate(tok)),),
                    in_placements=(tuple(w.placements), tok),
                    in_grad_placements=(grad, tok), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(w, tokens)


def _embed_summed(model: Transformer, cfg: ModelConfig, tokens):
    """``_embed`` summed over the vocab's shards, for an embedding that
    meets another tensor before the residual stream's layout (whisper's
    positions, paligemma's patches): DTensor (torch 2.11) cannot join a
    replicated tensor to the vocab-parallel embedding's partial sums
    (``MaskPartial``, whose mask would have to cover it too).  A lookup on
    each rank's rows holds no partial sums and stays on its rows."""
    x = _embed(model, cfg, tokens)
    return x if rows_cut(x) else _gathered(x)


def _unembed(model: Transformer, cfg: ModelConfig, x):
    """The final norm and the head -> logits (B,S,V).  Where the rows of
    the residual stream ``x`` are cut (``act_seq``) and the vocab is not,
    each rank runs its own rows against the whole table (``rows_product``)
    and the logits stay on those rows (``models.losses.softmax_xent`` takes
    them there): the forward, dx and dW each on a rank's share of the
    rows, where gathering the rows would run all three whole on every
    rank."""
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    w = model.embed if cfg.tie_embeddings else model.lm_head
    rows = rows_cut(x) and _vocab_dim(w) is None
    logits = rows_product(x, w.t(), "unembedding") if rows \
        else _gathered(x) @ w.t()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.float() / c)).to(logits.dtype)
    return logits if rows else constrain(logits, ("batch", None, "vocab"))


def _encode(model: Transformer, cfg: ModelConfig, frames):
    """Whisper's encoder over precomputed frame embeddings (B,S,D) ->
    (encoder output, its positions)."""
    B, S, D = frames.shape
    # the frames laid out as the residual stream (``act_seq``: a local cut,
    # no data moves) before the projection, whose rows then split over
    # ``model``
    x = grad_like(rows_product(_residual(frames.to(pdtype(cfg))),
                               model.frontend_proj, "frontend projection"))
    x = x + sinusoidal_pos_emb(S, D, x.dtype, x.device)[None]
    pos = torch.arange(S, device=x.device).expand(B, S)
    for layer in model.enc_blocks:
        x, _, _ = _layer_seq(layer, x, cfg, ATTN_GLOBAL, pos, "bidir",
                             want_cache=False)
    return _gathered(rms_norm(x, model.enc_norm, cfg.norm_eps)), pos


def _prep_inputs(model: Transformer, cfg: ModelConfig, batch):
    """Embedding and the frontend stubs -> (x, positions, mask_mode,
    prefix_len, enc_out)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    enc_out = None
    mask_mode, prefix_len = "causal", 0
    if cfg.encoder_decoder:
        enc_out = _encode(model, cfg, batch["frames"])
        x = _embed_summed(model, cfg, tokens)
        x = x + sinusoidal_pos_emb(tokens.shape[1], cfg.d_model, x.dtype,
                                   x.device)[None]
    elif cfg.frontend == "vision":
        patches = grad_like(batch["patches"].to(pdtype(cfg)) @
                            model.frontend_proj)
        x = torch.cat([patches, _embed_summed(model, cfg, tokens)], dim=1)
        mask_mode, prefix_len = "prefix", cfg.n_prefix_tokens
    else:
        x = _embed(model, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device).expand(B, -1)
    return _residual(x), positions, mask_mode, prefix_len, enc_out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _entry(fn):
    """Runs ``fn(model, ...)`` under ``replicate_made_tensors``."""
    @functools.wraps(fn)
    def run(model, *args, **kw):
        with replicate_made_tensors(model.embed):
            return fn(model, *args, **kw)
    return run


@_entry
def forward_train(model: Transformer, cfg: ModelConfig, batch,
                  seq_exact: bool = False):
    """-> (logits (B,S,V), aux): ``aux`` is the f32 sum of the MoE layers'
    load-balance losses (zero without MoE).  ``seq_exact`` runs RWKV layers
    through ``wkv_scan``."""
    x, positions, mask_mode, prefix_len, enc_out = _prep_inputs(model, cfg,
                                                                batch)
    x, aux = _train_stack(model, x, cfg, positions, mask_mode, prefix_len,
                          enc_out, seq_exact)
    return _unembed(model, cfg, x), aux


@_entry
def forward_prefill(model: Transformer, cfg: ModelConfig, batch,
                    all_positions: bool = False):
    """-> (last-position logits (B,1,V), cache); with ``all_positions``, the
    logits of every position (B,S,V) (a prompt's own scores)."""
    x, positions, mask_mode, prefix_len, enc_out = _prep_inputs(model, cfg,
                                                                batch)
    x, cache = _run_stack(model, x, cfg, positions, mask_mode, prefix_len,
                          enc_out)
    return _unembed(model, cfg, x if all_positions else x[:, -1:]), cache


def _sin_at(pos: int, d: int, dtype, device):
    """Whisper's decoder position embedding at ``pos``, in f32 then cast, as
    the reference computes it."""
    i = torch.arange(d // 2, device=device)
    ang = float(pos) / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None].to(dtype)


@_entry
def forward_decode(model: Transformer, cfg: ModelConfig, cache, tokens, pos):
    """tokens: (B,1); pos: int; cache from init_cache or prefill.

    The cache's tensors are updated in place; the returned cache holds them.
    """
    pos = int(pos)
    x = _embed(model, cfg, tokens)
    if cfg.encoder_decoder:
        x = x + _sin_at(pos, cfg.d_model, x.dtype, x.device)
    x = constrain(x, ("batch", "seq", None))
    for i, layer in enumerate(model.layers):
        x = _layer_decode(layer, x, cfg, layer.kind, _layer_cache(cache, cfg, i),
                          pos, cfg.n_prefix_tokens)
    logits = _unembed(model, cfg, x)
    blocks = cache["blocks"] if cfg.n_superblocks else ()
    return logits, {"blocks": blocks, "tail": cache["tail"]}


def _kind_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                dtype, device, cross_len: int) -> dict:
    if kind == RGLRU:
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    if kind == RWKV:
        return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device)
    c = attn.init_attn_cache(cfg, kind, batch, seq_len, dtype, device)
    if cfg.encoder_decoder:
        c.update(attn.init_attn_cache(cfg, kind, batch, seq_len, dtype, device,
                                      cross_len=cross_len))
    return c


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero caches.  An encoder-decoder's decoder gets ``seq_len //
    dec_len_ratio`` slots and cross caches of ``seq_len`` encoder positions,
    as in the reference."""
    check_supported(cfg)
    dev = resolve_device(device)
    cross_len = seq_len if cfg.encoder_decoder else 0
    dec_len = seq_len // cfg.dec_len_ratio if cfg.encoder_decoder else seq_len
    R = cfg.n_superblocks
    blocks = []
    for kind in cfg.layer_pattern:
        one = _kind_cache(cfg, kind, batch, dec_len, dtype, dev, cross_len)
        blocks.append({name: torch.zeros((R,) + tuple(t.shape), dtype=t.dtype,
                                         device=dev) for name, t in one.items()}
                      if R else one)
    tail = tuple(_kind_cache(cfg, kind, batch, dec_len, dtype, dev, cross_len)
                 for kind in cfg.tail_pattern)
    return {"blocks": tuple(blocks), "tail": tail}
