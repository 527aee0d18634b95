"""GQA attention: the full-sequence path (prefill, encoder, cross-attention)
and the decode path.

Port of ``repro.models.attention``: causal, sliding-window, prefix-LM
(paligemma) and bidirectional (whisper's encoder) masks, logit softcap,
qk-norm, the local/global rope theta (no rope on encoder-decoder configs),
cross-attention (``kv_override`` in ``attention_seq``, ``cross=True`` in
``attention_decode`` over the ``ck``/``cv`` caches), and the decode path
over a plain, ring or int8 (``cfg.kv_quant``: per-(token, head) absmax
scales ``ksc``/``vsc``) KV cache.

``attention_seq`` hands causal attention to the hook set by
``set_attention_impl``, as the reference does, and only causal attention.
Every hook takes one signature: ``(q, k, v, *, window, softcap, scale,
q_block, pack, q0)``: ``q_block`` and ``pack`` the layer's
``attn_q_block`` and ``pack_ok``, ``q0`` the position of q's first row
(0 but on the q-rows route below, where k holds the keys up to q's last
row).
By default the hook is the flash attention wrapper (``repro_torch.kernels``):
on a CUDA tensor it runs the hand-written kernel, on a CPU tensor its plain
version.  With the hook cleared, and for prefix and bidirectional masks and
cross-attention in both packages, the plain path is the reference's q-block
dispatch, branch for branch: ``_sdpa`` where S <= 2 ``attn_q_block``, S is
no multiple of it, or the attention is cross; ``_rect_scan`` for a
bidirectional mask; ``_causal_packed`` for a causal mask with no window
where S is a multiple of 2 ``attn_q_block`` and ``pack_ok``
(``attn_causal_pack``: ``"auto"`` is ``n_heads % tp == 0``); else
``_qblock_scan``.  The scans keep score memory at O(S q_block).  They keep
the reference's casts: f32 scores (``qk_scores``, whose dq and dk come back
in the operands' dtype), the probabilities cast to ``v.dtype`` before the PV
product, the merge of two partials in f32.  ``causal_attention`` is that
dispatch for a causal mask, which the reference trains through (its flash
kernel has no VJP and its hook is off by default), so it is the backward of
the flash kernel's autograd function.  ``plain_attention`` is ``_sdpa``
under the causal (and window) mask at positions q0..q0+S-1, with the
hook's signature (it ignores ``q_block`` and ``pack``): setting it as the
hook gives the whole-square plain path.

That dispatch is ``_dispatch``, in one place for both of its callers.

Under DTensor, where ``model`` does not divide the q heads
(``distributed.heads.head_split``'s ``"q_rows"``), attention is split by
head groups and q rows (``heads.run_q_rows``: each rank one head group's
block of rows at its row offset ``q0``, the rows gathered back): the
causal mask through
flash's route where flash is the hook; everything else (the prefix and
bidirectional masks, cross-attention, a causal mask with the hook off or
another hook) through ``attention_q_rows``, ``_dispatch`` on each rank's
rows, its branch chosen on the whole sequence.  There ``kv_columns`` cuts
the k and v projections by columns over ``model``.  Where ``model`` cuts
q's heads and not the kv heads (``head_split``'s ``"q_heads"``), each rank
runs its own q heads against the one kv head they read
(``heads.run_q_heads``): the causal mask through flash's route, the rest
through ``attention_q_heads``.
Decode attention has no kernel in the reference and is plain torch here
too.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.distributed import heads
from repro_torch.distributed.context import (axis_size, constrain, grad_like,
                                             is_dtensor, local_device,
                                             unflatten, weight_at)
from repro_torch.distributed.heads import (q_rows_dim, splits_q_heads,
                                           splits_q_rows)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.modules import (ParamModule, init_norm, normal, pdtype,
                                        rms_norm, rope)
from repro_torch.roofline.trace import record_route

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
                   device, cross: bool = False) -> Attention:
    """Self-attention, or with ``cross`` the cross-attention of an
    encoder-decoder's decoder (no qk-norm)."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = pdtype(cfg)
    p = {
        "wq": normal(generator, (d, h * hd), d ** -0.5, dt, device),
        "wk": normal(generator, (d, k * hd), d ** -0.5, dt, device),
        "wv": normal(generator, (d, k * hd), d ** -0.5, dt, device),
        "wo": normal(generator, (h * hd, d), (h * hd) ** -0.5, dt, device),
    }
    if cfg.qk_norm and not cross:
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
def make_mask_fn(mode: str = "causal", window: int = 0, prefix_len: int = 0):
    """``mode``: ``"bidir"`` (every pair), ``"prefix"`` (causal, and every
    query sees the first ``prefix_len`` positions), else causal."""
    def fn(q_pos, kv_pos):
        q = q_pos[:, None]
        kv = kv_pos[None, :]
        if mode == "bidir":
            allow = torch.ones(torch.broadcast_shapes(q.shape, kv.shape),
                               dtype=torch.bool, device=q.device)
        elif mode == "prefix":
            allow = (kv <= q) | (kv < prefix_len)
        else:  # causal
            allow = kv <= q
        if window:
            allow &= kv > q - window
        allow &= kv >= 0
        return allow
    return fn


class QKScores(torch.autograd.Function):
    """f32 scores q k^T whose gradients come back in the operands' dtype
    (the reference's ``qk_scores`` custom VJP): the backward saves q and k
    as they are, not their f32 copies.  The backward's products read the
    scores' gradient (B,K,G,Sq,Skv) in place, as (B*K, G*Sq, Skv) and its
    transpose: an einsum there copies it to another layout first, a
    score-sized copy a call."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        B, Sq, K, G, hd = q.shape
        Skv = k.shape[1]
        ds = ds.reshape(B * K, G * Sq, Skv)
        dq = dk = None
        if ctx.needs_input_grad[0]:
            kf = k.float().permute(0, 2, 1, 3).reshape(B * K, Skv, hd)
            dq = torch.bmm(ds, kf).reshape(B, K, G, Sq, hd) \
                .permute(0, 3, 1, 2, 4).to(q.dtype)
        if ctx.needs_input_grad[1]:
            qf = q.float().permute(0, 2, 3, 1, 4).reshape(B * K, G * Sq, hd)
            dk = torch.bmm(ds.transpose(1, 2), qf).reshape(B, K, Skv, hd) \
                .permute(0, 2, 1, 3).to(k.dtype)
        return dq, dk


def qk_scores(q, k):
    """q: (B,Sq,K,G,hd), k: (B,Skv,K,hd) -> f32 (B,K,G,Sq,Skv)."""
    return QKScores.apply(q, k)


def _sdpa(q, k, v, mask, softcap: float, scale: float,
          want_lse: bool = False):
    """q: (B,Sq,K,G,hd)  k,v: (B,Skv,K,hd)  mask: (Sq,Skv) or (B,Sq,Skv)
    or None (dense).  With ``want_lse`` also the scores' logsumexp
    (B,K,G,Sq)."""
    s = qk_scores(q, k) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None, None]
        s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", a, v)
    if want_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _lse_merge(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint KV sets."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    # o: (B,Sq,K,G,hd); lse/w: (B,K,G,Sq) -> align to o
    a1 = w1.permute(0, 3, 1, 2)[..., None]
    a2 = w2.permute(0, 3, 1, 2)[..., None]
    o = (o1.float() * a1 + o2.float() * a2) / (a1 + a2)
    return o.to(o1.dtype), m + torch.log(w1 + w2)


def _rect_scan(q, k, v, softcap, scale, qb: int):
    """Dense (unmasked) attention of q against all of k/v, a q block at a
    time; returns (o, lse)."""
    S = q.shape[1]
    nb = max(S // qb, 1)
    qb = S // nb
    if nb * qb != S:        # the reference's reshape refuses these too
        raise ValueError(f"{S} q rows do not split into {nb} blocks")
    parts = [_sdpa(q[:, i * qb:(i + 1) * qb], k, v, None, softcap, scale,
                   want_lse=True) for i in range(nb)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([lse for _, lse in parts], dim=3))


def _causal_packed(q, k, v, softcap, scale, qb: int, leaf: int):
    """Recursive causal attention with no masked-rectangle waste:
    attn(S) = [attn(S/2) over the first half,
               merge(attn(S/2) over the second half's diagonal,
                     dense rect(second-half q x first-half kv))],
    about S^2 / 2 products instead of the q-block scan's S^2; returns (o,
    lse)."""
    S = q.shape[1]
    if S <= leaf or S % 2 != 0:
        pos = torch.arange(S, device=local_device(q))
        return _sdpa(q, k, v, make_mask_fn("causal")(pos, pos), softcap,
                     scale, want_lse=True)
    h = S // 2
    o1, lse1 = _causal_packed(q[:, :h], k[:, :h], v[:, :h], softcap, scale,
                              qb, leaf)
    od, lsed = _causal_packed(q[:, h:], k[:, h:], v[:, h:], softcap, scale,
                              qb, leaf)
    orr, lser = _rect_scan(q[:, h:], k[:, :h], v[:, :h], softcap, scale, qb)
    o2, lse2 = _lse_merge(od, lsed, orr, lser)
    return torch.cat([o1, o2], dim=1), torch.cat([lse1, lse2], dim=3)


def _qblock_scan(q, k, v, mask_fn, softcap, scale, qb: int, window: int,
                 q0: int = 0):
    """A q block at a time against the keys (positions 0..T-1), q's rows
    at positions q0..; with a window shorter than T - qb, each block
    against a static slice of its qb + window keys."""
    S, T = q.shape[1], k.shape[1]
    if S % qb:
        raise ValueError(f"{S} q rows do not split into blocks of {qb}")
    dev = local_device(q)
    L = qb + window if window and qb + window < T else T
    out = []
    for i in range(S // qb):
        p = q0 + i * qb
        start = max(p - window, 0) if L < T else 0
        q_pos = p + torch.arange(qb, device=dev)
        kv_pos = start + torch.arange(L, device=dev)
        out.append(_sdpa(q[:, i * qb:(i + 1) * qb], k[:, start:start + L],
                         v[:, start:start + L], mask_fn(q_pos, kv_pos),
                         softcap, scale))
    return torch.cat(out, dim=1)


def plain_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                    scale: float, causal: bool = True, q0: int = 0,
                    q_block: Optional[int] = None,
                    pack: Optional[bool] = None):
    """q: (B,Sq,K,G,hd); k,v: (B,Skv,K,hd) -> (B,Sq,K,G,hd): ``_sdpa`` under
    the causal mask (with ``window``) with q's rows at positions q0..q0+Sq-1
    and k's at 0..Skv-1, or unmasked when ``causal`` is false.  It takes the
    hook's signature; ``q_block`` and ``pack`` do not change it (one
    square)."""
    del q_block, pack
    mask = None
    if causal:
        dev = local_device(q)
        mask = make_mask_fn("causal", window)(
            q0 + torch.arange(q.shape[1], device=dev),
            torch.arange(k.shape[1], device=dev))
    return _sdpa(q, k, v, mask, softcap, scale)


def causal_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                     scale: float, q_block: int, pack: bool, q0: int = 0):
    """The reference's dispatch (``attention_seq`` with its hook off) for a
    causal mask: ``_sdpa`` where S <= 2 ``q_block`` or S is no multiple of
    it; ``_causal_packed`` (leaf 2 ``q_block``) with no window where S is
    a multiple of 2 ``q_block`` and ``pack``; else ``_qblock_scan``.  Rows
    at ``q0`` > 0, or fewer keys than rows, are one rectangle: ``_sdpa``
    under the mask at their positions."""
    S = q.shape[1]
    if q0 or k.shape[1] != S or S <= 2 * q_block or S % q_block:
        return plain_attention(q, k, v, window=window, softcap=softcap,
                               scale=scale, q0=q0)
    if not window and S % (2 * q_block) == 0 and pack:
        return _causal_packed(q, k, v, softcap, scale, q_block,
                              leaf=2 * q_block)[0]
    return _qblock_scan(q, k, v, make_mask_fn("causal", window), softcap,
                        scale, q_block, window)


def pack_ok(cfg: ModelConfig) -> bool:
    """The reference's ``pack_ok``: ``attn_causal_pack`` ``"on"`` or
    ``"off"``; ``"auto"`` packs where the heads split evenly over the
    active rules' ``model`` axis (1 without rules)."""
    if cfg.attn_causal_pack in ("on", "off"):
        return cfg.attn_causal_pack == "on"
    return cfg.n_heads % max(axis_size("model"), 1) == 0


# ---------------------------------------------------------------------------
# full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def _first_row(pos):
    return pos[0] if pos.dim() > 1 else pos


def kv_columns(w, q):
    """The k or v projection ``w`` (D, K*hd), cut on its columns over each
    mesh dim that cuts q's heads (B,S,H,hd) and leaves ``w`` whole there
    (the q-heads route: more ranks than kv heads), and over ``model``
    where q takes the q-rows route (``q_rows_dim``: ranks that do not
    divide the q heads, q's and k's heads whole there).  Each rank then
    projects its share of the columns and ``unflatten`` gathers k, as the
    reference's partitioner splits this product where a whole ``w`` is
    every rank's full product; ``w``'s gradient stays cut by columns
    (``weight_at``: the train step gathers it once).  Elsewhere, and where
    the ranks do not divide K*hd, ``w`` as it is."""
    if not (is_dtensor(w) and is_dtensor(q)):
        return w
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    rows = q_rows_dim(q, w.shape[1] // q.shape[-1])
    place = tuple(Shard(1) if (p.is_shard(2) or m == rows) and
                  mesh.size(m) > 1 and w.placements[m].is_replicate() and
                  w.shape[1] % mesh.size(m) == 0 else w.placements[m]
                  for m, p in enumerate(q.placements))
    if tuple(place) != tuple(w.placements):
        cols = w.shape[1]
        for m, p in enumerate(place):
            cols //= mesh.size(m) if p.is_shard(1) else 1
        record_route("kv_columns", (w.shape[0], cols))
    return weight_at(w, place)


def _dispatch(q, k, v, *, mask_mode: str, window: int, prefix_len: int,
              softcap: float, scale: float, q_block: int, pack: bool,
              cross: bool, q_pos, kv_pos, S: Optional[int] = None,
              q0: int = 0):
    """The reference's dispatch (its ``attention_seq``) on q (B,rows,K,G,hd)
    at positions ``q_pos[q0:q0 + rows]`` against k, v (B,Skv,K,hd) at
    ``kv_pos`` (each 1-D, or (B, ·) read at its first row), its branch
    chosen on the whole sequence of ``S`` rows (q's own by default; a
    rank's block of them on the q-rows route, ``attention_q_rows``).  A
    causal block of rows reads no key past its last row.  A causal mask:
    the hook (at ``q0``); else ``_sdpa`` under the layer's mask where S <=
    2 ``q_block``, S is no multiple of it, or the attention is cross (the
    decoder's rows against every encoder key); ``_rect_scan`` for a
    bidirectional mask; ``causal_attention`` (at ``q0``) for a causal one;
    else ``_qblock_scan`` at ``q0`` under the prefix mask, in blocks of
    ``q_block`` rows or, fewer rows than that, one block."""
    rows = q.shape[1]
    S = rows if S is None else S
    kw = dict(window=window, softcap=softcap, scale=scale)
    if mask_mode == "causal" and q0 + rows < k.shape[1]:
        k, v = k.narrow(1, 0, q0 + rows), v.narrow(1, 0, q0 + rows)
    if _ATTN_IMPL is not None and mask_mode == "causal":
        return _ATTN_IMPL(q, k, v, **kw, q_block=q_block, pack=pack, q0=q0)
    if S <= 2 * q_block or S % q_block or cross:
        q_pos, kv_pos = _first_row(q_pos), _first_row(kv_pos)
        if q0 or rows != q_pos.shape[0]:
            q_pos = q_pos.narrow(0, q0, rows)
        if kv_pos.shape[0] != k.shape[1]:
            kv_pos = kv_pos.narrow(0, 0, k.shape[1])
        return _sdpa(q, k, v, make_mask_fn(mask_mode, window, prefix_len)(
            q_pos, kv_pos), softcap, scale)
    if mask_mode == "bidir":
        return _rect_scan(q, k, v, softcap, scale, q_block)[0]
    if mask_mode == "causal":
        return causal_attention(q, k, v, **kw, q_block=q_block, pack=pack,
                                q0=q0)
    return _qblock_scan(q, k, v, make_mask_fn(mask_mode, window, prefix_len),
                        softcap, scale, min(q_block, rows), window, q0=q0)


def attention_q_rows(q, k, v, *, mask_mode: str, scale: float, q_block: int,
                     pack: bool, window: int = 0, prefix_len: int = 0,
                     softcap: float = 0.0, cross: bool = False, q_pos=None,
                     kv_pos=None):
    """The plain dispatch on the q-rows route (``splits_q_rows``): the
    DTensors q (B,S,H,hd) and k, v (B,Skv,K,hd) -> (B,S,H,hd), each rank
    ``_dispatch`` on one head group's block of rows
    (``heads.run_q_rows``).
    ``q_pos``, ``kv_pos``: the positions of q's and k's rows, as
    ``_dispatch`` takes them (default 0..S-1 and 0..Skv-1)."""
    S, Skv = q.shape[1], k.shape[1]
    dev = local_device(q)
    q_pos = torch.arange(S, device=dev) if q_pos is None else q_pos
    kv_pos = torch.arange(Skv, device=dev) if kv_pos is None else kv_pos
    return heads.run_q_rows("attention", functools.partial(
        _dispatch, S=S, mask_mode=mask_mode, window=window,
        prefix_len=prefix_len, softcap=softcap, scale=scale,
        q_block=q_block, pack=pack, cross=cross, q_pos=q_pos,
        kv_pos=kv_pos), q, k, v)


def attention_q_heads(q, k, v, *, mask_mode: str, scale: float,
                      q_block: int, pack: bool, window: int = 0,
                      prefix_len: int = 0, softcap: float = 0.0,
                      cross: bool = False, q_pos=None, kv_pos=None):
    """The plain dispatch on the q-heads route (``splits_q_heads``): the
    DTensors q (B,S,H,hd), cut on its heads, and k, v (B,Skv,K,hd), whole
    there -> (B,S,H,hd) cut as q is, each rank ``_dispatch`` on its own q
    heads against the one kv head they read (``heads.run_q_heads``).
    ``q_pos``, ``kv_pos``: as ``attention_q_rows`` takes them."""
    S, Skv = q.shape[1], k.shape[1]
    dev = local_device(q)
    q_pos = torch.arange(S, device=dev) if q_pos is None else q_pos
    kv_pos = torch.arange(Skv, device=dev) if kv_pos is None else kv_pos
    return heads.run_q_heads("attention", functools.partial(
        _dispatch, mask_mode=mask_mode, window=window, prefix_len=prefix_len,
        softcap=softcap, scale=scale, q_block=q_block, pack=pack,
        cross=cross, q_pos=q_pos, kv_pos=kv_pos), q, k, v)


def attention_seq(p: Attention, x, cfg: ModelConfig, kind: str, positions,
                  mask_mode: str = "causal", prefix_len: int = 0,
                  kv_override=None):
    """x: (B,S,D) -> (B,S,D); also returns (k, v) for cache building.

    ``kv_override=(k_src, kv_positions)`` switches to cross-attention
    (whisper's decoder): K/V are projected from the encoder output.
    """
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    window = cfg.window_size if kind == ATTN_LOCAL else 0
    theta = _theta(cfg, kind)

    # grad_like: a projection whose heads are not split (fewer heads than
    # ranks) takes a replicated gradient, not a shard of its rows
    q = unflatten(grad_like(x @ p.wq), 2, (H, hd))
    kv_src, kv_pos = (x, positions) if kv_override is None else kv_override
    k = unflatten(grad_like(kv_src @ kv_columns(p.wk, q)), 2, (K, hd))
    v = unflatten(grad_like(kv_src @ kv_columns(p.wv, q)), 2, (K, hd))
    if hasattr(p, "q_norm"):
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if not cfg.encoder_decoder:
        q = rope(q, positions, theta)
        k = rope(k, kv_pos, theta)
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))

    scale = hd ** -0.5
    softcap = cfg.attn_logit_softcap
    qb, pack = cfg.attn_q_block, pack_ok(cfg)
    dispatch = dict(mask_mode=mask_mode, window=window,
                    prefix_len=prefix_len, softcap=softcap, scale=scale,
                    q_block=qb, pack=pack, cross=kv_override is not None,
                    q_pos=positions, kv_pos=kv_pos)
    if _ATTN_IMPL is flash_attention and mask_mode == "causal" and \
            (splits_q_heads(q, k) or splits_q_rows(q, k)):
        # q's heads split where the kv heads do not (gemma2-9b: 16 heads, 8
        # kv heads, 16 ranks), or ranks that do not divide the heads split
        # head groups' rows: flash takes q flat, each rank its own heads or
        # rows
        o = flash_attention(q, k, v, window=window, softcap=softcap,
                            scale=scale, q_block=qb, pack=pack)
    elif splits_q_rows(q, k):
        # ranks that do not divide the heads and no flash route (prefix,
        # bidirectional, cross, a causal mask with the hook off or another
        # hook): each rank the dispatch on one head group's block of rows
        o = attention_q_rows(q, k, v, **dispatch)
    elif splits_q_heads(q, k):
        # q's heads split where the kv heads do not and no flash route:
        # each rank the dispatch on its own heads
        o = attention_q_heads(q, k, v, **dispatch)
    else:
        # the GQA fold: a heads shard splits into (K, G) where K divides it
        # (kv heads split)
        o = _dispatch(unflatten(q, 2, (K, G)), k, v, **dispatch)
    o = constrain(o.reshape(B, S, H * hd), ("batch", "seq", "heads_flat"))
    return o @ p.wo, (k, v)


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                    dtype=torch.bfloat16, device="cuda",
                    cross_len: int = 0) -> dict:
    """Zero caches: ``ck``/``cv`` of ``cross_len`` encoder positions with
    ``cross_len``; else ``k``/``v`` (a ring of the window on local layers),
    int8 with f32 scales ``ksc``/``vsc`` under ``cfg.kv_quant``."""
    K, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    if cross_len:
        return {"ck": zeros((batch, cross_len, K, hd), dtype),
                "cv": zeros((batch, cross_len, K, hd), dtype)}
    L = min(cfg.window_size, seq_len) if kind == ATTN_LOCAL else seq_len
    if cfg.kv_quant:
        return {"k": zeros((batch, L, K, hd), torch.int8),
                "v": zeros((batch, L, K, hd), torch.int8),
                "ksc": zeros((batch, L, K), torch.float32),
                "vsc": zeros((batch, L, K), torch.float32)}
    return {"k": zeros((batch, L, K, hd), dtype),
            "v": zeros((batch, L, K, hd), dtype)}


def _kv_quantize(t):
    """(B,S,K,hd) -> int8 values + (B,S,K) f32 scales.  ``torch.round``
    rounds half to even, as ``jnp.round`` does, and the division is the
    reference's f32 one, so the int8 values are the reference's."""
    t = t.float()
    sc = torch.clamp(t.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(t / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc


def _kv_dequantize(q, sc, dtype=torch.bfloat16):
    return (q.float() * sc[..., None]).to(dtype)


def attention_decode(p: Attention, x, cfg: ModelConfig, kind: str,
                     cache: dict, pos: int, prefix_len: int = 0,
                     cross: bool = False):
    """x: (B,1,D); cache holds K/V (or, with ``cross``, the encoder's
    ``ck``/``cv``); pos: the current position.

    Writes the new token's K/V into ``cache`` in place (the reference returns
    an updated copy) and returns (out (B,1,D), cache).  A cross-attention
    call writes nothing.
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    theta = _theta(cfg, kind)
    scale = hd ** -0.5

    q = unflatten(x @ p.wq, 2, (H, hd))
    if hasattr(p, "q_norm"):
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    if cross:
        k, v = cache["ck"], cache["cv"]
        s = torch.einsum("bskgd,btkd->bkgst",
                         unflatten(q, 2, (K, G)).float(), k.float()) * scale
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgst,btkd->bskgd", a, v).reshape(B, 1, H * hd)
        return o @ p.wo, cache

    kn = unflatten(x @ p.wk, 2, (K, hd))
    vn = unflatten(x @ p.wv, 2, (K, hd))
    if hasattr(p, "k_norm"):
        kn = rms_norm(kn, p.k_norm, cfg.norm_eps)
    if not cfg.encoder_decoder:
        posv = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
        q = rope(q, posv, theta)
        kn = rope(kn, posv, theta)

    L = cache["k"].shape[1]
    ring = kind == ATTN_LOCAL and cfg.window_size and L <= cfg.window_size
    # The reference writes with lax.dynamic_update_slice, which clamps its
    # start index into range: decoding at pos >= L on a plain cache (right
    # after a prefill of L tokens) overwrites the last slot.  Mirror that.
    idx = pos % L if ring else min(max(pos, 0), L - 1)
    if "ksc" in cache:
        for name, t in (("k", kn), ("v", vn)):
            tq, tsc = _kv_quantize(t)
            _write_slot(cache[name], idx, tq[:, 0])
            _write_slot(cache[name + "sc"], idx, tsc[:, 0])
        k = _kv_dequantize(cache["k"], cache["ksc"], x.dtype)
        v = _kv_dequantize(cache["v"], cache["vsc"], x.dtype)
    else:
        _write_slot(cache["k"], idx, kn[:, 0])
        _write_slot(cache["v"], idx, vn[:, 0])
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
        if prefix_len:
            allow |= kv_pos < prefix_len

    s = torch.einsum("bskgd,btkd->bkgst", unflatten(q, 2, (K, G)).float(),
                     k.float()) * scale
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(allow, s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", a, v).reshape(B, H * hd)
    # a 2-D product: the (B, 1, H*hd) form is folded into one by eager
    # matmul but not on a DTensor, whose size-1 dim keeps another stride
    return (o @ p.wo)[:, None], cache


def _write_slot(buf, idx: int, val):
    """``buf[:, idx] = val`` in place.  A DTensor cache is sharded over its
    slots (``cache_pspecs``' ``kv_seq``), and an index into a sharded dim
    writes into a gathered copy, so there the slot is written by a select
    over the whole buffer (the same values)."""
    if not is_dtensor(buf):
        buf[:, idx] = val
        return
    slot = torch.arange(buf.shape[1], device=buf.device) == idx
    buf.copy_(torch.where(slot.reshape(1, -1, *(1,) * (buf.dim() - 2)),
                          val[:, None], buf))


def build_ring_cache(k_full, v_full, window: int, quant: bool = False) -> dict:
    """Convert full prefill K/V (B,S,K,hd) into the decode ring layout."""
    S = k_full.shape[1]
    if S > window:
        idx = (S - 1) % window
        slot = torch.arange(window, device=k_full.device)
        pos = (S - 1) - torch.remainder(idx - slot, window)
        k_full = k_full.index_select(1, pos)
        v_full = v_full.index_select(1, pos)
    return pack_kv(k_full, v_full, quant)


def pack_kv(k, v, quant: bool = False) -> dict:
    if not quant:
        return {"k": k, "v": v}
    kq, ks = _kv_quantize(k)
    vq, vs = _kv_quantize(v)
    return {"k": kq, "v": vq, "ksc": ks, "vsc": vs}
