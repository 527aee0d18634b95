"""Plain PyTorch version of the RWKV-6 wkv kernel.

The same function as ``csrc/wkv6_chunk.cu`` and ``csrc/wkv6.cu``: per row
of r, k, v, logw (BH, S, hd) f32 and u (BH, hd),

    y_t = r_t^T (S_{t-1} + diag(u * k_t) v_t^T)
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,     S_{-1} = 0,

returning y and the state after the last step.  It is the chunk-parallel
math of the reference model's ``wkv_chunked`` (``repro.models.rwkv``),
vectorised over chunks of ``CHUNK`` tokens: the terms inside a chunk are
batched products, with the pairwise decays factored per tile of ``TILE`` in
log space so no f32 factor overflows; the state then crosses the chunks in a
loop of S / CHUNK steps.  A ragged S is padded at the end with zero r, k, v
and logw: a zero logw decays by exp(0) = 1 and a zero k adds nothing, so the
padded steps leave the state as it was and their y rows are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16
TILE = 8


def _intra_chunk(rc, kc, vc, lp, lp_prev, uk):
    """y_intra[t] = sum_{s<t} (r_t * exp(lp_{t-1} - lp_s) * k_s) . v_s
                  + (r_t . (u * k_t)) v_t, within each chunk.

    rc, kc, vc, lp, lp_prev, uk: (..., c, hd).  Twin of the reference's
    ``_intra_chunk``, tile-factored for f32 safety.
    """
    *lead, c, hd = rc.shape
    nt = c // TILE
    shp = (*lead, nt, TILE, hd)
    lp_t = lp.reshape(shp)
    lpp_t = lp_prev.reshape(shp)
    ts = lp_t[..., 0, :]                                   # lp at tile start
    te = lp_t[..., -1, :]                                  # lp at tile end
    r_f = rc.reshape(shp) * torch.exp(lpp_t - ts[..., None, :])
    k_f = kc.reshape(shp) * torch.exp(te[..., None, :] - lp_t)
    # tile-pair decay, masked in log space for tiles not strictly earlier
    mid = ts[..., :, None, :] - te[..., None, :, :]        # (..., T, S, hd)
    tmask = torch.arange(nt)[:, None] > torch.arange(nt)[None, :]
    mid = torch.where(tmask[..., None].to(mid.device), mid, -torch.inf)
    A_off = torch.einsum("...Tti,...TSi,...Ssi->...TtSs", r_f, torch.exp(mid),
                         k_f)
    # diagonal tiles: direct pairwise (exponent bounded by the tile span)
    expo = lpp_t[..., :, None, :] - lp_t[..., None, :, :]  # (..., T, t, s, hd)
    dmask = torch.arange(TILE)[:, None] > torch.arange(TILE)[None, :]
    expo = torch.where(dmask[..., None].to(expo.device), expo, -torch.inf)
    A_diag = torch.einsum("...Tti,...Ttsi->...Tts", rc.reshape(shp),
                          torch.exp(expo) * kc.reshape(shp)[..., None, :, :])
    eye = torch.eye(nt, dtype=A_off.dtype, device=A_off.device)
    A = A_off + torch.einsum("...Tts,TS->...TtSs", A_diag, eye)
    A = A.reshape(*lead, c, c)
    y = A @ vc
    diag_bonus = (rc * uk).sum(-1)
    return y + diag_bonus[..., None] * vc


def wkv6_ref(r, k, v, logw, u):
    """r, k, v, logw: (BH, S, hd) f32; u: (BH, hd) f32 ->
    (y (BH, S, hd) f32, S_last (BH, hd, hd) f32)."""
    BH, S, hd = r.shape
    pad = -S % CHUNK
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    nb = (S + pad) // CHUNK
    rc, kc, vc, wc = (t.reshape(BH, nb, CHUNK, hd) for t in (r, k, v, logw))
    lp = torch.cumsum(wc, dim=-2)                          # (BH, nb, c, hd)
    lp_prev = lp - wc
    k_out = kc * torch.exp(lp[..., -1:, :] - lp)           # decay to chunk end
    tot = torch.exp(lp[..., -1, :])                        # (BH, nb, hd)

    y = _intra_chunk(rc, kc, vc, lp, lp_prev, u[:, None, None, :] * kc)

    # inter-chunk states: Z_n = diag(tot_n) Z_{n-1} + G_n
    G = torch.einsum("bnsi,bnsj->bnij", k_out, vc)         # (BH, nb, hd, hd)
    st = torch.zeros((BH, hd, hd), dtype=r.dtype, device=r.device)
    s_in = []
    for n in range(nb):
        s_in.append(st)
        st = tot[:, n, :, None] * st + G[:, n]
    s_in = torch.stack(s_in, dim=1)                        # state entering chunk n
    y = y + torch.einsum("bnti,bnij->bntj", rc * torch.exp(lp_prev), s_in)
    return y.reshape(BH, nb * CHUNK, hd)[:, :S], st


# ---------------------------------------------------------------------------
# The numerics of the tensor-core kernel, csrc/wkv6_chunk.cu
# ---------------------------------------------------------------------------
TC_CHUNK = 16          # tokens per chunk of csrc/wkv6_chunk.cu
TC_SUB = 8             # rows of its diagonal sub-tiles of A


def tf32_round(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: keep 10 mantissa
    bits, to nearest, ties away from zero (bit-exact for finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    """a @ b with the operands of the kernel's ``mma.sync`` TF32 products:
    ``"3xtf32"`` splits each into hi = tf32(x) and lo = tf32(x - hi) and sums
    lo.hi + hi.lo + hi.hi in f32; ``"tf32"`` rounds each operand once;
    ``"f32"`` is the plain f32 product."""
    if precision == "f32":
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if precision == "tf32":
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_chunk_ref(r, k, v, logw, u, precision="3xtf32"):
    """The plan of ``csrc/wkv6_chunk.cu`` in plain PyTorch: the same
    function as ``wkv6_ref``, computed as the kernel computes it.

    Per chunk of ``TC_CHUNK`` tokens, with lp the in-chunk cumulative sum of
    logw and lpp_t = lp_{t-1} (both <= 0), A[t, s] (s < t) is

      sum_i r[t,i] k[s,i] exp(lpp[t,i] - lp[s,i])

    computed pairwise in f32 inside the two diagonal ``TC_SUB`` x ``TC_SUB``
    sub-tiles, and below them (t >= TC_SUB > s) as the product r2 k2^T with
    r2 = r exp(lpp - lp[TC_SUB-1]) and k2 = k exp(lp[TC_SUB-1] - lp): every
    exponent is <= 0, whatever logw <= 0 is, so no factor overflows.  Then

      y     = (r * exp(lpp)) S_in + A v + (r . (u * k)) v,
      S_out = exp(lp_end) * S_in + (k * exp(lp_end - lp))^T v,

    where the products (r2 k2^T too) run on the tensor cores with the
    operand rounding ``precision`` names (see ``_mm``) and the state stays
    f32.  A ragged tail chunk is padded with zero r, k, v and logw, which
    leave the state as it was; its rows of y are dropped.
    """
    BH, S, hd = r.shape
    c, h = TC_CHUNK, TC_SUB
    pad = -S % c
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    nb = (S + pad) // c
    rc, kc, vc, wc = (t.reshape(BH, nb, c, hd) for t in (r, k, v, logw))
    lp = torch.cumsum(wc, dim=-2)
    lpp = torch.cat([torch.zeros_like(lp[..., :1, :]), lp[..., :-1, :]], -2)
    expo = lpp[..., :, None, :] - lp[..., None, :, :]      # (BH, nb, t, s, hd)
    pos = torch.arange(c)
    pairwise = (pos[:, None] > pos[None, :]) & (pos[:, None] // h ==
                                                 pos[None, :] // h)
    expo = torch.where(pairwise[..., None].to(expo.device), expo, -torch.inf)
    A = torch.einsum("bnti,bnsi,bntsi->bnts", rc, kc, torch.exp(expo))
    mid = lp[..., h - 1:h, :]
    r2 = rc[..., h:, :] * torch.exp(lpp[..., h:, :] - mid)
    k2 = kc[..., :h, :] * torch.exp(mid - lp[..., :h, :])
    A[..., h:, :h] = _mm(r2, k2.transpose(-1, -2), precision)
    bonus = (rc * u[:, None, None, :] * kc).sum(-1, keepdim=True)
    rd = rc * torch.exp(lpp)
    k_out = kc * torch.exp(lp[..., -1:, :] - lp)
    tot = torch.exp(lp[..., -1, :])
    st = torch.zeros((BH, hd, hd), dtype=r.dtype, device=r.device)
    ys = []
    for n in range(nb):
        ys.append(_mm(rd[:, n], st, precision)
                  + _mm(A[:, n], vc[:, n], precision) + bonus[:, n] * vc[:, n])
        st = tot[:, n, :, None] * st + \
            _mm(k_out[:, n].transpose(1, 2), vc[:, n], precision)
    return torch.stack(ys, 1).reshape(BH, nb * c, hd)[:, :S], st
