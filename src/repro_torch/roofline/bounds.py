"""The H100's rates and the least time the card could take for a piece of
work: the hand-written kernels' work (flops, bytes) and its bound.  Imports
only the standard library, so the kernels, ``roofline.analysis`` and
``chip_smoke.py`` all read one table."""
from __future__ import annotations

# NVIDIA H100 SXM5 (the card reports "NVIDIA H100 80GB HBM3", 700 W); data
# sheet rates, dense, without sparsity
PEAK_BF16_FLOPS = 989e12      # bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bandwidth, bytes/s
LINK_BW = 450e9               # NVLink 4, bytes/s per direction (900 GB/s both)
# the inter-node link: one 400 Gb/s NDR InfiniBand port per GPU, as on a
# DGX H100 (an assumption about the cluster, not a property of the card)
DCN_BW = 50e9


# ---------------------------------------------------------------------------
# bounds: the least time the card could take
# ---------------------------------------------------------------------------
def bound(flops: float, peak_flops: float, nbytes: float):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def causal_pairs(Sq: int, Skv: int, window: int = 0,
                 causal: bool = True, q0: int = 0) -> int:
    """The (q, kv) pairs a causal mask (with ``window``) allows to query
    rows at positions q0..q0 + Sq - 1: the row at position p sees
    min(p + 1, Skv, window) keys (``q0 = 0``: the mask aligned top-left)."""
    if not causal:
        return Sq * Skv
    cap = min(Skv, window) if window else Skv

    def first(n):               # the pairs of the rows at 0..n - 1
        if n <= cap:
            return n * (n + 1) // 2
        return cap * (cap + 1) // 2 + (n - cap) * cap
    return first(q0 + Sq) - first(q0)


def flash_work(BK, Sq, Skv, G, hd, window=0, causal=True, itemsize=2, q0=0):
    """(flops, bytes) of one flash call: two products of 2*hd each over the
    allowed (q, kv) pairs; q, k, v read once and o written once."""
    flops = 4 * hd * BK * G * causal_pairs(Sq, Skv, window, causal, q0)
    nbytes = (2 * BK * Sq * G * hd + 2 * BK * Skv * hd) * itemsize
    return flops, nbytes


def flash_bound(BK, S, G, hd, window):
    """One causal bf16 flash call: the operations the allowed (q, kv) pairs
    need at the bf16 tensor-core rate, against q, k, v read once and o
    written once at the HBM rate."""
    flops, nbytes = flash_work(BK, S, S, G, hd, window)
    return bound(flops, PEAK_BF16_FLOPS, nbytes)


def rglru_work(B, S, C):
    """a and b read once and h written once in f32, one FMA per element."""
    return 2 * B * S * C, 3 * B * S * C * 4


def rglru_bound(B, S, C):
    flops, nbytes = rglru_work(B, S, C)
    return bound(flops, PEAK_F32_FLOPS, nbytes)


def wkv6_work(BH, S, hd):
    """r, k, v, logw read once, y and the final state written once, u read,
    in f32; per step and head 4 operations per state element (the two FMAs
    of y, the product k v and the decay FMA) and one exp per key channel."""
    flops = 4 * BH * S * hd * hd + BH * S * hd
    nbytes = (5 * BH * S * hd + BH * hd + BH * hd * hd) * 4
    return flops, nbytes


def wkv6_bound(BH, S, hd):
    flops, nbytes = wkv6_work(BH, S, hd)
    return bound(flops, PEAK_F32_FLOPS, nbytes)
