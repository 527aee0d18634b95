"""Plain PyTorch version of the RG-LRU scan kernels.

The same function as ``csrc/rglru_scan_grouped.cu`` and
``csrc/rglru_scan.cu``: the inclusive recurrence ``h_t = a_t * h_{t-1} +
b_t`` over axis 1, with ``h_{-1} = 0``.  ``rglru_scan_ref`` is the log-depth
(Hillis-Steele) ladder of the reference's Pallas body: at step ``shift``
every position combines with the one ``shift`` before it, so ``ceil(log2
S)`` elementwise passes replace S sequential ones.  That keeps it usable as
the plain version on the card at S = 1024 (a Python loop over time would be
2048 launches).  It runs in the dtype it is given: the checks run it in f64.

Rounding: in f32 each ``h_t`` is a sum of ``b_s`` times products of ``a``
built in a tree of depth ``log2 S``, so it carries a few f32 ulps of ``|h|``
(about 1e-6 at the reference's test inputs, whose ``|h|`` stays below about
20), well inside the reference's 2e-5.  Where a is near 1 and S is long,
``|h|`` grows to about sqrt(S) and nothing decays the roundings, so an f32
tree or an f32 sequential walk drifts past 2e-5 from the recurrence in f64;
``rglru_scan_walk_ref`` shows the walk's drift.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b):
    """a, b: (B, S, C) f32 -> h (B, S, C) f32."""
    S = a.shape[1]
    A, H = a, b
    shift = 1
    while shift < S:
        H = torch.cat([H[:, :shift], A[:, shift:] * H[:, :-shift] + H[:, shift:]],
                      dim=1)
        A = torch.cat([A[:, :shift], A[:, shift:] * A[:, :-shift]], dim=1)
        shift *= 2
    return H


def rglru_scan_walk_ref(a, b, carry=torch.float64):
    """The kernels' walk in plain PyTorch: each channel in order, one
    multiply-add a step, h carried in ``carry`` and rounded to f32 where it
    is stored.  ``torch.float64`` is the channel-group kernel
    (``csrc/rglru_scan_grouped.cu``); ``torch.float32`` rounds h every step,
    as the earlier kernel's f32 FMA does (the product is exact in f64, so
    each step rounds once, up to a rare double rounding).  Slow: for the CPU
    tests."""
    a64, b64 = a.double(), b.double()
    h = torch.zeros_like(a64[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = (a64[:, t] * h + b64[:, t]).to(carry).double()
        out[:, t] = h
    return out
