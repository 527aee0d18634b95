"""Plain PyTorch version of the RG-LRU scan kernel.

The same function as ``csrc/rglru_scan.cu``: the inclusive recurrence
``h_t = a_t * h_{t-1} + b_t`` over axis 1, with ``h_{-1} = 0``.  It is the
log-depth (Hillis-Steele) ladder of the reference's Pallas body: at step
``shift`` every position combines with the one ``shift`` before it, so
``ceil(log2 S)`` elementwise passes replace S sequential ones.  That keeps it
usable as the plain version on the card at S = 1024 (a Python loop over time
would be 2048 launches).

Rounding: each ``h_t`` is a sum of ``b_s`` times products of ``a`` built in a
tree of depth ``log2 S``, so it carries a few f32 ulps of ``|h|`` (about 1e-6
at the reference's test inputs, whose ``|h|`` stays below about 20), well
inside the reference's 2e-5; the kernel's sequential FMAs and the
reference's associative scan round in other orders within the same bound.
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
