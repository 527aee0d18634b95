"""How attention splits over the mesh dim named ``model`` where it has
more ranks than one kind of head, and the q-rows route.

``head_split`` says how ``tp`` ranks split H q heads and K kv heads:
``"kv_heads"`` (the layout's own cut), ``"q_heads"`` (C3: q's heads cut, k
and v whole, each rank reading one kv head: flash's ``_flash_q_heads``) or
``"q_rows"`` (C5, C6, C10: ``tp`` does not divide H; each rank one group
of heads' block of rows).  ``run_q_heads`` is the q-heads route of any
attention (C3, C11): each rank its own q heads against the one kv head
they read.  ``run_q_rows`` is the q-rows route of any attention that takes
a row offset ``q0``: each rank one head group's block of rows, the rows
gathered back.  Flash's causal route and the plain dispatch of
``models.attention`` (the prefix and bidirectional masks, cross-attention,
a causal mask off flash) both run through each.
"""
from __future__ import annotations

import functools
import math

from repro_torch.distributed import context
from repro_torch.roofline.trace import record_route

# where a mesh dim leaves k and v whole: only the batch may be cut
KV_SPLITS = {"batch": 0}
# the q-heads route: q (B,S,H,hd) cut on its heads, k and v whole there
HEAD_SPLITS = {"batch": 0, "q_heads": 2}
# where ``model`` does not divide the q heads: q as (B, g*n, S/n, H/g, hd),
# cut on dim 1 (each rank one head group's block of rows), k and v whole
# there
ROW_SPLITS = {"batch": 0, "q_rows": 1}


def row_groups(H: int, tp: int) -> tuple:
    """The q-rows route's cut of H q heads over ``tp`` ranks: (g, n), g =
    gcd(H, tp) groups of H / g heads, each group's rows in n = tp / g
    blocks."""
    g = math.gcd(H, tp)
    return g, tp // g


def head_split(H: int, K: int, tp: int) -> str:
    """How ``tp`` ranks of the ``model`` axis split an attention of ``H`` q
    heads and ``K`` kv heads (the reference's rules, ``layouts.
    choose_layout``, put ``heads`` on ``model`` where ``tp`` divides ``H``,
    ``kv_heads`` where it divides ``K``): ``"kv_heads"`` where ``tp``
    divides ``K`` (each rank a whole group of kv heads and their q heads);
    ``"q_heads"`` where each rank's ``H / tp`` q heads read one kv head
    (``tp > K`` and the group ``G = H / K`` a multiple of ``H / tp``; C3);
    ``"q_rows"`` where ``tp`` does not divide ``H`` (``heads`` on nothing;
    C5, C10): the heads fall into g = gcd(H, tp) groups of H / g, each
    group's rows into n = tp / g blocks (``row_groups``), and the rank at
    ``model`` coordinate ``r`` runs group ``r // n``'s rows ``[j S / n,
    (j + 1) S / n)``, ``j = r % n``, against its kv heads and the keys up
    to its last row; a group must hold whole kv groups or lie inside one
    kv head.  Any other layout raises, naming (H, K, tp)."""
    if K % tp == 0:
        return "kv_heads"
    if H % tp:
        h = H // row_groups(H, tp)[0]
        G = H // K
        if h % G == 0 or G % h == 0:
            return "q_rows"
        raise ValueError(f"attention cannot split (H, K, tp) = ({H}, {K}, "
                         f"{tp}): a group of {h} q heads holds no whole kv "
                         f"groups of {G} and lies in more than one kv head")
    if tp > K and (H // K) % (H // tp) == 0:
        return "q_heads"
    raise ValueError(f"flash attention cannot split (H, K, tp) = "
                     f"({H}, {K}, {tp}): each rank's {H // tp} q heads read "
                     f"more than one of the {K} kv heads")


def splits_q_heads(q, k) -> bool:
    """Whether the DTensors q (B,S,H,hd) and k (B,Skv,K,hd) take the q-heads
    route: a mesh dim of more than one rank cuts q's heads and not k's."""
    if not (context.is_dtensor(q) and context.is_dtensor(k)):
        return False
    mesh = q.device_mesh
    return any(p.is_shard(2) and mesh.size(m) > 1
               and not k.placements[m].is_shard(2)
               for m, p in enumerate(q.placements))


def _model_dim(mesh):
    """The index of the mesh dim named ``model``, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def q_rows_dim(q, K: int):
    """The index of the mesh dim named ``model`` where the DTensor q
    (B,S,H,hd), whole there, takes the q-rows route against ``K`` kv heads
    (its ``tp`` ranks split (H, K) as ``"q_rows"``, ``head_split``); else
    None."""
    if not context.is_dtensor(q):
        return None
    m = _model_dim(q.device_mesh)
    if m is None:
        return None
    H, tp = q.shape[2], q.device_mesh.size(m)
    if tp > 1 and H % tp != 0 and q.placements[m].is_replicate() and \
            head_split(H, K, tp) == "q_rows":
        return m
    return None


def splits_q_rows(q, k) -> bool:
    """Whether the DTensors q (B,S,H,hd) and k (B,Skv,K,hd) take the q-rows
    route: the mesh dim named ``model`` cuts neither, and its ``tp`` ranks
    split (H, K) as ``"q_rows"`` (``head_split``)."""
    if not (context.is_dtensor(q) and context.is_dtensor(k)):
        return False
    m = q_rows_dim(q, k.shape[2])
    return m is not None and k.placements[m].is_replicate()


def _heads_local(q, k, v, *, fn, kernel: str, kv: int):
    """One rank's q heads (B,S,h,hd), all of them in kv head ``kv``: ``fn``
    on them as (B,S,1,h,hd) against that kv head alone.  The narrow's
    gradient is zero on the other kv heads, so the sum over ranks of k's
    and v's is theirs.  The heads' shape (B,S,h,hd) goes to the trace as
    ``q_heads:<kernel>``."""
    B, S, h, hd = q.shape
    record_route(f"q_heads:{kernel}", (B, S, h, hd))
    o = fn(q.reshape(B, S, 1, h, hd), k.narrow(2, kv, 1), v.narrow(2, kv, 1))
    return o.reshape(B, S, h, hd)


def run_q_heads(kernel: str, fn, q, k, v):
    """The q-heads route (``head_split``'s ``"q_heads"``) of the attention
    ``fn(q, k, v)`` (q (B,S,K,G,hd)): q (B,S,H,hd) cut on its heads over
    one mesh dim whose ranks hold k and v (B,Skv,K,hd) whole; the rank at
    coordinate r there runs q heads [r h, (r + 1) h) against kv head r h //
    G (h = H / tp) through ``run_local``, and k's and v's gradients come
    back ``Partial`` there.  The output (B,S,H,hd) stays cut on its heads.
    Any other layout raises, naming the placements.  Flash's route
    (``kernels.flash_attention.ops._flash_q_heads``) and the plain dispatch
    (``models.attention.attention_q_heads``) both take it."""
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    on = [m for m, p in enumerate(q.placements)
          if p.is_shard(2) and mesh.size(m) > 1]
    where = (f"placements q {tuple(q.placements)}, k {tuple(k.placements)}, "
             f"v {tuple(v.placements)}")
    if len(on) != 1 or H % K or any(t.placements[on[0]].is_shard(2)
                                    for t in (k, v)):
        raise ValueError(f"{kernel}: q's {H} heads are cut on mesh dims "
                         f"{on}, the route takes one that leaves k and v "
                         f"whole; {where}")
    tp = mesh.size(on[0])
    try:
        how = head_split(H, K, tp)
    except ValueError as e:
        raise ValueError(f"{e}; {where}") from None
    if how != "q_heads":
        raise ValueError(f"{kernel}: (H, K, tp) = ({H}, {K}, {tp}) splits "
                         f"{how}, not q heads; {where}")
    kv = mesh.get_local_rank(on[0]) * (H // tp) // (H // K)
    return context.run_local(
        kernel, functools.partial(_heads_local, fn=fn, kernel=kernel, kv=kv),
        {"q": q, "k": k, "v": v},
        {"q": HEAD_SPLITS, "k": KV_SPLITS, "v": KV_SPLITS}, HEAD_SPLITS)


def _rows_local(q, k, v, *, fn, kernel: str, kv: int, nk: int, q0: int):
    """One rank's block of one head group's rows (B, 1, rows, h, hd): ``fn``
    on them as (B, rows, nk kv heads, h / nk, hd) against kv heads ``kv``
    to ``kv + nk``.  The narrows' gradients are zero on the other kv heads,
    so the sum over ranks of k's and v's is theirs.  The rows' shape (B,
    rows, h, hd) goes to the trace as ``q_rows:<kernel>``."""
    B, _, rows, h, hd = q.shape
    record_route(f"q_rows:{kernel}", (B, rows, h, hd))
    o = fn(q.reshape(B, rows, nk, h // nk, hd), k.narrow(2, kv, nk),
           v.narrow(2, kv, nk), q0=q0)
    return o.reshape(B, 1, rows, h, hd)


def run_q_rows(kernel: str, fn, q, k, v):
    """The q-rows route (``head_split``'s ``"q_rows"``) of the attention
    ``fn(q, k, v, *, q0)``: q (B,S,H,hd) and k, v (B,Skv,K,hd) whole over
    the mesh dim ``model`` of ``tp`` ranks, which do not divide H: g head
    groups of h = H / g heads, each group's rows in n blocks
    (``row_groups``).  q is viewed as (B, g*n, S/n, h, hd) (group major)
    and cut on dim 1 there (no data moves: it was whole), so the rank at
    coordinate r holds group r // n's row block j = r % n; through
    ``run_local`` it calls ``fn`` on those rows at ``q0`` = j S / n against
    its group's kv heads, all Skv keys of them (k's and v's gradients come
    back ``Partial``), and the rows are gathered back to (B,S,H,hd) (an
    all-gather).  Where g = H, one head a group, this is C5's route.  Rows
    that do not split over n raise, naming (H, K, tp, S).  Flash's route
    (``kernels.flash_attention.ops._flash_q_rows``) and the plain dispatch
    (``models.attention.attention_q_rows``) both take it."""
    from torch.distributed.tensor import Shard
    if not splits_q_rows(q, k):
        raise ValueError(f"{kernel}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not take the q-rows route; "
                         f"placements q {tuple(q.placements)}, k "
                         f"{tuple(k.placements)}")
    mesh = q.device_mesh
    m = _model_dim(mesh)
    B, S, H, hd = q.shape
    K, tp = k.shape[2], mesh.size(m)
    g, n = row_groups(H, tp)
    h, G = H // g, H // K
    if S % n:
        raise ValueError(f"{kernel} cannot split (H, K, tp, S) = "
                         f"({H}, {K}, {tp}, {S}): the {S} rows of a head "
                         f"group do not split over its {n} ranks")
    r = mesh.get_local_rank(m)
    qf = q.reshape(B, n, S // n, g, h, hd).permute(0, 3, 1, 2, 4, 5) \
        .reshape(B, g * n, S // n, h, hd)
    qf = context.redistribute(qf, tuple(Shard(1) if d == m else p
                                        for d, p in enumerate(qf.placements)))
    o = context.run_local(
        kernel, functools.partial(_rows_local, fn=fn, kernel=kernel,
                                  kv=(r // n) * h // G, nk=max(h // G, 1),
                                  q0=(r % n) * (S // n)),
        {"q": qf, "k": k, "v": v},
        {"q": ROW_SPLITS, "k": KV_SPLITS, "v": KV_SPLITS}, ROW_SPLITS)
    o = context.replicate_dim(o, 1).reshape(B, g, n, S // n, h, hd)
    return o.permute(0, 2, 3, 1, 4, 5).reshape(B, S, H, hd)
