"""How attention splits over the mesh dim named ``model`` where it has
more ranks than one kind of head, and the q-rows route.

``head_split`` says how ``tp`` ranks split H q heads and K kv heads:
``"kv_heads"`` (the layout's own cut), ``"q_heads"`` (C3: q's heads cut, k
and v whole, each rank reading one kv head: flash's ``_flash_q_heads``),
``"q_rows"`` (C5, C6: more ranks than q heads, a multiple of them) or
``"replicated"``.  ``run_q_rows`` is the q-rows route of any attention
that takes a row offset ``q0``: each rank one block of one head's rows,
the rows gathered back.  Flash's causal route and the plain dispatch of
``models.attention`` (the prefix and bidirectional masks,
cross-attention, a causal mask off flash) both run through it.
"""
from __future__ import annotations

import functools

from repro_torch.distributed import context
from repro_torch.roofline.trace import record_route

# where a mesh dim leaves k and v whole: only the batch may be cut
KV_SPLITS = {"batch": 0}
# where ``model`` has more ranks than q heads: q as (B, H*S, hd), cut on
# its rows (each rank one head's block of rows), k and v whole there
ROW_SPLITS = {"batch": 0, "q_rows": 1}


def head_split(H: int, K: int, tp: int) -> str:
    """How ``tp`` ranks of the ``model`` axis split an attention of ``H`` q
    heads and ``K`` kv heads (the reference's rules, ``layouts.
    choose_layout``, put ``heads`` on ``model`` where ``tp`` divides ``H``,
    ``kv_heads`` where it divides ``K``): ``"kv_heads"`` where ``tp``
    divides ``K`` (each rank a whole group of kv heads and their q heads);
    ``"q_heads"`` where each rank's ``H / tp`` q heads read one kv head
    (``tp > K`` and the group ``G = H / K`` a multiple of ``H / tp``; C3);
    ``"q_rows"`` where ``tp`` is a multiple of ``H`` that ``H`` does not
    reach (``heads`` on nothing; C5): each head spreads over ``n = tp / H``
    ranks, the rank at ``model`` coordinate ``r`` runs q head ``r // n``'s
    rows ``[j S / n, (j + 1) S / n)``, ``j = r % n``, against its kv head and
    the keys up to its last row; ``"replicated"`` where neither count
    divides the other (attention whole on every rank, as the reference's
    rules say).  Any other layout raises."""
    if K % tp == 0:
        return "kv_heads"
    if H % tp:
        return "q_rows" if tp % H == 0 else "replicated"
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


def _rows_local(q, k, v, *, fn, kernel: str, kv: int, q0: int):
    """One rank's block of one q head's rows (B, rows, hd): ``fn`` on them,
    as (B, rows, 1 kv head, 1, hd), against kv head ``kv``.  The narrows'
    gradients are zero on the other kv heads, so the sum over ranks of k's
    and v's is theirs.  The rows' shape goes to the trace as
    ``q_rows:<kernel>``."""
    B, rows, hd = q.shape
    record_route(f"q_rows:{kernel}", q.shape)
    o = fn(q.reshape(B, rows, 1, 1, hd), k.narrow(2, kv, 1),
           v.narrow(2, kv, 1), q0=q0)
    return o.reshape(B, rows, hd)


def run_q_rows(kernel: str, fn, q, k, v):
    """The q-rows route (``head_split``'s ``"q_rows"``) of the attention
    ``fn(q, k, v, *, q0)``: q (B,S,H,hd) and k, v (B,Skv,K,hd) whole over
    the mesh dim ``model`` of ``tp`` ranks, a multiple ``n`` of H.  q is
    viewed as (B, H*S, hd) and cut on dim 1 there (no data moves: it was
    whole), so the rank at coordinate r holds head r // n, row block
    j = r % n; through ``run_local`` it calls ``fn`` on those rows at
    ``q0`` = j S / n against its kv head, all Skv keys of it (k's and v's
    gradients come back ``Partial``), and the rows are gathered back to
    (B,S,H,hd) (an all-gather).  Rows that do not split over n raise,
    naming (H, K, tp, S).  Flash's route
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
    n = tp // H
    if S % n:
        raise ValueError(f"{kernel} cannot split (H, K, tp, S) = "
                         f"({H}, {K}, {tp}, {S}): the {S} rows of a head do "
                         f"not split over its {n} ranks")
    r = mesh.get_local_rank(m)
    qf = q.permute(0, 2, 1, 3).reshape(B, H * S, hd)
    qf = context.redistribute(qf, tuple(Shard(1) if d == m else p
                                        for d, p in enumerate(qf.placements)))
    o = context.run_local(
        kernel, functools.partial(_rows_local, fn=fn, kernel=kernel,
                                  kv=(r // n) // (H // K),
                                  q0=(r % n) * (S // n)),
        {"q": qf, "k": k, "v": v},
        {"q": ROW_SPLITS, "k": KV_SPLITS, "v": KV_SPLITS}, ROW_SPLITS)
    return context.unflatten(o, 1, (H, S)).permute(0, 2, 1, 3)
