"""Function state fusion (paper §4.2).

Functions sharing a runtime/sandbox form a fusion group; the middleware
retrieves/writes their states as ONE grouped storage operation, so storage
ops stay constant in the fusion depth instead of linear.  Keys keep
per-function isolation inside the group.

``plan_fusion_groups`` decides which workflow functions fuse: co-located on
the same node, contiguous in the DAG, and marked trusted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from repro_torch.core.keys import StateKey


@dataclass
class FusionGroup:
    group_id: str
    function_ids: List[str]
    node_id: str

    @property
    def depth(self) -> int:
        return len(self.function_ids)

    def storage_ops_fused(self) -> int:
        """One grouped read + one grouped write regardless of depth."""
        return 2

    def storage_ops_unfused(self) -> int:
        """Baseline: every function reads and writes individually."""
        return 2 * self.depth


def plan_fusion_groups(order: Sequence[str], placement: Dict[str, str],
                       trusted: Dict[str, bool] | None = None,
                       max_depth: int = 0, dag=None) -> List[FusionGroup]:
    """Greedy grouping of consecutive co-located trusted functions.

    ``order``: functions in topological order; ``placement``: fn -> node.
    ``max_depth``: 0 = unlimited.

    ``dag`` (optional): a ``Workflow``-like object exposing
    ``predecessors``/``successors``/``conditions``/``sync``.  When given,
    a function additionally fuses only when it extends a *linear run* —
    its sole predecessor is the group's tail and it is that tail's sole
    successor — and never across a conditional edge or into a sync
    barrier (the group is one sandbox executing sequentially; a branch
    point, a skippable edge, or a barrier must schedule as its own
    group).  Chains are linear runs, so ``dag=None`` — the engine's
    sequential path — and a chain-shaped ``dag`` produce the same
    groups."""
    groups: List[FusionGroup] = []
    cur: List[str] = []
    cur_node = None

    def flush():
        nonlocal cur, cur_node
        if cur:
            gid = f"fg{len(groups)}@{cur_node}"
            groups.append(FusionGroup(gid, list(cur), cur_node))
            cur = []
            cur_node = None

    def extends_run(f: str) -> bool:
        if dag is None or not cur:
            return True
        tail = cur[-1]
        return (dag.predecessors(f) == [tail]
                and dag.successors(tail) == [f]
                and (tail, f) not in dag.conditions
                and f not in dag.sync)

    for f in order:
        node = placement.get(f)
        ok = node is not None and (trusted is None or trusted.get(f, True))
        if not ok:
            flush()
            if node is not None:
                groups.append(FusionGroup(f"fg{len(groups)}@{node}", [f],
                                          node))
            continue
        if cur and (node != cur_node or
                    (max_depth and len(cur) >= max_depth) or
                    not extends_run(f)):
            flush()
        if not cur:
            cur_node = node
        cur.append(f)
    flush()
    return groups


@dataclass
class FusedFetch:
    """A grouped state operation issued by the middleware: the keys of every
    fused function, served by one request to the (local or global) store."""
    group: FusionGroup
    keys: List[StateKey]

    def total_bytes(self, sizes: Dict[str, float]) -> float:
        return sum(sizes.get(k.function_id, 0.0) for k in self.keys)
