"""DAG workflow subsystem: branch, conditional, ranked fan-out, sync.

The FaaSr catalog of real serverless workflow shapes, on top of the
``Workflow`` model:

* **branch** — one function feeds several independent successors; the
  engine runs each branch as a concurrent child kernel process.
* **conditional edge** — ``DagEdge(condition=payload -> bool)``; when the
  predicate returns False the destination (and transitively everything
  that strictly depends on it) is *skipped*.
* **ranked fan-out** — ``DagEdge(rank=N)`` expands the destination into N
  siblings ``dst#1..dst#N``, each consuming a ``1/N`` chunk of the
  predecessor's output (``Workflow.chunk``) and writing its own state —
  N siblings hitting the storage tier at once.
* **sync barrier** — a function named in ``Workflow.sync`` waits until
  ALL its in-edges have *resolved* (source done or skipped) and runs when
  ANY of them is live.  A skipped branch therefore releases the barrier
  deterministically instead of deadlocking it.  A non-sync fan-in is
  strict: one skipped predecessor skips it too.

Execution is classic dataflow over a *group graph*: functions fuse into
linear runs (``plan_dag_groups``, via ``repro_torch.core.fusion``), each group
runs as one child process on the shared kernel, and the last-resolving
predecessor launches each successor group — so joins need no polling and
the spawn order is a pure function of the event order.  ``DagSchedule``
is the engine-agnostic liveness/barrier bookkeeping; the engine's
``_dag_run`` drives it (``repro_torch.serverless.engine``).
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.fusion import FusionGroup, plan_fusion_groups
from repro_torch.core.slo import FunctionDemand
from repro_torch.serverless.workflow import ServerlessFunction, Workflow


# ---------------------------------------------------------------------------
# edge model + rank expansion
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DagEdge:
    """One workflow edge with optional DAG semantics.

    ``condition`` gates the destination (evaluated on the source's
    payload when it completes); ``rank=N`` expands the destination into N
    chunked siblings.  Rank is a property of the *destination*: every
    edge into the same destination must agree on it."""
    src: str
    dst: str
    condition: Optional[Callable[[dict], bool]] = None
    rank: int = 1


def build_dag(workflow_id: str, functions: Sequence[ServerlessFunction],
              edges: Sequence[Union[DagEdge, Tuple[str, str]]],
              sync: Sequence[str] = (), sink_in_cloud: bool = True
              ) -> Workflow:
    """Assemble a ``Workflow`` from ``DagEdge`` declarations, expanding
    ranked fan-out: an edge ``A -(rank=N)-> B`` clones B into siblings
    ``B#1..B#N`` (demand copied, ``chunk=1/N`` each), duplicates every
    in-edge per sibling (conditions copied) and every out-edge per
    sibling — so B's consumer becomes an N-way fan-in.  Plain
    ``(src, dst)`` tuples are accepted as unconditioned rank-1 edges."""
    norm = [e if isinstance(e, DagEdge) else DagEdge(*e) for e in edges]
    rank_of: Dict[str, int] = {}
    for e in norm:
        r = int(e.rank)
        if r < 1:
            raise ValueError(f"edge {e.src}->{e.dst} has rank {r}; "
                             f"rank must be >= 1")
        prev = rank_of.setdefault(e.dst, r)
        if prev != r:
            raise ValueError(
                f"destination {e.dst!r} has inconsistent ranks "
                f"({prev} vs {r}); rank is a property of the "
                f"destination across all its in-edges")
    ranked_sync = sorted(n for n in sync if rank_of.get(n, 1) > 1)
    if ranked_sync:
        raise ValueError(f"sync barrier(s) {ranked_sync} cannot be "
                         f"ranked destinations — the barrier joins the "
                         f"siblings, it cannot be one")

    def expand(name: str) -> List[str]:
        r = rank_of.get(name, 1)
        return [name] if r == 1 else [f"{name}#{k}"
                                      for k in range(1, r + 1)]

    fns: List[ServerlessFunction] = []
    chunk: Dict[str, float] = {}
    for f in functions:
        r = rank_of.get(f.name, 1)
        if r == 1:
            fns.append(f)
            continue
        for k in range(1, r + 1):
            cname = f"{f.name}#{k}"
            fns.append(replace(f, name=cname,
                               demand=replace(f.demand, name=cname)))
            chunk[cname] = 1.0 / r
    wf_edges: List[Tuple[str, str]] = []
    conditions: Dict[Tuple[str, str], Callable] = {}
    for e in norm:
        for s in expand(e.src):
            for d in expand(e.dst):
                wf_edges.append((s, d))
                if e.condition is not None:
                    conditions[(s, d)] = e.condition
    return Workflow(workflow_id, fns, wf_edges,
                    sink_in_cloud=sink_in_cloud, conditions=conditions,
                    sync=tuple(sync), chunk=chunk)


# ---------------------------------------------------------------------------
# shape builders (the Scenario workflow registry's DAG axes)
# ---------------------------------------------------------------------------
def _light_fn(name: str, out_ratio: float = 1.0,
              compute_s_per_mb: float = 0.05) -> ServerlessFunction:
    """Lightweight virtual function matching ``chain_workflow``'s cells,
    so DAG shape is the only variable against the chain baselines."""
    return ServerlessFunction(
        name, None, out_ratio=out_ratio,
        demand=FunctionDemand(name, cpu=0.25, mem=64e6, power=2.0,
                              t_exc=1.0),
        compute_s_per_mb=compute_s_per_mb)


def branch_workflow(workflow_id: str, width: int = 2) -> Workflow:
    """``split`` feeding ``width`` independent terminal branches
    (FaaSr: A -> B, C).  No join: each branch's state is terminal."""
    width = max(2, int(width))
    fns = [_light_fn("split")] + [_light_fn(f"b{i}", out_ratio=0.5)
                                  for i in range(1, width + 1)]
    edges = [DagEdge("split", f"b{i}") for i in range(1, width + 1)]
    return build_dag(workflow_id, fns, edges)


def diamond_workflow(workflow_id: str, width: int = 2) -> Workflow:
    """``split`` -> ``width`` parallel branches -> sync ``join``: the
    canonical fork/join diamond."""
    width = max(2, int(width))
    fns = [_light_fn("split")] + \
        [_light_fn(f"b{i}", out_ratio=0.5)
         for i in range(1, width + 1)] + [_light_fn("join")]
    edges = [DagEdge("split", f"b{i}") for i in range(1, width + 1)] + \
        [DagEdge(f"b{i}", "join") for i in range(1, width + 1)]
    return build_dag(workflow_id, fns, edges, sync=("join",))


def fanout_workflow(workflow_id: str, width: int = 3) -> Workflow:
    """Ranked fan-out (FaaSr: A -> B(1..N) -> sync): ``split`` scatters
    1/N chunks to ``work#1..work#N``, which all write state at once; the
    sync ``join`` gathers every chunk — the fan-in where a shared
    runtime fuses N branch reads into ONE ``get_fused``."""
    width = max(2, int(width))
    fns = [_light_fn("split"), _light_fn("work"), _light_fn("join")]
    edges = [DagEdge("split", "work", rank=width),
             DagEdge("work", "join")]
    return build_dag(workflow_id, fns, edges, sync=("join",))


def _wid_even(payload: dict) -> bool:
    """Deterministic per-instance coin: CRC32 parity of the workflow id
    (the synthetic condition payload always carries it)."""
    return zlib.crc32(str(payload.get("workflow_id", "")).encode()) \
        % 2 == 0


def _wid_odd(payload: dict) -> bool:
    return not _wid_even(payload)


def conditional_workflow(workflow_id: str) -> Workflow:
    """Conditional branch (FaaSr: A -True-> B / -False-> C) joined by a
    sync: exactly one of ``hi``/``lo`` runs per instance (CRC32 parity
    of the workflow id) and the skipped branch must release ``join``'s
    barrier, not deadlock it."""
    fns = [_light_fn("split"), _light_fn("hi", out_ratio=0.5),
           _light_fn("lo", out_ratio=0.5), _light_fn("join")]
    edges = [DagEdge("split", "hi", condition=_wid_even),
             DagEdge("split", "lo", condition=_wid_odd),
             DagEdge("hi", "join"), DagEdge("lo", "join")]
    return build_dag(workflow_id, fns, edges, sync=("join",))


# ---------------------------------------------------------------------------
# group graph: fusion groups + inter-group edges
# ---------------------------------------------------------------------------
@dataclass
class GroupGraph:
    """The instance's execution graph: fusion groups as nodes, the
    workflow edges that cross group boundaries as edges."""
    groups: List[FusionGroup]
    owner: Dict[str, str]                          # function -> group id
    # gid -> [(src_fn, dst_fn, src_gid)] in workflow edge order; every
    # dst_fn is the group's head (interior functions fuse only along
    # their single in-group predecessor)
    preds: Dict[str, List[Tuple[str, str, str]]]
    succs: Dict[str, List[str]]                    # dedup, edge order
    by_id: Dict[str, FusionGroup] = field(default_factory=dict)

    def __post_init__(self):
        if not self.by_id:
            self.by_id = {g.group_id: g for g in self.groups}

    def entry_groups(self) -> List[FusionGroup]:
        return [g for g in self.groups if not self.preds[g.group_id]]


def plan_dag_groups(wf: Workflow, placement: Dict[str, str],
                    max_depth: int = 0) -> GroupGraph:
    """DAG-aware fusion grouping: ``plan_fusion_groups`` with the
    workflow as adjacency, so fusion only packs *linear runs* (see
    ``repro_torch.core.fusion``), then the inter-group edge lists the
    scheduler joins on."""
    groups = plan_fusion_groups(wf.order(), placement,
                                max_depth=max_depth, dag=wf)
    owner = {f: g.group_id for g in groups for f in g.function_ids}
    preds: Dict[str, List[Tuple[str, str, str]]] = \
        {g.group_id: [] for g in groups}
    succs: Dict[str, List[str]] = {g.group_id: [] for g in groups}
    for u, v in wf.edges:
        gu, gv = owner[u], owner[v]
        if gu == gv:
            continue
        preds[gv].append((u, v, gu))
        if gv not in succs[gu]:
            succs[gu].append(gv)
    return GroupGraph(groups, owner, preds, succs)


# ---------------------------------------------------------------------------
# deterministic liveness / barrier bookkeeping
# ---------------------------------------------------------------------------
class DagSchedule:
    """Per-instance dataflow state machine (engine-agnostic, no kernel).

    Groups resolve exactly once — *done* (their child process finished)
    or *skipped* (liveness decided against them).  ``resolve`` is called
    by the engine when a live group's process completes; it settles the
    group's outgoing edges, cascades skips iteratively (breadth-first in
    edge order — no recursion, no set iteration), and returns the
    successor groups that just became runnable together with the time
    their first in-edge resolved (the barrier-wait start)."""

    def __init__(self, gg: GroupGraph, wf: Workflow):
        self.gg = gg
        self.wf = wf
        self.unresolved: Dict[str, int] = {
            g.group_id: len(gg.preds[g.group_id]) for g in gg.groups}
        self.edge_live: Dict[Tuple[str, str], bool] = {}
        self.first_arrival: Dict[str, float] = {}
        self.remaining = len(gg.groups)
        self.skipped: List[str] = []      # resolution order, for replay

    def _group_live(self, gid: str) -> bool:
        in_edges = self.gg.preds[gid]
        if not in_edges:
            return True
        head = self.gg.by_id[gid].function_ids[0]
        lives = [self.edge_live[(u, v)] for (u, v, _) in in_edges]
        if head in self.wf.sync:
            return any(lives)      # barrier: all resolved, any live
        return all(lives)          # strict fan-in: any skip skips it

    def resolve(self, gid: str, now: float,
                eval_edge: Callable[[str, str], bool]
                ) -> Tuple[List[Tuple[FusionGroup, Optional[float]]],
                           List[str]]:
        """Settle completion of live group ``gid`` at time ``now``.
        Returns ``(to_spawn, newly_skipped)``: runnable successor groups
        as ``(group, first_arrival_t)`` and the group ids the skip
        cascade resolved, both in deterministic (edge) order."""
        spawn: List[Tuple[FusionGroup, Optional[float]]] = []
        fresh_skips: List[str] = []
        work = deque([(gid, False)])
        while work:
            g, skip = work.popleft()
            self.remaining -= 1
            if skip:
                self.skipped.append(g)
                fresh_skips.append(g)
            for sgid in self.gg.succs[g]:
                for (u, v, src_gid) in self.gg.preds[sgid]:
                    if src_gid != g:
                        continue
                    self.edge_live[(u, v)] = \
                        (not skip) and eval_edge(u, v)
                    self.unresolved[sgid] -= 1
                    self.first_arrival.setdefault(sgid, now)
                if self.unresolved[sgid] == 0:
                    if self._group_live(sgid):
                        spawn.append((self.gg.by_id[sgid],
                                      self.first_arrival.get(sgid)))
                    else:
                        work.append((sgid, True))
        return spawn, fresh_skips
