"""Workflow placement planner: the Eq. 9 optimization heuristic.

    min_x  sum_{(fi,fj) in E} sum_{(ns,nd)} (L(ns,nd) + gamma(ns,nd)) x_is x_jd
    s.t.   R-1 .. R-7

Functions are placed greedily along the workflow's topological order —
HyperDrive-style vicinity sampling around the predecessor, then SLO/QoS
filtering and R-constraint checks, then latency scoring (paper §2.2) with
the R-7 locality penalty.  Candidate-subset pruning keeps node election
sub-linear in the topology size (paper Fig. 16 / §6.5).

``plan_mesh_layout`` applies the same objective to the TPU build: candidate
sharding layouts are scored by their estimated collective cost over the mesh
topology (ICI within a pod, DCN between pods) and the Eq. 9 minimizer wins.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.slo import SLO, FunctionDemand
from repro_torch.core.topology import CLOUD, SAT, TopologyGraph


@dataclass
class WorkflowSpec:
    """Workflow DAG W = (F, E)."""
    functions: List[str]
    edges: List[Tuple[str, str]]          # (fi, fj): fi's output feeds fj
    demands: Dict[str, FunctionDemand]
    state_sizes: Dict[str, float]         # bytes produced by each function
    sink_kind: str = CLOUD                # final function gravitates here
                                          # ("" disables the sink rule)

    def _edge_cache(self):
        """Memoized (topo order, predecessor lists, successor lists).

        The spec is static once the engine starts planning, but a spec is
        a plain mutable dataclass, so the memo is guarded on the list
        lengths — appending a function or edge rebuilds it.  (In-place
        element *replacement* is not detected; no caller does that.)
        The planner asks for the order and the predecessors of every
        function once per instance, which at 100k instances made these
        linear edge scans a measurable hot spot."""
        guard = (len(self.functions), len(self.edges))
        cached = self.__dict__.get("_edges_memo")
        if cached is not None and cached[0] == guard:
            return cached[1]
        preds: Dict[str, List[str]] = {f: [] for f in self.functions}
        succs: Dict[str, List[str]] = {f: [] for f in self.functions}
        for i, j in self.edges:
            preds.setdefault(j, []).append(i)
            succs.setdefault(i, []).append(j)
        indeg = {f: len(preds.get(f, ())) for f in self.functions}
        order, frontier = [], [f for f, d in indeg.items() if d == 0]
        while frontier:
            f = frontier.pop(0)
            order.append(f)
            for j in succs.get(f, ()):
                indeg[j] -= 1
                if indeg[j] == 0:
                    frontier.append(j)
        memo = (order, preds, succs)
        self.__dict__["_edges_memo"] = (guard, memo)
        return memo

    def topo_order(self) -> List[str]:
        return self._edge_cache()[0]

    def predecessors(self, f: str) -> List[str]:
        return self._edge_cache()[1].get(f, [])

    def successors(self, f: str) -> List[str]:
        return self._edge_cache()[2].get(f, [])


@dataclass
class Plan:
    placement: Dict[str, str]             # function -> node
    objective: float
    candidates_considered: int


def vicinity(graph: TopologyGraph, center: str, radius_s: float,
             limit: int = 64) -> List[str]:
    """Nodes within ``radius_s`` seconds of latency of ``center``, nearest
    first (ties on node id), pruned at ``limit`` candidates.

    Resolved from the per-source SSSP tree ``TopologyGraph`` already caches
    for ``dijkstra`` — one pass serves every placement query from the same
    anchor instead of re-walking the graph per function.  Distances are
    exact shortest paths (the old standalone BFS froze a node's distance at
    the first push, overestimating on multi-path topologies).  The sorted
    ball is memoized on the graph (version-guarded): every instance
    planned in the same snapshot quantum asks for the same few anchors.
    Treat the returned list as read-only."""
    key = (center, radius_s, limit)
    hit = graph._vicinity.get(key)
    if hit is not None and hit[0] == graph._version:
        return hit[1]
    dist, _ = graph.sssp(center)
    near = sorted((d, n) for n, d in dist.items()
                  if d <= radius_s and n in graph.nodes)
    out = [n for _, n in near[:limit]]
    graph._vicinity[key] = (graph._version, out)
    return out


def vicinity_of_kinds(graph: TopologyGraph, center: str, radius_s: float,
                      kinds, limit: int = 64) -> List[str]:
    """``vicinity`` filtered to nodes whose kind is in ``kinds`` — the
    planner's candidate list.  Memoized on the graph alongside the
    unfiltered ball (the 4-tuple key cannot collide with vicinity's
    3-tuples), so the per-function kind scan runs once per (snapshot,
    anchor) instead of once per planned instance.  Read-only."""
    key = (center, radius_s, limit, tuple(kinds))
    hit = graph._vicinity.get(key)
    if hit is not None and hit[0] == graph._version:
        return hit[1]
    nodes = graph.nodes
    out = [n for n in vicinity(graph, center, radius_s, limit)
           if nodes[n].kind in kinds]
    graph._vicinity[key] = (graph._version, out)
    return out


def vicinity_uncached(graph: TopologyGraph, center: str, radius_s: float,
                      limit: int = 64) -> List[str]:
    """Reference implementation: exact Dijkstra ball around ``center`` with
    no memoization.  Kept for cache-consistency tests (must stay
    path-identical to ``vicinity``)."""
    import heapq
    dist = {center: 0.0}
    pq = [(0.0, center)]
    seen = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        for v, link in graph.neighbors(u).items():
            if v in seen or v not in graph.nodes:
                continue
            nd = d + link.latency
            if nd <= radius_s and nd < dist.get(v, math.inf):
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    near = sorted((d, n) for n, d in dist.items() if n in graph.nodes)
    return [n for _, n in near[:limit]]


COMPUTE_KINDS = ("satellite", "cloud", "edge", "ground")


def plan_workflow(graph: TopologyGraph, wf: WorkflowSpec, slo: SLO,
                  entry_node: str, radius_s: float = 0.05,
                  gamma_per_hop: float = 0.005,
                  compute_kinds=COMPUTE_KINDS,
                  busy: Optional[Dict[str, float]] = None,
                  now: float = 0.0, busy_weight: float = 1.0,
                  home_nodes: Optional[Sequence[str]] = None,
                  region_weight: float = 0.0,
                  undo_log: Optional[list] = None) -> Plan:
    """Greedy Eq. 9 minimizer with vicinity pruning + R-constraint checks.

    ``busy`` (node -> busy-until time) adds HyperDrive-style load
    awareness: queue wait joins the latency score, spreading concurrent
    workflows.  When the busy view projects *pending* autoscale grows
    (``repro_torch.sim.resources``), a pool mid-scale-up scores by its
    provisioning ready time, not its current queue depth.

    ``home_nodes`` + ``region_weight`` make the score region-aware
    (multi-region continuum): a candidate is charged how much *farther*
    from the nearest global-tier home shard (cloud region) it sits than
    the anchor already is.  Staying equally region-local is free — a
    satellite over the anchor's region scores like the anchor — but
    drifting toward a foreign region pays the WAN distance, keeping
    placements near the shard that serves this workflow's redundancy
    writes and fallback reads.

    The sink node (R-6 gravity) is the *nearest* node of ``sink_kind``
    from the entry, so in a multi-region topology each workflow sinks to
    its own region's cloud rather than a global first-by-id one.

    ``undo_log`` (when given) records every node-accounting mutation as
    ``(node, mem_used, cpu_used, power_used, temp_extra)`` with the
    values *before* the mutation.  Replaying it in reverse restores the
    exact prior floats — which is what lets a caller plan directly on a
    shared graph (keeping its warm SSSP caches) instead of paying a
    ``copy_shallow`` per plan.  Subtracting the demands back out would
    NOT be equivalent: ``(x + d) - d`` can differ from ``x`` in the last
    ulp, and repeated over 100k plans that residue drifts."""
    placement: Dict[str, str] = {}
    considered = 0
    objective = 0.0
    cloud = graph.nearest_of_kind(entry_node, wf.sink_kind) or entry_node
    home_dists = [graph.sssp(h)[0] for h in home_nodes
                  if h in graph.nodes] \
        if home_nodes and region_weight > 0.0 else []
    order = wf.topo_order()
    # per-source (dist, hop-count) tables hoisted out of the candidate
    # loop: dist[n] is exactly dijkstra(src, n)'s latency and
    # hops_map(src)[n] exactly hops(src, n), so the score below is
    # bit-identical to the per-pair form it replaces.
    srcinfo: Dict[str, tuple] = {}
    for f in order:
        preds = wf.predecessors(f)
        anchor = placement.get(preds[0]) if preds else entry_node
        anchor = anchor or entry_node
        # R-6 sink gravity applies to every terminal function: in a
        # linear workflow that is exactly the last topo entry (the old
        # rule), in a branching one every branch tip sinks to its cloud
        is_sink = wf.sink_kind and not wf.successors(f)
        if is_sink and cloud in graph.nodes:
            cands = [cloud]
        else:
            placed_srcs = [placement[p] for p in preds
                           if p in placement]
            if len(placed_srcs) > 1:
                # branch-aware fan-in: candidates from EVERY placed
                # predecessor's vicinity (first-appearance order, so
                # the scan is deterministic), letting the R-4 handoff
                # cost over all branches pick the join node instead of
                # anchoring blindly on the first branch
                seen: Dict[str, bool] = {}
                cands = []
                for src in placed_srcs:
                    for c in vicinity_of_kinds(graph, src, radius_s,
                                               compute_kinds):
                        if c not in seen:
                            seen[c] = True
                            cands.append(c)
            else:
                cands = vicinity_of_kinds(graph, anchor, radius_s,
                                          compute_kinds)
        considered += len(cands)
        anchor_home = 0.0
        if home_dists:
            anchor_home = min(d.get(anchor, math.inf) for d in home_dists)
            if not math.isfinite(anchor_home):
                anchor_home = 0.0
        best, best_cost = None, math.inf
        d = wf.demands[f]
        for n in cands:
            node = graph.nodes.get(n)
            if node is None:
                continue
            # R-1 / R-2 / R-3 on the incremental placement
            if node.mem_used + d.mem > node.mem or \
                    node.cpu_used + d.cpu > node.cpu or \
                    node.power_used + d.power > node.power_avail:
                continue
            if node.kind == SAT and \
                    node.t_orb + node.temp_extra + d.t_exc > node.t_max:
                continue
            # R-4: handoff SLO from every placed predecessor
            cost = 0.0
            ok = True
            for p in preds:
                src = placement.get(p)
                if src is None:
                    continue
                info = srcinfo.get(src)
                if info is None:
                    info = (graph.sssp(src)[0], graph.hops_map(src))
                    srcinfo[src] = info
                lat = info[0].get(n, math.inf)
                if lat > slo.max_handoff_s:
                    ok = False
                    break
                # == lat + locality_penalty(graph, src, n, gamma_per_hop)
                cost += lat + gamma_per_hop * info[1][n]
            if not ok:
                continue
            if busy is not None:
                cost += busy_weight * max(busy.get(n, 0.0) - now, 0.0)
            if home_dists:
                hd = min(d.get(n, math.inf) for d in home_dists)
                if not math.isfinite(hd):
                    hd = 1.0   # detached from every home: flat penalty
                cost += region_weight * max(0.0, hd - anchor_home)
            if cost < best_cost:
                best, best_cost = n, cost
        if best is None:
            # R-6 requires a placement: fall back to the anchor
            best, best_cost = anchor, slo.max_handoff_s
        placement[f] = best
        objective += best_cost
        node = graph.nodes.get(best)
        if node is not None:
            if undo_log is not None:
                undo_log.append((node, node.mem_used, node.cpu_used,
                                 node.power_used, node.temp_extra))
            node.mem_used += d.mem
            node.cpu_used += d.cpu
            node.power_used += d.power
            if node.kind == SAT:
                node.temp_extra += d.t_exc
    return Plan(placement, objective, considered)


def undo_plan(undo_log: list) -> None:
    """Restore node accounting mutated by ``plan_workflow(...,
    undo_log=log)``: replay in reverse, writing back the exact saved
    values (bit-identical, unlike subtracting demands back out)."""
    for node, mem_used, cpu_used, power_used, temp_extra in \
            reversed(undo_log):
        node.mem_used = mem_used
        node.cpu_used = cpu_used
        node.power_used = power_used
        node.temp_extra = temp_extra


# ---------------------------------------------------------------------------
# TPU bridge: Eq. 9 over the mesh topology
# ---------------------------------------------------------------------------
ICI_BW = 50e9          # bytes/s per link (v5e)
DCN_BW = 6.25e9        # bytes/s per host pair across pods (assumed 50 Gb/s)
ICI_LAT = 1e-6
DCN_LAT = 10e-6


def mesh_topology(mesh) -> TopologyGraph:
    """ICI graph of the production mesh: chips are nodes, torus neighbors
    are links; the pod axis crosses DCN."""
    from repro_torch.core.topology import Node
    g = TopologyGraph()
    shape = dict(mesh.shape)
    pods = shape.get("pod", 1)
    rows, cols = shape["data"], shape["model"]
    for p in range(pods):
        for r in range(rows):
            for c in range(cols):
                g.add_node(Node(f"chip{p}_{r}_{c}", "chip"))
    for p in range(pods):
        for r in range(rows):
            for c in range(cols):
                me = f"chip{p}_{r}_{c}"
                g.add_link(me, f"chip{p}_{(r + 1) % rows}_{c}",
                           ICI_LAT, ICI_BW)
                g.add_link(me, f"chip{p}_{r}_{(c + 1) % cols}",
                           ICI_LAT, ICI_BW)
                if pods > 1:
                    g.add_link(me, f"chip{(p + 1) % pods}_{r}_{c}",
                               DCN_LAT, DCN_BW)
    return g


@dataclass
class LayoutCandidate:
    name: str
    overrides: dict                       # logical-axis rule overrides
    est_collective_bytes: Dict[str, float] = field(default_factory=dict)


def score_layout(cand: LayoutCandidate, mesh) -> float:
    """Eq. 9 analogue: sum over state edges of bytes/bw across the axis the
    state moves on.  ``est_collective_bytes`` maps mesh-axis -> bytes moved
    per step on that axis."""
    shape = dict(mesh.shape)
    pods = shape.get("pod", 1)
    total = 0.0
    for axis, nbytes in cand.est_collective_bytes.items():
        if axis == "pod":
            bw, n = DCN_BW, pods
        else:
            bw, n = ICI_BW, shape.get(axis, 1)
        if n <= 1 or nbytes <= 0:
            continue
        # ring cost: (n-1)/n of the bytes traverse each link
        total += (nbytes * (n - 1) / n) / bw
    return total


def plan_mesh_layout(candidates: Sequence[LayoutCandidate], mesh
                     ) -> LayoutCandidate:
    return min(candidates, key=lambda c: score_layout(c, mesh))
