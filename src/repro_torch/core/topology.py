"""Network topology model: G = (N, L) with time-varying availability.

Nodes are edge/cloud/satellite/drone/EO/ground-station; links carry latency
(seconds) and bandwidth (bytes/s).  ``dijkstra`` returns the lowest-latency
path — the primitive underneath Databelt's Compute phase (Algorithm 2).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

CLOUD, EDGE, SAT, DRONE, EO, GROUND = \
    "cloud", "edge", "satellite", "drone", "eo", "ground"


@dataclass
class Node:
    id: str
    kind: str
    cpu: float = 4.0            # cores
    mem: float = 8e9            # bytes
    power_avail: float = 100.0  # watts available for payload
    t_orb: float = 20.0         # baseline temperature (C)
    t_max: float = 85.0         # max operational temperature
    position: Optional[Callable] = None   # t -> (x, y, z) meters ECI
    region: Optional[str] = None          # home region id (multi-region
                                          # continuum); None = unscoped
    # dynamic state
    mem_used: float = 0.0
    cpu_used: float = 0.0
    power_used: float = 0.0
    temp_extra: float = 0.0

    def pos(self, t: float):
        if self.position is None:
            return (0.0, 0.0, 0.0)
        return self.position(t)


@dataclass(slots=True)
class Link:
    """A directed link; ``slots`` because snapshot builds create ~10^2 of
    these per topology quantum (10^5+ over a large run)."""
    src: str
    dst: str
    latency: float              # seconds (one-way)
    bandwidth: float            # bytes/s


class TopologyGraph:
    """Snapshot (or time-parameterized view) of the 3D continuum network.

    Shortest paths are memoized per source node: one transfer-heavy
    simulation step issues hundreds of ``dijkstra`` queries against the
    same snapshot, so the first query from a source runs a full
    single-source pass and later queries reconstruct paths from the cached
    ``(dist, prev)`` trees.  Topology mutations through ``add_node`` /
    ``add_link`` / ``remove_node`` bump a version counter that invalidates
    the cache; code that pokes ``adj`` directly (e.g. graph *builders*
    assembling a fresh snapshot) must finish mutating before querying."""

    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self.adj: Dict[str, Dict[str, Link]] = {}
        self._version = 0
        self._sssp: Dict[str, Tuple[int, Dict[str, float],
                                    Dict[str, str]]] = {}
        # version-guarded derived-result memos (values are pure functions
        # of the topology, so replaying them is exact):
        # (src, dst) -> (version, path, latency); callers must not mutate
        # the shared path list
        self._paths: Dict[Tuple[str, str], Tuple[int, List[str],
                                                 float]] = {}
        # (kind, src) -> (version, nearest id)
        self._nearest: Dict[Tuple[str, str], Tuple[int,
                                                   Optional[str]]] = {}
        # planner vicinity memo: (center, radius, limit) -> (version, ids)
        self._vicinity: Dict[Tuple[str, float, int],
                             Tuple[int, List[str]]] = {}
        # src -> (version, {node: hop count along the SSSP tree})
        self._hops: Dict[str, Tuple[int, Dict[str, int]]] = {}
        # kind -> (version, sorted node ids of that kind)
        self._kind_ids: Dict[str, Tuple[int, List[str]]] = {}
        # (src, dst) -> (version, (latency, bottleneck bw, hops))
        self._pathcost: Dict[Tuple[str, str],
                             Tuple[int, Tuple[float, float, int]]] = {}
        # (src, dst) -> (version, {node on path: (prefix latency,
        #                                         prefix bottleneck bw)})
        self._prefix: Dict[Tuple[str, str],
                           Tuple[int, Dict[str, Tuple[float,
                                                      float]]]] = {}

    def add_node(self, node: Node):
        self.nodes[node.id] = node
        self.adj.setdefault(node.id, {})
        self._version += 1

    def add_link(self, src: str, dst: str, latency: float, bandwidth: float,
                 bidirectional: bool = True):
        self.adj.setdefault(src, {})[dst] = Link(src, dst, latency, bandwidth)
        if bidirectional:
            self.adj.setdefault(dst, {})[src] = Link(dst, src, latency,
                                                     bandwidth)
        self._version += 1

    def remove_node(self, nid: str):
        self.nodes.pop(nid, None)
        self.adj.pop(nid, None)
        for a in self.adj.values():
            a.pop(nid, None)
        self._version += 1

    def neighbors(self, nid: str):
        return self.adj.get(nid, {})

    def latency(self, src: str, dst: str) -> float:
        if src == dst:
            return 0.0
        link = self.adj.get(src, {}).get(dst)
        return link.latency if link else math.inf

    # ------------------------------------------------------------------
    def _sssp_from(self, src: str) -> Tuple[Dict[str, float],
                                            Dict[str, str]]:
        """Full single-source shortest-path pass from ``src``, memoized
        against the current topology version."""
        entry = self._sssp.get(src)
        if entry is not None and entry[0] == self._version:
            return entry[1], entry[2]
        dist = {src: 0.0}
        prev: Dict[str, str] = {}
        pq = [(0.0, src)]
        seen = set()
        while pq:
            d, u = heapq.heappop(pq)
            if u in seen:
                continue
            seen.add(u)
            for v, link in self.adj.get(u, {}).items():
                if v in seen or v not in self.nodes:
                    continue
                nd = d + link.latency
                if nd < dist.get(v, math.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        self._sssp[src] = (self._version, dist, prev)
        return dist, prev

    def sssp(self, src: str) -> Tuple[Dict[str, float], Dict[str, str]]:
        """Cached single-source shortest-path tree from ``src``:
        ``(dist, prev)`` over every reachable node.  The planner's vicinity
        sampling and ``dijkstra`` both resolve from this one pass."""
        return self._sssp_from(src)

    def dijkstra(self, src: str, dst: str) -> Tuple[List[str], float]:
        """Lowest-latency path src -> dst.  Returns (path, total_latency);
        ([], inf) when unreachable.  Served from the per-source cache;
        the reconstructed path is additionally memoized per (src, dst) —
        transfer-heavy steps ask for the same few pairs thousands of
        times.  Treat the returned path as read-only."""
        if src == dst:
            return [src], 0.0
        hit = self._paths.get((src, dst))
        if hit is not None and hit[0] == self._version:
            return hit[1], hit[2]
        dist, prev = self._sssp_from(src)
        if dst not in dist:
            path, lat = [], math.inf
        else:
            path = [dst]
            while path[-1] != src:
                path.append(prev[path[-1]])
            path.reverse()
            lat = dist[dst]
        self._paths[(src, dst)] = (self._version, path, lat)
        return path, lat

    def dijkstra_uncached(self, src: str, dst: str
                          ) -> Tuple[List[str], float]:
        """Reference implementation (early-exit, no memoization) kept for
        cache-consistency tests and the transfer microbenchmark."""
        if src == dst:
            return [src], 0.0
        dist = {src: 0.0}
        prev: Dict[str, str] = {}
        pq = [(0.0, src)]
        seen = set()
        while pq:
            d, u = heapq.heappop(pq)
            if u in seen:
                continue
            if u == dst:
                break
            seen.add(u)
            for v, link in self.adj.get(u, {}).items():
                if v in seen or v not in self.nodes:
                    continue
                nd = d + link.latency
                if nd < dist.get(v, math.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        if dst not in dist:
            return [], math.inf
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        path.reverse()
        return path, dist[dst]

    def ids_of_kind(self, kind: str) -> List[str]:
        """Sorted ids of every node of ``kind``, memoized per version
        (the global tier asks for the cloud list once per storage op).
        Read-only."""
        hit = self._kind_ids.get(kind)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        out = sorted(n.id for n in self.nodes.values() if n.kind == kind)
        self._kind_ids[kind] = (self._version, out)
        return out

    def nearest_of_kind(self, src: str, kind: str) -> Optional[str]:
        """Lowest-latency node of ``kind`` from ``src`` (ties break on node
        id); the lexicographically first node of the kind when ``src`` can
        reach none of them, None when the kind is absent.  With a single
        node of the kind this is a pure lookup (no SSSP pass), so
        single-region topologies stay on the exact pre-multi-region path."""
        hit = self._nearest.get((kind, src))
        if hit is not None and hit[0] == self._version:
            return hit[1]
        cands = self.ids_of_kind(kind)
        if not cands:
            out = None
        elif len(cands) == 1 or src not in self.nodes:
            out = cands[0]
        else:
            dist, _ = self.sssp(src)
            out = min(cands, key=lambda c: (dist.get(c, math.inf), c))
        self._nearest[(kind, src)] = (self._version, out)
        return out

    def path_latency(self, path: List[str]) -> float:
        return sum(self.latency(a, b) for a, b in zip(path, path[1:]))

    def path_cost(self, src: str, dst: str) -> Tuple[float, float, int]:
        """(dijkstra latency, bottleneck bandwidth, hop count) of the
        cached lowest-latency path, memoized per (src, dst): the transfer
        model asks for the same pair once per storage op, and the min
        over link bandwidths is a pure function of the path.  Returns
        ``(inf, 0.0, 10**9)`` when unreachable."""
        if src == dst:
            return 0.0, math.inf, 0
        hit = self._pathcost.get((src, dst))
        if hit is not None and hit[0] == self._version:
            return hit[1]
        path, lat = self.dijkstra(src, dst)
        if not path:
            out = (math.inf, 0.0, 10**9)
        else:
            bw = min((self.adj[a][b].bandwidth
                      for a, b in zip(path, path[1:])), default=0.0)
            out = (lat, bw, len(path) - 1)
        self._pathcost[(src, dst)] = (self._version, out)
        return out

    def path_prefix_costs(self, src: str, dst: str
                          ) -> Dict[str, Tuple[float, float]]:
        """For each node ``b`` on the cached lowest-latency src->dst path
        (excluding ``src``): ``(latency of the path prefix up to b,
        bottleneck bandwidth of that prefix)`` — accumulated left to
        right exactly like a per-candidate prefix walk, so the values
        are bit-identical to re-walking the path per candidate.  Empty
        when unreachable.  Memoized per (src, dst); read-only."""
        hit = self._prefix.get((src, dst))
        if hit is not None and hit[0] == self._version:
            return hit[1]
        path, _ = self.dijkstra(src, dst)
        out: Dict[str, Tuple[float, float]] = {}
        lat_acc, bw = 0.0, math.inf
        for a, b in zip(path, path[1:]):
            link = self.adj.get(a, {}).get(b)
            lat_acc = lat_acc + (link.latency if link else math.inf)
            bw = min(bw, link.bandwidth if link else 0.0)
            out[b] = (lat_acc, bw)
        self._prefix[(src, dst)] = (self._version, out)
        return out

    def hops(self, src: str, dst: str) -> int:
        path, lat = self.dijkstra(src, dst)
        return max(len(path) - 1, 0) if math.isfinite(lat) else 10**9

    def hops_map(self, src: str) -> Dict[str, int]:
        """Hop counts from ``src`` to every reachable node, resolved from
        the same cached SSSP tree ``hops`` walks — so for any reachable
        ``dst``, ``hops_map(src)[dst] == hops(src, dst)`` exactly.
        Unreachable nodes are absent (``hops`` answers 10**9 for those).
        The planner's scoring loop uses this to avoid a path
        reconstruction per (source, candidate) pair.  Read-only."""
        hit = self._hops.get(src)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        dist, prev = self._sssp_from(src)
        hm: Dict[str, int] = {src: 0}
        for n in dist:
            chain = []
            cur = n
            while cur not in hm:
                chain.append(cur)
                cur = prev[cur]
            base = hm[cur]
            for k in range(len(chain) - 1, -1, -1):
                hm[chain[k]] = base + len(chain) - k
        self._hops[src] = (self._version, hm)
        return hm

    def copy_shallow(self) -> "TopologyGraph":
        g = TopologyGraph()
        g.nodes = dict(self.nodes)
        g.adj = {k: dict(v) for k, v in self.adj.items()}
        # share the SSSP cache (same topology); the copy's own dict + the
        # version counter keep later mutations from cross-contaminating
        g._version = self._version
        g._sssp = dict(self._sssp)
        g._paths = dict(self._paths)
        g._nearest = dict(self._nearest)
        g._vicinity = dict(self._vicinity)
        g._hops = dict(self._hops)
        g._kind_ids = dict(self._kind_ids)
        g._pathcost = dict(self._pathcost)
        g._prefix = dict(self._prefix)
        return g
