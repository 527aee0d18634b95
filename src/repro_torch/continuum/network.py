"""Time-varying 3D-continuum network built from the orbital model.

Bandwidths follow the paper (§2.1): ISL ~100 Gb/s; satellite-ground
~300 Mb/s; terrestrial edge-cloud ~1 Gb/s.  ``graph_at(t)`` produces the
TopologyGraph snapshot the Databelt Identify phase consumes; ``available``
implements R-5 (a satellite is available when it can reach the required
node types).

Multi-region (``repro_torch.continuum.regions``): sites may carry a ``region``
id.  Region-tagged edge/drone/ground sites get metro-latency links only to
their *own* region's cloud, and the clouds interconnect over a terrestrial
WAN backbone with great-circle latencies — untagged sites keep the legacy
all-clouds wiring, so single-region topologies are byte-identical to the
pre-region builder.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.continuum.orbits import (Constellation, GroundSite,
                                    line_of_sight_batch,
                                    propagation_latency_batch,
                                    visible_from_ground_batch)
from repro_torch.core.topology import (CLOUD, DRONE, EDGE, EO, GROUND, SAT, Link,
                                 Node, TopologyGraph)

ISL_BW = 100e9 / 8          # bytes/s (100 Gb/s)
GROUND_BW = 300e6 / 8       # bytes/s (300 Mb/s)
TERRA_BW = 1e9 / 8          # bytes/s
EO_BW = 100e9 / 8
METRO_LATENCY = 0.020       # seconds — site <-> its region's cloud


@dataclass
class SiteSpec:
    id: str
    kind: str
    site: GroundSite
    cpu: float = 4.0
    mem: float = 8e9
    region: Optional[str] = None   # region id (multi-region continuum)


class ContinuumNetwork:
    """Cloud + edge + drones + EO + one or more Walker LEO shells.

    ``constellation`` may be a single ``Constellation`` or a
    ``repro_torch.continuum.regions.MultiConstellation`` — only the
    ``sat_id``/``position``/``isl_neighbors`` interface is consumed.

    ``require_kinds`` (optional) tightens R-5 availability: a satellite
    then counts as available only when its snapshot component actually
    reaches a node of one of the given kinds (see ``available``)."""

    def __init__(self, constellation: Optional[Constellation] = None,
                 sites: Optional[List[SiteSpec]] = None,
                 sat_cpu: float = 4.0, sat_mem: float = 8e9,
                 cache_quantum: float = 1.0,
                 require_kinds: Optional[Tuple[str, ...]] = None):
        self.constellation = constellation or Constellation()
        if sites is None:
            sites = default_sites()
        self.sites = sites
        self.sat_cpu, self.sat_mem = sat_cpu, sat_mem
        self.cache_quantum = cache_quantum
        self.require_kinds = require_kinds
        self._cache: Dict[float, TopologyGraph] = {}
        self._reach_cache: Dict[float, Set[str]] = {}
        # last-answer memo: consecutive graph_at calls overwhelmingly ask
        # for the exact same t (every storage op in an event re-resolves
        # the snapshot), so short-circuit before the quantum arithmetic
        self._last_t: Optional[float] = None
        self._last_g: Optional[TopologyGraph] = None
        # fault overrides (repro_torch.sim.faults): drained nodes / lost links
        # are filtered out of every snapshot until restored
        self._down_nodes: Set[str] = set()
        self._down_links: Set[Tuple[str, str]] = set()
        # race sanitizer (repro_torch.sim.races): a race-detected run attaches
        # its kernel here so topology mutations/reads are HB-checked —
        # None keeps every hook at a single attribute test
        self._race_kernel = None
        # persistent node objects so resource accounting survives snapshots
        self._nodes: Dict[str, Node] = {}
        self._make_nodes()
        # static ISL pair list (src, dst index arrays) in the exact order
        # the scalar builder visited them — link insertion order shapes
        # adjacency iteration order, which downstream tie-breaks see
        c = self.constellation
        pairs = [(i, j) for i in range(len(c)) for j in c.isl_neighbors(i)]
        self._isl_src = np.array([p[0] for p in pairs], dtype=np.intp)
        self._isl_dst = np.array([p[1] for p in pairs], dtype=np.intp)
        # node kinds are static across snapshots, so every fault-free
        # snapshot can be born with its ids_of_kind memo pre-warmed
        # (identical to what the lazy path would compute: sorted ids)
        kinds: Dict[str, List[str]] = {}
        for nid, n in self._nodes.items():
            kinds.setdefault(n.kind, []).append(nid)
        self._kind_ids_tmpl = {k: (1, sorted(v)) for k, v in kinds.items()}

    def _make_nodes(self):
        c = self.constellation
        for i in range(len(c)):
            nid = c.sat_id(i)
            self._nodes[nid] = Node(
                nid, SAT, cpu=self.sat_cpu, mem=self.sat_mem,
                t_orb=30.0, t_max=85.0,
                position=(lambda t, _i=i: c.position(_i, t)))
        for s in self.sites:
            self._nodes[s.id] = Node(
                s.id, s.kind, cpu=s.cpu, mem=s.mem,
                position=(lambda t, _s=s.site: _s.position(t)),
                region=s.region)

    @property
    def node_ids(self) -> List[str]:
        return sorted(self._nodes)

    # ------------------------------------------------------------------
    # fault overrides (driven by repro_torch.sim.faults.FaultInjector)
    # ------------------------------------------------------------------
    def set_node_down(self, nid: str, down: bool = True) -> None:
        """Drain/restore ``nid``: while down the node (and every link that
        touches it) vanishes from all snapshots, so placement, transfers
        and global-tier home hashing route around it.  Snapshot caches are
        invalidated on every change; with no overrides active the builder
        path is byte-identical to the fault-free network."""
        before = nid in self._down_nodes
        if down:
            self._down_nodes.add(nid)
        else:
            self._down_nodes.discard(nid)
        if before != down:
            if self._race_kernel is not None:
                self._race_kernel.note_access(self, "topology", "w")
            self._invalidate()

    def set_link_down(self, a: str, b: str, down: bool = True) -> None:
        """Lose/restore the (bidirectional) link between ``a`` and ``b``
        in every snapshot until restored."""
        pair = (a, b) if a <= b else (b, a)
        before = pair in self._down_links
        if down:
            self._down_links.add(pair)
        else:
            self._down_links.discard(pair)
        if before != down:
            if self._race_kernel is not None:
                self._race_kernel.note_access(self, "topology", "w")
            self._invalidate()

    def _invalidate(self) -> None:
        self._cache.clear()
        self._reach_cache.clear()
        self._last_t = self._last_g = None

    def _link_up(self, a: str, b: str) -> bool:
        if a in self._down_nodes or b in self._down_nodes:
            return False
        return ((a, b) if a <= b else (b, a)) not in self._down_links

    # ------------------------------------------------------------------
    def graph_at(self, t: float) -> TopologyGraph:
        if self._race_kernel is not None:
            self._race_kernel.note_access(self, "topology", "r")
        if t == self._last_t:
            return self._last_g
        key = round(t / self.cache_quantum) * self.cache_quantum
        g = self._cache.get(key)
        if g is not None:
            self._last_t, self._last_g = t, g
            return g
        # The builder fills ``g.nodes``/``g.adj`` directly (same insertion
        # order as the add_node/add_link calls it replaces — adjacency
        # iteration order shapes downstream tie-breaks) and stamps the
        # version once at the end: snapshots are born with empty caches,
        # so per-mutation version bumps only cost time.
        g = TopologyGraph()
        nodes, adj = g.nodes, g.adj
        for n in self._nodes.values():
            if n.id not in self._down_nodes:
                nodes[n.id] = n
                adj[n.id] = {}
        if not self._down_nodes:
            g._kind_ids.update(self._kind_ids_tmpl)
        c = self.constellation
        nsat = len(c)
        sat_ids = [c.sat_id(i) for i in range(nsat)]
        # positions stay SCALAR math trig (libm sin/cos are not correctly
        # rounded — a numpy version would change values); only the
        # pairwise visibility/latency tests below are batched, with
        # arithmetic that reproduces the scalar predicates bit-exactly
        pos = {sat_ids[i]: c.position(i, key) for i in range(nsat)}
        for s in self.sites:
            pos[s.id] = s.site.position(key)
        sat_pos = (np.array([pos[sid] for sid in sat_ids])
                   if nsat else np.empty((0, 3)))
        # ISLs — one batched line-of-sight + latency pass over the static
        # pair list, visited in the scalar builder's exact order
        if nsat:
            a, b = sat_pos[self._isl_src], sat_pos[self._isl_dst]
            los = line_of_sight_batch(a, b)
            lat = propagation_latency_batch(a, b).tolist()
            isl_src, isl_dst = self._isl_src, self._isl_dst
            for k in np.nonzero(los)[0].tolist():
                me = sat_ids[isl_src[k]]
                other = sat_ids[isl_dst[k]]
                if self._link_up(me, other):
                    adj[me][other] = Link(me, other, lat[k], ISL_BW)
        # ground <-> satellite: the CLOUD has no direct satellite link —
        # it reaches orbit via ground stations + terrestrial backbone,
        # which is what makes cloud state multi-hop from a satellite
        for s in self.sites:
            if s.kind in (EO, CLOUD) or not nsat:
                continue
            vis = visible_from_ground_batch(pos[s.id], sat_pos)
            lat = propagation_latency_batch(np.array([pos[s.id]]),
                                            sat_pos).tolist()
            sid_ = s.id
            for k in np.nonzero(vis)[0].tolist():
                sat = sat_ids[k]
                if self._link_up(sid_, sat):
                    adj[sid_][sat] = Link(sid_, sat, lat[k], GROUND_BW)
                    adj[sat][sid_] = Link(sat, sid_, lat[k], GROUND_BW)
        # EO satellite(s): ISL-class links to visible LEO sats
        for s in self.sites:
            if s.kind != EO or not nsat:
                continue
            site_arr = np.array([pos[s.id]])      # broadcasts over sats
            los = line_of_sight_batch(site_arr, sat_pos)
            lat = propagation_latency_batch(site_arr, sat_pos).tolist()
            sid_ = s.id
            for k in np.nonzero(los)[0].tolist():
                sat = sat_ids[k]
                if self._link_up(sid_, sat):
                    adj[sid_][sat] = Link(sid_, sat, lat[k], EO_BW)
                    adj[sat][sid_] = Link(sat, sid_, lat[k], EO_BW)
        # terrestrial backbone: edges/drones/ground <-> their cloud.
        # Region-tagged sites connect only to their own region's cloud at
        # metro latency; untagged sites keep the legacy all-clouds wiring.
        clouds = [s for s in self.sites if s.kind == CLOUD]
        for s in self.sites:
            if s.kind in (EDGE, DRONE, GROUND):
                for cl in clouds:
                    if (s.region is None or cl.region is None
                            or s.region == cl.region) \
                            and self._link_up(s.id, cl.id):
                        adj[s.id][cl.id] = Link(s.id, cl.id, METRO_LATENCY,
                                                TERRA_BW)
                        adj[cl.id][s.id] = Link(cl.id, s.id, METRO_LATENCY,
                                                TERRA_BW)
        # inter-region WAN backbone: clouds pairwise over stretched
        # great-circle fiber (repro_torch.continuum.regions.wan_latency)
        if len(clouds) > 1:
            from repro_torch.continuum.regions import WAN_BW, wan_latency
            for i, a in enumerate(clouds):
                for b in clouds[i + 1:]:
                    if self._link_up(a.id, b.id):
                        wl = wan_latency(a.site, b.site)
                        adj[a.id][b.id] = Link(a.id, b.id, wl, WAN_BW)
                        adj[b.id][a.id] = Link(b.id, a.id, wl, WAN_BW)
        g._version = 1
        if len(self._cache) > 256:
            self._cache.clear()
        self._cache[key] = g
        self._last_t, self._last_g = t, g
        return g

    # ------------------------------------------------------------------
    def available(self, nid: str, t: float) -> bool:
        """R-5 availability: ground/cloud/edge nodes always; satellites
        when connected in the snapshot graph.

        By default "connected" is any-neighbor degree > 0 — a satellite
        with only ISL links still counts, even when its component never
        touches the ground segment.  Constructing the network with
        ``require_kinds=(CLOUD, EDGE, GROUND)`` (or any kind tuple)
        tightens this to the paper's stronger reading: the satellite must
        *reach* a node of a required kind through the snapshot, computed
        by one multi-source BFS per snapshot and cached alongside it."""
        node = self._nodes.get(nid)
        if node is None or nid in self._down_nodes:
            return False
        if node.kind != SAT:
            return True
        g = self.graph_at(t)
        if self.require_kinds is None:
            return bool(g.adj.get(nid))
        return nid in self._reachable(t)

    def _reachable(self, t: float) -> Set[str]:
        """Nodes with a snapshot path to at least one ``require_kinds``
        node: multi-source BFS from every required-kind node, memoized per
        snapshot quantum (same keying as the graph cache)."""
        key = round(t / self.cache_quantum) * self.cache_quantum
        hit = self._reach_cache.get(key)
        if hit is not None:
            return hit
        g = self.graph_at(t)
        frontier = [n.id for n in g.nodes.values()
                    if n.kind in self.require_kinds]
        seen = set(frontier)
        while frontier:
            nxt = []
            for u in frontier:
                for v in g.neighbors(u):
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        if len(self._reach_cache) > 256:
            self._reach_cache.clear()
        self._reach_cache[key] = seen
        return seen


def default_sites() -> List[SiteSpec]:
    """Paper-scenario sites: one cloud DC, one edge node, a drone zone over
    the flood area, one EO satellite (modeled as high-altitude site... the
    EO sat gets a real orbit below) and a ground station."""
    from repro_torch.continuum.orbits import OrbitalElement
    import math as m
    sites = [
        SiteSpec("cloud0", CLOUD, GroundSite(m.radians(48.2),
                                             m.radians(16.4)),
                 cpu=64.0, mem=256e9),
        SiteSpec("edge0", EDGE, GroundSite(m.radians(47.8), m.radians(16.2)),
                 cpu=4.0, mem=2e9),
        SiteSpec("drone0", DRONE, GroundSite(m.radians(47.5),
                                             m.radians(16.0), 500.0),
                 cpu=2.0, mem=1e9),
        SiteSpec("ground0", GROUND, GroundSite(m.radians(48.0),
                                               m.radians(16.5)),
                 cpu=8.0, mem=16e9),
    ]
    # EO satellite on a sun-synchronous-ish higher orbit
    eo_orbit = OrbitalElement(785_000.0, m.radians(98.0), 0.3, 0.1)
    eo = SiteSpec("eo0", EO, GroundSite(0, 0), cpu=2.0, mem=4e9)
    eo.site = _OrbitSite(eo_orbit)
    sites.append(eo)
    return sites


class _OrbitSite:
    """Adapter giving an orbiting node the GroundSite.position interface."""

    def __init__(self, element):
        self.element = element

    def position(self, t: float):
        return self.element.position(t)
