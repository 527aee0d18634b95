"""Multi-region continuum: multiple Walker shells + sharded global tier.

The paper's evaluation runs one Vienna cloud (``cloud0``) under a single
Walker shell, so every global-tier write and fallback read funnels into one
KVS queue.  This module grows the simulator to the deployment HyperDrive
and Cosmos model — several shells at different altitudes/inclinations and
N ground regions joined by a terrestrial WAN backbone:

* ``MultiConstellation`` — composes several ``ShellSpec`` Walker shells
  behind the existing ``Constellation`` interface (``sat_id`` /
  ``position`` / ``isl_neighbors``), adding inter-shell ISLs between
  proportionally-mapped satellites of adjacent shells, so
  ``ContinuumNetwork`` consumes it unchanged.
* ``RegionSpec`` / ``region_sites`` — declarative cloud regions; each
  region expands to a cloud DC plus its edge/ground/drone sites, all
  tagged with the region id.  ``ContinuumNetwork`` keeps region-local
  terrestrial links at metro latency and joins the clouds with
  great-circle WAN links (``wan_latency``).
* ``GlobalTier`` — the region-sharded global KVS replacing the single
  ``global_store`` dict: every state key has a *home* region chosen by
  rendezvous (HRW) hashing on the encoded key, writers replicate
  asynchronously to their *nearest* region, and reads probe home first
  then fall back cross-region — so stateless baselines contend on
  per-region queues instead of one planetary queue.
* ``multiregion_network`` — one-call builder for benchmarks and tests.

Hashing is ``hashlib``-based (never the salted builtin ``hash``) so shard
assignment is bit-identical across processes — a hard requirement for the
deterministic-replay guarantees of ``repro_torch.sim``.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.continuum.orbits import (C_LIGHT, Constellation, GroundSite,
                                    OrbitalElement, R_EARTH)

# -- WAN backbone ----------------------------------------------------------
WAN_BW = 10e9 / 8          # bytes/s — inter-region backbone (10 Gb/s)
WAN_ROUTE_STRETCH = 2.0    # fiber paths are not great circles
FIBER_LIGHT_FRACTION = 0.66
WAN_OVERHEAD_S = 0.004     # per-path router/queueing floor


def great_circle_m(a: GroundSite, b: GroundSite) -> float:
    """Haversine distance between two fixed sites (meters)."""
    dlat = b.lat - a.lat
    dlon = b.lon - a.lon
    h = math.sin(dlat / 2) ** 2 + \
        math.cos(a.lat) * math.cos(b.lat) * math.sin(dlon / 2) ** 2
    return 2 * R_EARTH * math.asin(min(1.0, math.sqrt(h)))


def wan_latency(a: GroundSite, b: GroundSite) -> float:
    """One-way inter-region latency over the terrestrial backbone:
    stretched great-circle fiber at 0.66c plus a routing floor — Vienna to
    Singapore lands near the ~100 ms operators report."""
    d = great_circle_m(a, b)
    return WAN_OVERHEAD_S + d * WAN_ROUTE_STRETCH / \
        (C_LIGHT * FIBER_LIGHT_FRACTION)


# -- multi-shell constellation ---------------------------------------------
@dataclass(frozen=True)
class ShellSpec:
    """One Walker-delta shell of a layered constellation."""
    n_planes: int = 6
    sats_per_plane: int = 8
    altitude: float = 550_000.0
    inclination_deg: float = 53.0
    phasing: float = 0.5


DEFAULT_SHELLS = (
    ShellSpec(6, 8, 550_000.0, 53.0),      # Starlink-class low shell
    ShellSpec(5, 6, 1_200_000.0, 87.9),    # OneWeb-class polar shell
)


class MultiConstellation:
    """Several Walker shells behind the single-shell interface.

    Satellites are numbered globally (``sat0`` .. ``satN-1``) across the
    shells in spec order, so ``ContinuumNetwork`` consumes this exactly
    like a ``Constellation``.  ``isl_neighbors`` keeps each shell's grid+
    topology and adds inter-shell ISLs: each satellite pairs with the
    proportionally-mapped slot of the adjacent shell(s), symmetrized so
    every cross-shell link exists in both directions (the network builder
    adds ISL links per-direction)."""

    def __init__(self, shells: Sequence[ShellSpec] = DEFAULT_SHELLS):
        if not shells:
            raise ValueError("MultiConstellation needs at least one shell")
        self.shell_specs = tuple(shells)
        self.shells: List[Constellation] = [
            Constellation(s.n_planes, s.sats_per_plane, s.altitude,
                          s.inclination_deg, s.phasing) for s in shells]
        self._offsets: List[int] = []
        off = 0
        for c in self.shells:
            self._offsets.append(off)
            off += len(c)
        self._total = off
        self._cross: Dict[int, Set[int]] = {}
        for k in range(len(self.shells) - 1):
            a, b = len(self.shells[k]), len(self.shells[k + 1])
            oa, ob = self._offsets[k], self._offsets[k + 1]
            for j in range(a):
                self._link(oa + j, ob + j * b // a)
            for j in range(b):
                self._link(oa + j * a // b, ob + j)

    def _link(self, i: int, j: int) -> None:
        self._cross.setdefault(i, set()).add(j)
        self._cross.setdefault(j, set()).add(i)

    def __len__(self) -> int:
        return self._total

    def shell_of(self, idx: int) -> int:
        for k in range(len(self.shells) - 1, -1, -1):
            if idx >= self._offsets[k]:
                return k
        raise IndexError(idx)

    def sat_id(self, idx: int) -> str:
        return f"sat{idx}"

    def position(self, idx: int, t: float):
        k = self.shell_of(idx)
        return self.shells[k].position(idx - self._offsets[k], t)

    def isl_neighbors(self, idx: int) -> List[int]:
        k = self.shell_of(idx)
        off = self._offsets[k]
        in_shell = [off + n
                    for n in self.shells[k].isl_neighbors(idx - off)]
        return in_shell + sorted(self._cross.get(idx, ()))


# -- region specs ----------------------------------------------------------
@dataclass(frozen=True)
class RegionSpec:
    """Declarative cloud region: a cloud DC plus its local sites."""
    name: str
    lat_deg: float
    lon_deg: float
    n_edge: int = 1
    n_ground: int = 1
    n_drone: int = 1
    cloud_cpu: float = 64.0
    cloud_mem: float = 256e9


DEFAULT_REGIONS = (
    RegionSpec("eu-central", 48.2, 16.4),     # Vienna (the paper scenario)
    RegionSpec("us-east", 39.0, -77.5),       # Ashburn
    RegionSpec("ap-southeast", 1.35, 103.8),  # Singapore
    RegionSpec("sa-east", -23.5, -46.6),      # Sao Paulo
)


def make_regions(n: int) -> Tuple[RegionSpec, ...]:
    """First ``n`` of the default catalog; wraps with longitude offsets
    past four so arbitrary sweep sizes stay well-defined."""
    out = []
    for i in range(n):
        base = DEFAULT_REGIONS[i % len(DEFAULT_REGIONS)]
        if i < len(DEFAULT_REGIONS):
            out.append(base)
        else:
            out.append(RegionSpec(f"{base.name}-{i}", base.lat_deg,
                                  base.lon_deg + 7.0 * (i // 4),
                                  base.n_edge, base.n_ground, base.n_drone,
                                  base.cloud_cpu, base.cloud_mem))
    return tuple(out)


def region_sites(regions: Sequence[RegionSpec],
                 with_eo: bool = True) -> List["SiteSpec"]:
    """Expand ``RegionSpec``s into the flat ``SiteSpec`` list
    ``ContinuumNetwork`` consumes.  Site ids are numbered globally
    (``cloud0``/``edge0``/``drone0``/... for region 0) so the
    single-region output stays name-compatible with ``default_sites``;
    every site carries its region id for the region-scoped backbone."""
    from repro_torch.continuum.network import SiteSpec, _OrbitSite
    from repro_torch.core.topology import CLOUD, DRONE, EDGE, EO, GROUND
    sites: List[SiteSpec] = []
    ne = ng = nd = 0
    for i, r in enumerate(regions):
        lat, lon = math.radians(r.lat_deg), math.radians(r.lon_deg)
        rid = r.name
        sites.append(SiteSpec(f"cloud{i}", CLOUD, GroundSite(lat, lon),
                              cpu=r.cloud_cpu, mem=r.cloud_mem, region=rid))
        for j in range(r.n_edge):
            sites.append(SiteSpec(
                f"edge{ne}", EDGE,
                GroundSite(lat - math.radians(0.4),
                           lon - math.radians(0.2 + 0.3 * j)),
                cpu=4.0, mem=2e9, region=rid))
            ne += 1
        for j in range(r.n_drone):
            sites.append(SiteSpec(
                f"drone{nd}", DRONE,
                GroundSite(lat - math.radians(0.7),
                           lon - math.radians(0.4 + 0.3 * j), 500.0),
                cpu=2.0, mem=1e9, region=rid))
            nd += 1
        for j in range(r.n_ground):
            sites.append(SiteSpec(
                f"ground{ng}", GROUND,
                GroundSite(lat - math.radians(0.2),
                           lon + math.radians(0.1 + 0.3 * j)),
                cpu=8.0, mem=16e9, region=rid))
            ng += 1
    if with_eo:
        eo = SiteSpec("eo0", EO, GroundSite(0, 0), cpu=2.0, mem=4e9)
        eo.site = _OrbitSite(OrbitalElement(785_000.0, math.radians(98.0),
                                            0.3, 0.1))
        sites.append(eo)
    return sites


def multiregion_network(n_regions: int = 2,
                        shells: Optional[Sequence[ShellSpec]] = None,
                        **net_kwargs):
    """Convenience builder: layered constellation + N-region ground
    segment, wired into a ``ContinuumNetwork``."""
    from repro_torch.continuum.network import ContinuumNetwork
    const = MultiConstellation(shells or DEFAULT_SHELLS)
    return ContinuumNetwork(const, sites=region_sites(make_regions(
        n_regions)), **net_kwargs)


# -- region-sharded global tier --------------------------------------------
class GlobalTier:
    """Region-sharded global KVS (one shard per cloud region).

    Shards are keyed by the region's *cloud node id* — the node whose KVS
    queue services that shard's traffic.  ``home`` assigns each encoded
    state key a home shard by rendezvous (highest-random-weight) hashing:
    adding or removing a region only remaps the keys that move to/from it,
    never shuffling the survivors.  Writers fan out to the shard nearest
    to them (the cheap WAN leg) *and* the key's home shard
    (``put_replicas``, k=2); readers probe the home shard first and fall
    back cross-region to any shard holding the key, and a fallback-served
    read may ``heal`` the home shard (read-repair) so later reads stop
    re-paying the WAN.  With a single region every key's home is that
    region and the tier degrades to the old one-dict global store."""

    #: shard id used when the topology has no cloud node at all — state is
    #: still retained so the fallback path can serve it from the holder.
    UNSHARDED = ""

    def __init__(self):
        self.shards: Dict[str, Dict[str, object]] = {}
        # (enc, regions) -> home shard: rendezvous hashing is pure, and
        # rewrites of the same key re-derive the same home every put
        self._home_cache: Dict[Tuple[str, Tuple[str, ...]], str] = {}

    @staticmethod
    def _weight(region: str, enc: str) -> int:
        # hashlib, not hash(): builtin str hashing is salted per process
        # and would break cross-run deterministic replay
        return int.from_bytes(
            hashlib.blake2b(f"{region}|{enc}".encode(),
                            digest_size=8).digest(), "big")

    def home(self, enc: str, regions: Sequence[str]) -> str:
        if not regions:
            return self.UNSHARDED
        if len(regions) == 1:
            return regions[0]          # max over one candidate: no hash
        key = (enc, tuple(regions))
        hit = self._home_cache.get(key)
        if hit is None:
            hit = max(sorted(regions), key=lambda r: self._weight(r, enc))
            if len(self._home_cache) > (1 << 20):
                self._home_cache.clear()   # bound memory at fleet scale
            self._home_cache[key] = hit
        return hit

    def put(self, enc: str, state, region: Optional[str]) -> None:
        """Record ``enc`` in ``region``'s shard (single-replica compat
        wrapper over ``put_replicas``)."""
        self.put_replicas(enc, state, [region] if region else None)

    def put_replicas(self, enc: str, state,
                     regions: Optional[Sequence[str]]) -> None:
        """Record ``enc`` in every shard of ``regions`` (the k-replica
        fan-out set), last-write-wins across the tier: a rewrite whose
        replica set no longer covers a shard (the writer moved regions)
        evicts the stale copy there, so home-first reads can never
        resurrect an overwritten value."""
        targets = list(regions) if regions else [self.UNSHARDED]
        for r, shard in self.shards.items():
            if r not in targets:
                shard.pop(enc, None)
        for target in targets:
            self.shards.setdefault(target, {})[enc] = state

    def heal(self, enc: str, region: str, state) -> None:
        """Read-repair: re-populate ``region``'s shard (the key's home)
        with the value a fallback replica just served, so the next
        home-first probe hits instead of re-paying the cross-region WAN."""
        self.shards.setdefault(region, {})[enc] = state

    def has(self, enc: str, region: str) -> bool:
        return enc in self.shards.get(region, {})

    def get(self, enc: str, region: str):
        return self.shards.get(region, {}).get(enc)

    def locate(self, enc: str) -> List[str]:
        """Regions holding ``enc``, in deterministic (sorted) order."""
        return sorted(r for r, shard in self.shards.items() if enc in shard)

    def get_any(self, enc: str):
        """Cross-region lookup without a preferred shard (legacy path and
        topologies with no cloud)."""
        for r in self.locate(enc):
            return self.shards[r][enc]
        return None

    def __contains__(self, enc: str) -> bool:
        return any(enc in shard for shard in self.shards.values())

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards.values())
