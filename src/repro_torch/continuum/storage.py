"""Two-tier storage (paper §3.2): per-node local KVS + sharded global KVS.

Reads resolve through the Databelt State Key: local hit (same node) costs
only the KVS op; otherwise the value streams over the lowest-latency path.
The global tier provides redundancy — every write also (asynchronously)
lands in the global KVS with **k=2 fan-out** (the writer-nearest region's
shard plus the key's *home* shard), so a vanished local copy falls back
there, and a home-shard miss that is served cross-region *read-repairs*
the home shard instead of re-paying the WAN on every subsequent read.

The global tier is **region-sharded** (``repro_torch.continuum.regions.
GlobalTier``): each encoded key has a *home* region chosen by rendezvous
hashing over the cloud nodes, and reads probe the home shard first before
falling back cross-region.  With a single cloud every key's home is that
cloud and the data path is identical to the original single-``cloud0``
design — the per-region shards only start spreading load when the
topology actually has several regions.

Queueing happens on first-class simulation resources: each node's KVS is a
capacity-1 ``SlotResource`` FIFO owned by a ``ResourcePool`` (shared with
the workflow engine's CPU slots), so Databelt / random / stateless contend
on the same queues under parallel load.

Every operation runs through **one internal path** (``_op_put`` /
``_op_get`` / ``_op_get_fused``): a generator parameterized by an *op
clock* that decides how timed legs are paid:

* ``_AnalyticClock`` — committed-schedule accounting: KVS legs call
  ``SlotResource.request`` (start slot fixed at enqueue), latency sums
  into a virtual elapsed, nothing is yielded.  Drives the synchronous
  ``put``/``get``/``get_fused`` entry points and ``StateSession``'s
  ``analytic`` mode.
* ``_EventClock`` — parked-waiter queueing: KVS legs ``acquire``/
  ``release`` the queue like CPU slots and sleeps are real kernel yields,
  so an autoscale capacity grow re-admits the *already-queued* backlog.
  Drives ``StateSession``'s default ``event`` mode.

The engine-facing surface is ``repro_torch.continuum.session.StateSession``;
the synchronous ``put``/``get``/``get_fused`` trio stays supported for
direct storage use.  (The legacy ``put_ev``/``get_ev``/``get_fused_ev``
generator shims completed their deprecation cycle and are gone.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.continuum.regions import GlobalTier
from repro_torch.core.keys import StateKey
from repro_torch.core.topology import CLOUD, TopologyGraph
from repro_torch.sim.resources import ResourcePool

KVS_OP_LATENCY = 0.0008     # per-request local KVS overhead (seconds)
KVS_READ_BW = 40e6          # bytes/s — Pi-class KVS read + deserialization
KVS_WRITE_BW = 30e6         # bytes/s — Pi-class KVS write + serialization

# Worst-case detour charged when the global tier must serve a reader that
# is totally partitioned from every replica: the read completes (the system
# keeps running) at the cost of a store-and-forward relay epoch.
PARTITION_DETOUR_LATENCY_S = 1.0
PARTITION_DETOUR_HOPS = 8


@dataclass(slots=True)
class StoredState:
    key: StateKey
    size: float
    payload: object = None


@dataclass(slots=True)
class AccessResult:
    latency: float              # total (KVS + serialization + network)
    hops: int
    local: bool
    from_global: bool = False
    global_keys: int = 0        # keys served via the global tier (a
                                # fused read resolves several at once)
    network_latency: float = 0.0  # path latency + wire transfer only
    # flight-recorder attribution (filled by the op path; zero-cost —
    # plain dataclass fields, no allocation beyond the result itself):
    tier: str = ""              # which tier served the op: "local" /
                                # "holder" / "global-home" /
                                # "global-fallback" / "fused" / writes
                                # "write-local" / "write-remote"
    node: str = ""              # the node whose KVS served the op
    queue_wait_s: float = 0.0   # time spent waiting on KVS queues
    service_s: float = 0.0      # KVS service time actually consumed


# ---------------------------------------------------------------------------
# op clocks: how one storage operation pays for its timed legs
# ---------------------------------------------------------------------------
class _AnalyticClock:
    """Committed-schedule accounting (no simulated sleeping).

    KVS legs enqueue via ``SlotResource.request`` — the start slot is
    committed immediately — and all waits/latencies sum into a virtual
    ``elapsed`` that becomes the op's reported latency.  Fused-read legs
    are issued *in parallel* at the op's start time (the grouped prefetch
    fans out one request per source node simultaneously).  The async
    global-replication leg becomes a deferred kernel event when a kernel
    is attached, else inline queue accounting (sequential mode)."""

    def __init__(self, storage: "TwoTierStorage", t: float, kernel=None):
        self.storage = storage
        self.t0 = t
        self.elapsed = 0.0
        self.kernel = kernel if kernel is not None else storage.scheduler
        # queue-wait vs service attribution for the flight recorder
        self.queue_wait = 0.0
        self.service = 0.0

    @property
    def now(self) -> float:
        return self.t0 + self.elapsed

    def total(self) -> float:
        return self.elapsed

    def sleep(self, dt: float):
        self.elapsed += dt
        return
        yield  # noqa: unreachable — makes this a generator

    def kvs_leg(self, node: str, service_s: float):
        wait = self.storage.resources.kvs(node).request(self.now, service_s)
        self.elapsed += wait + service_s
        self.queue_wait += wait
        self.service += service_s
        return
        yield  # noqa: unreachable — makes this a generator

    def fused_leg(self, node: str, service_s: float):
        wait = self.storage.resources.kvs(node).request(self.t0, service_s)
        self.elapsed += wait + service_s
        self.queue_wait += wait
        self.service += service_s
        return
        yield  # noqa: unreachable — makes this a generator

    def async_replica(self, node: str, wan_lat: float, service_s: float,
                      label: str):
        arrive = self.now + wan_lat
        q = self.storage.resources.kvs(node)
        if self.kernel is not None:
            self.kernel.call_at(arrive,
                                lambda: q.request(arrive, service_s),
                                label=label)
        else:
            q.request(arrive, service_s)


class _EventClock:
    """Parked-waiter queueing: every leg is a real kernel event.

    KVS legs hold the queue's slot (``acquire``/``release``) exactly like
    CPU slots, so a capacity grow re-admits queued ops; transfers are
    kernel sleeps; the async replica is its own spawned process arriving
    at the target after the WAN leg."""

    def __init__(self, storage: "TwoTierStorage", kernel):
        self.storage = storage
        self.kernel = kernel
        self.t0 = kernel.now
        # queue-wait vs service attribution for the flight recorder
        self.queue_wait = 0.0
        self.service = 0.0

    @property
    def now(self) -> float:
        return self.kernel.now

    def total(self) -> float:
        return self.kernel.now - self.t0

    def sleep(self, dt: float):
        if dt > 0:
            yield dt

    def kvs_leg(self, node: str, service_s: float):
        res = self.storage.resources.kvs(node)
        t_enq = self.kernel.now
        yield ("acquire", res)
        self.queue_wait += self.kernel.now - t_enq
        self.service += service_s
        res.total_service += service_s
        yield service_s
        yield ("release", res)

    fused_leg = kvs_leg

    def async_replica(self, node: str, wan_lat: float, service_s: float,
                      label: str):
        self.kernel.spawn(self.kvs_leg(node, service_s), label=label,
                          at=self.kernel.now + wan_lat)


class TwoTierStorage:
    def __init__(self, graph_fn: Callable[[float], TopologyGraph],
                 resources: Optional[ResourcePool] = None):
        self.graph_fn = graph_fn
        self.local: Dict[str, Dict[str, StoredState]] = {}
        # region-sharded global tier: one shard per cloud region, homes by
        # rendezvous hashing — the single-region degenerate case behaves
        # exactly like the old one-dict global store
        self.global_tier = GlobalTier()
        # per-node KVS service queues: requests serialize on the holder —
        # under parallel workflows the cloud KVS becomes the bottleneck
        # for Stateless (per *region* once sharded), while Databelt
        # spreads load over satellite-local stores (paper Table 3 / Fig 13)
        self.resources = resources or ResourcePool()
        # an attached SimKernel turns async replication into deferred
        # events; None falls back to inline accounting (sequential mode)
        self.scheduler = None
        # optional flight recorder (repro_torch.sim.trace.SpanRecorder): the
        # session layer checks this for None before wrapping any op, so
        # untraced runs keep the raw generator fast path
        self.recorder = None

    @staticmethod
    def _clouds(graph: TopologyGraph) -> List[str]:
        return graph.ids_of_kind(CLOUD)

    # -- race-sanitizer hook ---------------------------------------------
    @staticmethod
    def _race_note(clock):
        """``kernel.note_access`` bound to the op's kernel when the race
        sanitizer is attached, else None — one check per *op*, zero cost
        per access when detection is off.  Accesses are noted per
        ``node/encoded-key`` cell, so two branches touching different
        state keys never conflict."""
        k = clock.kernel
        if k is not None and k.races is not None:
            return k.note_access
        return None

    # -- global-tier replication (k=2 fan-out) --------------------------
    def _replicate_targets(self, graph: TopologyGraph, src: str,
                           enc: str) -> List[str]:
        """Replica fan-out for a write from ``src``: the writer-nearest
        region (the cheap WAN leg, primary durability) plus the key's
        *home* shard — where every fallback read probes first.  With one
        cloud both collapse to it (k=1, the original design)."""
        nearest = graph.nearest_of_kind(src, CLOUD)
        if nearest is None:
            return []
        home = self.global_tier.home(enc, self._clouds(graph))
        return [nearest] if home == nearest else [nearest, home]

    def _replicate_record(self, graph: TopologyGraph, src: str,
                          key: StateKey, st: StoredState) -> List[str]:
        """Register the global replicas in their shards and return the
        target cloud nodes (empty when the topology has no cloud — the
        value is then retained unsharded so fallback can still serve it)."""
        enc = key.encoded()
        targets = self._replicate_targets(graph, src, enc)
        self.global_tier.put_replicas(enc, st, targets or None)
        return targets

    def _global_locate(self, graph: TopologyGraph, enc: str, reader: str,
                       heal: bool = False
                       ) -> Tuple[Optional[StoredState], Optional[str],
                                  bool]:
        """Resolve ``enc`` through the sharded global tier: the key's home
        region first, then cross-region fallback to the replica nearest
        the reader.  Returns ``(state, serving_cloud, home_hit)``;
        ``serving_cloud`` is None when the value exists but no in-graph
        cloud holds it (the unsharded legacy shard) — the caller then
        charges the holder.  ``home_hit`` separates the home-shard path
        from the cross-region fallback for tier attribution.

        ``heal`` enables read-repair: a home-shard miss served from a
        fallback replica re-populates the home shard, so the *next* read
        hits home instead of re-paying the cross-region WAN.  Only real
        read paths heal — pure peeks (SLO accounting) must not mutate."""
        clouds = self._clouds(graph)
        if clouds:
            home = self.global_tier.home(enc, clouds)
            if self.global_tier.has(enc, home):
                return self.global_tier.get(enc, home), home, True
            holders = self.global_tier.locate(enc)
            if holders:
                def rank(r: str):
                    if r in graph.nodes:
                        _, lat = graph.dijkstra(r, reader)
                    else:
                        lat = math.inf
                    return (lat, r)
                best = min(holders, key=rank)
                st = self.global_tier.get(enc, best)
                if heal:
                    self.global_tier.heal(enc, home, st)
                return st, best if best in graph.nodes else None, False
            return None, None, False
        return self.global_tier.get_any(enc), None, False

    # ------------------------------------------------------------------
    # the one internal path per operation (clock-parameterized generators)
    # ------------------------------------------------------------------
    def _op_put(self, key: StateKey, size: float, payload, clock,
                writer_node: Optional[str] = None,
                replicate_global: bool = True,
                global_sync: bool = False,
                account: bool = True):
        """Write from ``writer_node`` to ``key.storage_address``."""
        graph = self.graph_fn(clock.now)
        src = writer_node or key.storage_address
        dst = key.storage_address
        st = StoredState(key, size, payload)
        lat, hops = self._transfer(graph, src, dst, size)
        if not math.isfinite(lat):
            # target unreachable right now: keep the state local (the
            # Offload fallback) — the global replica still happens
            dst = src
            st = StoredState(key.moved(src), size, payload)
            lat, hops = 0.0, 0
        bucket = self.local.setdefault(dst, {})
        note = self._race_note(clock)
        if note is not None:
            note(self.local, f"{dst}/{key.encoded()}", "w")
            if st.key.encoded() != key.encoded():
                note(self.local, f"{dst}/{st.key.encoded()}", "w")
        bucket[st.key.encoded()] = st
        bucket[key.encoded()] = st
        if not account:
            if replicate_global:
                self._replicate_record(graph, src, key, st)
                if note is not None:
                    note(self.global_tier, key.encoded(), "w")
            return AccessResult(0.0, hops, src == dst, tier="register",
                                node=dst)
        # leg order is the same in BOTH modes (the redesign's contract:
        # the mode changes how legs are paid, never which legs or their
        # order): the write commits the destination KVS slot at op start
        # — the commit-at-enqueue model the analytic path always used —
        # then pays the transfer.  NOTE this deliberately supersedes the
        # pre-redesign opt-in event path, which joined the dst queue only
        # after the transfer; the event default is re-baselined on it.
        service_s = KVS_OP_LATENCY + size / KVS_WRITE_BW
        yield from clock.kvs_leg(dst, service_s)
        yield from clock.sleep(lat)
        if replicate_global:
            # redundancy writes: the nearest region's shard (paper: write
            # times are nearly system-independent because every system
            # pays this cloud-bound leg) plus the key's home shard
            targets = self._replicate_record(graph, src, key, st)
            if note is not None:
                note(self.global_tier, key.encoded(), "w")
            for i, cloud in enumerate(targets):
                if cloud == dst:
                    continue
                glat, _ = self._transfer(graph, src, cloud, size)
                if not math.isfinite(glat):
                    continue
                if global_sync and i == 0:
                    # stateless-style synchronous durability: the primary
                    # (nearest-region) cloud write is on the critical path
                    yield from clock.sleep(glat)
                    yield from clock.kvs_leg(cloud, service_s)
                else:
                    # async replica off the writer's critical path: it
                    # occupies the target cloud's KVS queue on arrival
                    clock.async_replica(cloud, glat, service_s,
                                        f"replicate:{key.encoded()}")
        return AccessResult(clock.total(), hops, src == dst,
                            network_latency=lat,
                            tier="write-local" if src == dst
                            else "write-remote", node=dst,
                            queue_wait_s=clock.queue_wait,
                            service_s=clock.service)

    def _op_get(self, key: StateKey, reader_node: str, clock):
        graph = self.graph_fn(clock.now)
        enc = key.encoded()
        note = self._race_note(clock)
        # local tier on the reader itself
        if note is not None:
            note(self.local, f"{reader_node}/{enc}", "r")
        st = self.local.get(reader_node, {}).get(enc)
        if st is not None:
            yield from clock.kvs_leg(reader_node,
                                     KVS_OP_LATENCY + st.size / KVS_READ_BW)
            return st, AccessResult(clock.total(), 0, True,
                                    tier="local", node=reader_node,
                                    queue_wait_s=clock.queue_wait,
                                    service_s=clock.service)
        # local tier on the address node
        holder = key.storage_address
        if note is not None:
            note(self.local, f"{holder}/{enc}", "r")
        st = self.local.get(holder, {}).get(enc)
        if st is not None and holder in graph.nodes:
            lat, hops = self._transfer(graph, holder, reader_node, st.size)
            if math.isfinite(lat):
                yield from clock.kvs_leg(
                    holder, KVS_OP_LATENCY + st.size / KVS_READ_BW)
                yield from clock.sleep(lat)
                return st, AccessResult(clock.total(), hops, False,
                                        network_latency=lat,
                                        tier="holder", node=holder,
                                        queue_wait_s=clock.queue_wait,
                                        service_s=clock.service)
        # global tier fallback (holder missing or unreachable): home
        # shard first, then cross-region — healing the home shard when
        # the fallback served the read
        if note is not None:
            note(self.global_tier, enc, "r")
        st, serving, home_hit = self._global_locate(graph, enc,
                                                    reader_node, heal=True)
        if note is not None and st is not None and not home_hit:
            note(self.global_tier, enc, "w")   # read-repair healed home
        if st is not None:
            src_node = serving or holder
            lat, hops = self._transfer(graph, src_node, reader_node,
                                       st.size)
            if not math.isfinite(lat):
                # total partition: charge a worst-case detour, keep running
                lat, hops = PARTITION_DETOUR_LATENCY_S, PARTITION_DETOUR_HOPS
            yield from clock.kvs_leg(
                src_node, KVS_OP_LATENCY + st.size / KVS_READ_BW)
            yield from clock.sleep(lat)
            return st, AccessResult(clock.total(), hops, False,
                                    from_global=True, global_keys=1,
                                    network_latency=lat,
                                    tier="global-home" if home_hit
                                    else "global-fallback",
                                    node=src_node,
                                    queue_wait_s=clock.queue_wait,
                                    service_s=clock.service)
        return None, AccessResult(math.inf, 10**9, False, tier="missing",
                                  node=reader_node)

    def _op_get_fused(self, keys, reader_node: str, clock):
        """Grouped retrieval for a fusion group: ONE request per source
        node (paper §4.2) instead of one per function."""
        graph = self.graph_fn(clock.now)
        note = self._race_note(clock)
        by_source: Dict[str, float] = {}
        states = []
        n_global = 0
        for key in keys:
            loc = self._locate(key, reader_node, graph, heal=True,
                               note=note)
            if loc is None:
                return None, AccessResult(math.inf, 10**9, False,
                                          tier="missing",
                                          node=reader_node)
            st, src, tier = loc
            by_source[src] = by_source.get(src, 0.0) + st.size
            states.append(st)
            n_global += 1 if tier.startswith("global") else 0
        max_hops, all_local, net = 0, True, 0.0
        for src, size in by_source.items():
            lat, hops = self._transfer(graph, src, reader_node, size)
            if not math.isfinite(lat):
                lat, hops = PARTITION_DETOUR_LATENCY_S, PARTITION_DETOUR_HOPS
            yield from clock.fused_leg(
                src, KVS_OP_LATENCY + size / KVS_READ_BW)
            yield from clock.sleep(lat)
            net += lat
            max_hops = max(max_hops, hops)
            all_local &= src == reader_node
        return states, AccessResult(clock.total(), max_hops, all_local,
                                    from_global=n_global > 0,
                                    global_keys=n_global,
                                    network_latency=net,
                                    tier="fused", node=reader_node,
                                    queue_wait_s=clock.queue_wait,
                                    service_s=clock.service)

    # ------------------------------------------------------------------
    # synchronous entry points (analytic clock, drained inline)
    # ------------------------------------------------------------------
    @staticmethod
    def _drain(gen):
        """Run a clock-parameterized op under an analytic clock: the
        generator never yields, so exhausting it returns the result."""
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value
        raise RuntimeError(
            "analytic storage op yielded — event-mode ops must be driven "
            "on a kernel via StateSession")

    def put(self, key: StateKey, size: float, payload=None, t: float = 0.0,
            writer_node: Optional[str] = None,
            replicate_global: bool = True,
            global_sync: bool = False,
            account: bool = True) -> AccessResult:
        """Synchronous write from ``writer_node`` to
        ``key.storage_address`` (analytic queue accounting)."""
        return self._drain(self._op_put(
            key, size, payload, _AnalyticClock(self, t),
            writer_node=writer_node, replicate_global=replicate_global,
            global_sync=global_sync, account=account))

    def get(self, key: StateKey, reader_node: str,
            t: float = 0.0) -> Tuple[Optional[StoredState], AccessResult]:
        """Synchronous read (analytic queue accounting)."""
        return self._drain(self._op_get(key, reader_node,
                                        _AnalyticClock(self, t)))

    def get_fused(self, keys, reader_node: str, t: float = 0.0):
        """Synchronous grouped read (analytic queue accounting)."""
        return self._drain(self._op_get_fused(keys, reader_node,
                                              _AnalyticClock(self, t)))

    # ------------------------------------------------------------------
    def _locate(self, key: StateKey, reader: str, graph,
                heal: bool = False, note=None):
        """Resolve ``key`` for ``reader``: reader-local → holder node →
        global tier.  Returns ``(state, serving_node, tier)`` — tier one
        of ``"local"``/``"holder"``/``"global-home"``/
        ``"global-fallback"`` — or None.  ``note`` is the race
        sanitizer's access hook (each tier probe is a read; a heal that
        re-populates the home shard is a write)."""
        enc = key.encoded()
        if note is not None:
            note(self.local, f"{reader}/{enc}", "r")
        if enc in self.local.get(reader, {}):
            return (self.local[reader][enc], reader, "local")
        holder = key.storage_address
        if note is not None:
            note(self.local, f"{holder}/{enc}", "r")
        if enc in self.local.get(holder, {}) and holder in graph.nodes:
            return (self.local[holder][enc], holder, "holder")
        if note is not None:
            note(self.global_tier, enc, "r")
        st, serving, home_hit = self._global_locate(graph, enc, reader,
                                                    heal=heal)
        if note is not None and st is not None and heal and not home_hit:
            note(self.global_tier, enc, "w")   # read-repair healed home
        if st is not None:
            return (st, serving or holder,
                    "global-home" if home_hit else "global-fallback")
        return None

    WAN_EFFICIENCY = 0.6   # TCP over 45-75 ms RTT links never hits line rate

    def _transfer(self, graph: TopologyGraph, src: str, dst: str,
                  size: float) -> Tuple[float, int]:
        if src == dst:
            return 0.0, 0
        # latency / bottleneck-bw / hops are memoized per (src, dst) on
        # the snapshot; only the size-dependent wire time is per-op
        lat, bw, hops = graph.path_cost(src, dst)
        if bw <= 0:
            return math.inf, 10**9
        if bw < 1e9:           # constrained (ground/WAN) bottleneck
            bw *= self.WAN_EFFICIENCY
        return lat + size / bw, hops
