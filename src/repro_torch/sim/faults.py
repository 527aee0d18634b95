"""Scheduled churn on the discrete-event kernel: node drains + link loss.

The ROADMAP's failure-injection item: measure the global-tier fallback
path *under churn*, not just across topology snapshots.  A ``FaultPlan``
is a deterministic, serializable schedule of fault events; a
``FaultInjector`` replays it on a ``SimKernel`` against one engine's
``ContinuumNetwork`` + ``ResourcePool``:

* **node drain** — the node vanishes from every topology snapshot
  (``ContinuumNetwork.set_node_down``: placement, transfers and
  global-tier home hashing all route around it) and its CPU/KVS
  ``SlotResource`` pools are drained to capacity 0 — the autoscaler's
  drain-shrink machinery, so in-flight work always runs to completion
  and **nothing is ever preempted**; newly arriving work parks on the
  FIFO.  The restore re-adds the node and re-grows the pools to their
  pre-drain capacities, re-admitting every parked waiter in one event.
* **link loss** — the (bidirectional) link drops out of every snapshot
  until restored; traffic re-routes over the surviving paths.

Determinism: a plan is a plain list of ``FaultEvent``s (generators like
``FaultPlan.poisson`` draw them from seeded ``random.Random`` streams),
and the injector applies them at exact simulated times — same plan, same
workload, same seed ⇒ bit-identical event trace and metrics.

The injector runs as a *regular* (non-daemon) process: it keeps the
simulation alive until its last restore has fired, so a drain can never
strand parked waiters at end-of-run.  Churn requires the engine's
event-driven mode — analytic committed-schedule accounting cannot park a
request on a down node (``SlotResource.request`` raises on a fully
drained pool).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sim.kernel import SimKernel
from repro_torch.sim.resources import ResourcePool

NODE_DRAIN = "drain"
LINK_LOSS = "link"


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: a node drain or a link loss, lasting
    ``duration_s`` simulated seconds from ``t``."""
    t: float
    duration_s: float
    kind: str = NODE_DRAIN          # "drain" | "link"
    node: str = ""                  # drain target
    link: Tuple[str, str] = ()      # link-loss endpoints

    def to_dict(self) -> dict:
        return {"t": self.t, "duration_s": self.duration_s,
                "kind": self.kind, "node": self.node,
                "link": list(self.link)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(t=float(d["t"]), duration_s=float(d["duration_s"]),
                   kind=d.get("kind", NODE_DRAIN),
                   node=d.get("node", ""),
                   link=tuple(d.get("link", ())))


@dataclass
class FaultPlan:
    """A deterministic churn schedule: just a list of ``FaultEvent``s.

    Build one explicitly, or with a seeded generator::

        FaultPlan.poisson(rate=0.05, outage_s=6.0,
                          targets=("cloud0", "cloud1"),
                          horizon_s=60.0, seed=23)

    Plans are value objects — serializable (``to_dict``/``from_dict``,
    the ``repro_torch.scenario`` round-trip) and reusable across runs and
    strategies (the fig18 sweep applies the *same* plan to all three)."""
    events: List[FaultEvent] = field(default_factory=list)

    @classmethod
    def poisson(cls, rate: float, outage_s: float,
                targets: Sequence[str], horizon_s: float,
                seed: int = 0, start: float = 0.0,
                kind: str = NODE_DRAIN) -> "FaultPlan":
        """Per-target Poisson churn: each target independently draws
        outage starts at ``rate`` per second (exponential gaps, seeded
        per target), each lasting ``outage_s``; outages on one target
        never overlap (the next draw starts after the restore).  ``kind``
        selects node drains (targets are node ids) or link losses
        (targets are ``"a|b"`` pairs)."""
        events: List[FaultEvent] = []
        for idx, target in enumerate(targets):
            rng = random.Random(seed * 1000003 + idx)
            t = start + rng.expovariate(rate) if rate > 0 else None
            while t is not None and t < start + horizon_s:
                if kind == LINK_LOSS:
                    a, b = target.split("|")
                    events.append(FaultEvent(t, outage_s, LINK_LOSS,
                                             link=(a, b)))
                else:
                    events.append(FaultEvent(t, outage_s, NODE_DRAIN,
                                             node=target))
                t = t + outage_s + rng.expovariate(rate)
        events.sort(key=lambda e: (e.t, e.node, e.link))
        return cls(events=events)

    def to_dict(self) -> dict:
        return {"events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(events=[FaultEvent.from_dict(e)
                           for e in d.get("events", [])])

    def __len__(self) -> int:
        return len(self.events)


@dataclass
class FaultReport:
    """What the injector actually did during one run."""
    applied: List[FaultEvent] = field(default_factory=list)
    skipped: List[FaultEvent] = field(default_factory=list)
    restores: int = 0

    @property
    def drains(self) -> int:
        return sum(1 for e in self.applied if e.kind == NODE_DRAIN)

    @property
    def link_losses(self) -> int:
        return sum(1 for e in self.applied if e.kind == LINK_LOSS)


class FaultInjector:
    """Replays a ``FaultPlan`` on one engine's kernel/network/pool."""

    def __init__(self, kernel: SimKernel, net, pool: ResourcePool,
                 plan: FaultPlan):
        self.kernel = kernel
        self.net = net
        self.pool = pool
        self.plan = plan
        # node id -> {resource kind: capacity at drain time}
        self._down: Dict[str, Dict[str, int]] = {}
        self._lost_links: set = set()
        self._report = FaultReport()

    # -- wiring ----------------------------------------------------------
    def start(self) -> "FaultInjector":
        """Spawn the injector as a regular process: it sleeps between
        events and exits after the last one; restores are deferred
        ``call_at`` events — both keep ``run()`` alive until the final
        restore, so parked waiters are always re-admitted."""
        if self.plan.events:
            self.kernel.spawn(self._proc(), label="faults")
        return self

    def _proc(self):
        for ev in sorted(self.plan.events,
                         key=lambda e: (e.t, e.node, e.link)):
            gap = ev.t - self.kernel.now
            if gap > 0:
                yield gap
            self._apply(ev)

    # -- applying faults -------------------------------------------------
    def _apply(self, ev: FaultEvent) -> None:
        if ev.kind == LINK_LOSS:
            self._apply_link(ev)
            return
        node = ev.node
        if node in self._down:
            # overlapping drain of an already-down node: the first
            # outage's restore wins; re-draining would lose its prior
            # capacities
            self.kernel.log(f"fault:skip:drain:{node}")
            self._report.skipped.append(ev)
            return
        # force-create the node's pools (while its topology entry is
        # still up) so work arriving mid-outage parks instead of running
        # on a phantom fresh resource
        prior: Dict[str, int] = {}
        for kind, res in ((ResourcePool.CPU, self.pool.cpu(node)),
                          (ResourcePool.KVS, self.pool.kvs(node))):
            prior[kind] = res.capacity
            if self.kernel.races is not None:
                self.kernel.note_access(res, "capacity", "w")
            res.set_capacity(0, self.kernel.now)
        self._down[node] = prior
        self.net.set_node_down(node, True)
        self.kernel.log(f"fault:drain:{node}")
        rec = self.kernel.recorder
        if rec is not None:
            rec.instant("fault:drain", "fault", node,
                        duration_s=ev.duration_s)
        self._report.applied.append(ev)
        self.kernel.call_at(self.kernel.now + ev.duration_s,
                            lambda n=node: self._restore(n),
                            label=f"fault-restore:{node}")

    def _restore(self, node: str) -> None:
        prior = self._down.pop(node, None)
        if prior is None:
            return
        self.net.set_node_down(node, False)
        rec = self.kernel.recorder
        now = self.kernel.now
        for kind, cap in sorted(prior.items()):
            res = self.pool.peek(kind, node)
            if res is None:
                continue
            if self.kernel.races is not None:
                self.kernel.note_access(res, "capacity", "w")
            for proc, label, waited in res.set_capacity(cap, now):
                self.kernel.log(f"grant:{label}@{res.name}")
                if rec is not None and waited > 0.0:
                    rec.complete("slot_wait", "kernel", res.name,
                                 now - waited, now, proc=label)
                self.kernel.wake(proc, label)
        self.kernel.log(f"fault:restore:{node}")
        if rec is not None:
            rec.instant("fault:restore", "fault", node)
        self._report.restores += 1

    def _apply_link(self, ev: FaultEvent) -> None:
        a, b = ev.link
        pair = (a, b) if a <= b else (b, a)
        if pair in self._lost_links:
            self.kernel.log(f"fault:skip:linkloss:{a}|{b}")
            self._report.skipped.append(ev)
            return
        self._lost_links.add(pair)
        self.net.set_link_down(a, b, True)
        self.kernel.log(f"fault:linkloss:{a}|{b}")
        rec = self.kernel.recorder
        if rec is not None:
            rec.instant("fault:linkloss", "fault", f"{a}|{b}",
                        duration_s=ev.duration_s)
        self._report.applied.append(ev)
        self.kernel.call_at(self.kernel.now + ev.duration_s,
                            lambda p=pair: self._restore_link(p),
                            label=f"fault-restore:{a}|{b}")

    def _restore_link(self, pair: Tuple[str, str]) -> None:
        if pair not in self._lost_links:
            return
        self._lost_links.discard(pair)
        self.net.set_link_down(pair[0], pair[1], False)
        self.kernel.log(f"fault:linkrestore:{pair[0]}|{pair[1]}")
        rec = self.kernel.recorder
        if rec is not None:
            rec.instant("fault:linkrestore", "fault",
                        f"{pair[0]}|{pair[1]}")
        self._report.restores += 1

    # -- results ---------------------------------------------------------
    def report(self) -> FaultReport:
        return self._report
