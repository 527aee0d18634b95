"""SLO-aware autoscaling on the discrete-event kernel.

The ``Autoscaler`` is a *daemon process* on the ``SimKernel``: every
``interval_s`` of simulated time it samples each managed ``SlotResource``
(per-node CPU-slot pools and KVS service queues in the engine's
``ResourcePool``) plus the rolling p95 of recently completed workflow
instances, and resizes capacities with the classic asymmetric rule pair:

* **scale up fast** — when a queue's waiting depth exceeds
  ``queue_high x capacity`` (or any backlog exists while the rolling p95
  breaches ``p95_slo_s``), capacity doubles immediately, capped at
  ``max_capacity``.  Newly added servers admit parked waiters in the same
  event (``SlotResource.set_capacity`` returns them; the autoscaler
  ``kernel.wake()``s each).
* **scale down with hysteresis** — only after ``scale_down_after``
  *consecutive* calm intervals (no waiters, at most half the servers busy)
  does capacity step down by 25%.  The shrink floor is the resource's
  *initial* capacity (initial capacities model provisioned hardware —
  a node's cores, its baseline KVS service — which the controller can
  exceed but never decommission); ``min_capacity`` can only raise that
  floor.  A single busy interval resets the streak, so oscillating load
  cannot thrash capacity.

Shrinks drain: ``SlotResource`` retires servers as they free and excess
held slots fall away one release at a time — in-flight work is never
preempted.

With ``provision_delay_s > 0`` scale-ups model real provisioning: the
decision at t lands at ``t + delay`` (a deferred kernel event), and the
in-flight grow is published to the ``ResourcePool`` as a *pending* grow so
the placement planner's busy view scores the pool by its projected
capacity — a pool mid-scale-up is cheaper than its current queue depth
suggests (ROADMAP: autoscale-aware placement).  Every decision is a pure function of simulated state, so runs
with the autoscaler enabled stay deterministically replayable; actions are
``kernel.log``-ed into the event trace and collected for the
``ParallelReport``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.sim.kernel import SimKernel
from repro_torch.sim.metrics import percentile
from repro_torch.sim.resources import ResourcePool, SlotResource


@dataclass
class AutoscalePolicy:
    """Knobs of the control loop (see module docstring for the rules)."""
    interval_s: float = 0.5        # control period (simulated seconds)
    queue_high: float = 2.0        # waiting-per-server ratio that trips
                                   # a scale-up
    p95_slo_s: Optional[float] = None  # rolling-p95 target; a breach makes
                                   # any backlog trip a scale-up
    scale_down_after: int = 4      # consecutive calm intervals before a
                                   # shrink (hysteresis)
    shrink_frac: float = 0.25      # capacity fraction removed per shrink
    min_capacity: int = 1          # raises the shrink floor above a
                                   # resource's initial capacity; it can
                                   # never lower it (initial = provisioned
                                   # hardware)
    max_capacity: int = 64         # growth ceiling per resource
    provision_delay_s: float = 0.0  # scale-up provisioning time: a grow
                                   # decided at t lands at t + delay; while
                                   # in flight it is published to the pool
                                   # as a *pending* grow so the placement
                                   # planner can score projected capacity
                                   # (0 = instant, the original behavior)
    kinds: Tuple[str, ...] = (ResourcePool.CPU, ResourcePool.KVS)
    window: int = 64               # completed-instance latencies kept for
                                   # the rolling p95


@dataclass
class AutoscaleAction:
    t: float
    resource: str
    old_capacity: int
    new_capacity: int
    reason: str                    # "queue" | "p95" | "idle"


@dataclass
class AutoscaleReport:
    actions: List[AutoscaleAction] = field(default_factory=list)
    final_capacities: Dict[str, int] = field(default_factory=dict)
    initial_capacities: Dict[str, int] = field(default_factory=dict)

    @property
    def scale_ups(self) -> int:
        return sum(1 for a in self.actions
                   if a.new_capacity > a.old_capacity)

    @property
    def scale_downs(self) -> int:
        return sum(1 for a in self.actions
                   if a.new_capacity < a.old_capacity)

    def cost(self, rates: Dict[str, float], horizon_s: float) -> float:
        """Cosmos-style $ audit: integrate provisioned capacity over the
        run — ``sum over resources of capacity(t) x dt x rate[kind]``
        for t in [0, horizon_s], where ``rates`` maps a resource kind
        (``"cpu"`` / ``"kvs"``) to its $-per-slot-second price.  The
        capacity timeline is reconstructed from ``initial_capacities``
        and the recorded ``actions``; a fixed-capacity run (no actions)
        therefore audits to ``initial x horizon x rate`` — the baseline
        an autoscaled run's spend is compared against."""
        by_res: Dict[str, List[AutoscaleAction]] = {}
        for a in self.actions:
            by_res.setdefault(a.resource, []).append(a)
        total = 0.0
        for name in sorted(set(self.initial_capacities) | set(by_res)):
            rate = rates.get(name.split(":", 1)[0], 0.0)
            if rate <= 0.0:
                continue
            acts = sorted(by_res.get(name, []), key=lambda a: a.t)
            cap = self.initial_capacities.get(
                name, acts[0].old_capacity if acts else 0)
            t_prev = 0.0
            for a in acts:
                t = min(max(a.t, 0.0), horizon_s)
                total += cap * max(t - t_prev, 0.0) * rate
                t_prev, cap = t, a.new_capacity
            total += cap * max(horizon_s - t_prev, 0.0) * rate
        return total


class Autoscaler:
    """Periodic capacity controller over one engine's ``ResourcePool``."""

    def __init__(self, kernel: SimKernel, pool: ResourcePool,
                 policy: Optional[AutoscalePolicy] = None):
        self.kernel = kernel
        self.pool = pool
        self.policy = policy or AutoscalePolicy()
        self.actions: List[AutoscaleAction] = []
        self._latencies: deque = deque(maxlen=self.policy.window)
        self._calm: Dict[str, int] = {}     # resource name -> calm streak

    # -- wiring ----------------------------------------------------------
    def start(self) -> "Autoscaler":
        self.kernel.spawn(self._control_proc(), label="autoscaler",
                          daemon=True)
        return self

    def observe_latency(self, latency_s: float) -> None:
        """Feed one completed-instance latency into the rolling window."""
        if self.kernel.races is not None:
            # instance procs write the window the daemon's tick reads
            self.kernel.note_access(self, "window", "w")
        self._latencies.append(latency_s)

    def rolling_p95(self) -> float:
        return percentile(list(self._latencies), 95)

    # -- control loop ----------------------------------------------------
    def _control_proc(self):
        p = self.policy
        while True:
            yield p.interval_s
            self._tick()

    def _tick(self) -> None:
        p = self.policy
        now = self.kernel.now
        if self.kernel.races is not None:
            self.kernel.note_access(self, "window", "r")
        p95_breach = (p.p95_slo_s is not None and len(self._latencies) > 0
                      and self.rolling_p95() > p.p95_slo_s)
        for kind in p.kinds:
            for res in self.pool.resources(kind):
                self._decide(res, now, p95_breach)

    def _decide(self, res: SlotResource, now: float,
                p95_breach: bool) -> None:
        p = self.policy
        if res.drained:
            # a fault drain owns this resource until its restore: the
            # controller must not re-provision a down node (nor count the
            # outage as calm)
            self._calm[res.name] = 0
            return
        if self.pool.pending_grow_ready(res.name) is not None:
            # a grow is already provisioning: don't double-order capacity
            # (and don't count the interval as calm either)
            self._calm[res.name] = 0
            return
        if self.kernel.races is not None:
            # the control read conflicting with any same-instant resize
            self.kernel.note_access(res, "capacity", "r")
        waiting = res.queue_len(now)
        busy = res.in_service(now)
        cap = res.capacity
        floor = max(p.min_capacity, res.initial_capacity)
        if waiting > p.queue_high * cap or (p95_breach and waiting > 0):
            if cap < p.max_capacity:
                new_cap = min(p.max_capacity, cap * 2)
                reason = "p95" if (p95_breach and
                                   waiting <= p.queue_high * cap) \
                    else "queue"
                self._resize(res, new_cap, now, reason)
            self._calm[res.name] = 0
            return
        if waiting == 0 and busy * 2 <= cap:
            streak = self._calm.get(res.name, 0) + 1
            self._calm[res.name] = streak
            if streak >= p.scale_down_after and cap > floor:
                new_cap = max(floor,
                              cap - max(1, int(cap * p.shrink_frac)))
                self._resize(res, new_cap, now, "idle")
                self._calm[res.name] = 0
            return
        self._calm[res.name] = 0

    def _resize(self, res: SlotResource, new_cap: int, now: float,
                reason: str) -> None:
        if new_cap == res.capacity:
            return
        delay = self.policy.provision_delay_s
        if new_cap > res.capacity and delay > 0.0:
            # provisioning model: the capacity lands after the delay; the
            # pending grow is published so the planner's busy view can
            # score the pool by its projected (not current) capacity
            ready = now + delay
            self.pool.note_pending_grow(res.name, ready)
            self.kernel.log(
                f"autoscale-pending:{res.name}:{res.capacity}->"
                f"{new_cap}:{reason}")
            rec = self.kernel.recorder
            if rec is not None:
                rec.instant("autoscale-pending", "autoscale", res.name,
                            old=res.capacity, new=new_cap, reason=reason,
                            ready_t=ready)
            self.kernel.call_at(
                ready,
                lambda: self._apply_pending(res, new_cap, reason),
                label=f"provision:{res.name}")
            return
        self._apply(res, new_cap, now, reason)

    def _apply_pending(self, res: SlotResource, new_cap: int,
                       reason: str) -> None:
        self.pool.clear_pending_grow(res.name)
        if res.drained:
            # the node went down while the grow was provisioning: the
            # order is void — the fault restore re-establishes capacity
            return
        if new_cap > res.capacity:
            self._apply(res, new_cap, self.kernel.now, reason)

    def _apply(self, res: SlotResource, new_cap: int, now: float,
               reason: str) -> None:
        old = res.capacity
        rec = self.kernel.recorder
        if self.kernel.races is not None:
            self.kernel.note_access(res, "capacity", "w")
        woken = res.set_capacity(new_cap, now)
        for proc, label, waited in woken:
            self.kernel.log(f"grant:{label}@{res.name}")
            if rec is not None and waited > 0.0:
                rec.complete("slot_wait", "kernel", res.name,
                             now - waited, now, proc=label)
            self.kernel.wake(proc, label)
        self.kernel.log(
            f"autoscale:{res.name}:{old}->{res.capacity}:{reason}")
        if rec is not None:
            rec.instant("autoscale", "autoscale", res.name, old=old,
                        new=res.capacity, reason=reason,
                        woken=len(woken))
        self.actions.append(AutoscaleAction(now, res.name, old,
                                            res.capacity, reason))

    # -- results ---------------------------------------------------------
    def report(self) -> AutoscaleReport:
        caps: Dict[str, int] = {}
        init: Dict[str, int] = {}
        for kind in self.policy.kinds:     # managed kinds only
            caps.update(self.pool.capacities(kind))
            init.update({res.name: res.initial_capacity
                         for res in self.pool.resources(kind)})
        return AutoscaleReport(actions=list(self.actions),
                               final_capacities=caps,
                               initial_capacities=init)
