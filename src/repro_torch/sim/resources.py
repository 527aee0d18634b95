"""First-class simulated resources: per-node CPU slots and KVS queues.

``SlotResource`` is a deterministic c-server FIFO queue used in one of two
styles (one style per resource):

* **analytic jobs** — ``request(t, service_s)`` for work whose service
  time is known up front (a KVS read/write).  Returns the queueing delay;
  the caller sleeps ``wait + service_s`` on the kernel.  Arrival order is
  the kernel's event order, so the per-slot free-time accounting is exact.
* **held slots** — for work whose duration is only known at the end (a
  sandbox executing a fusion group).  Processes ``yield ("acquire", res)``
  and ``yield ("release", res)``; the ``SimKernel`` grants slots FIFO and
  wakes the head waiter on release.

``ResourcePool`` owns every resource of one engine, keyed by
``(kind, node_id)`` — the engine's per-node CPU slots and the storage
layer's per-node KVS service queues live in the *same* pool, which is what
makes the three state strategies contend realistically.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Callable, Dict, Optional, Tuple


class SlotResource:
    """Deterministic FIFO queue with ``capacity`` parallel servers.

    Capacity is *dynamic* (``set_capacity``): the SLO-aware autoscaler
    grows pools under queue pressure (newly added servers admit parked
    held-slot waiters immediately) and shrinks them by draining — a
    retiring server finishes its in-flight job and simply takes no new
    work; nothing is ever preempted.  ``set_capacity(0)`` is a *full
    drain* (the fault injector's forced node loss): in-flight work still
    runs to completion, new held-slot requests park until a later grow
    re-admits them, and analytic ``request``s on a fully drained resource
    raise (churn requires the event-driven engine mode).

    FIFO is *per assignment time*: an analytic ``request`` commits its
    start slot at enqueue (the caller immediately sleeps the returned
    wait), so a later capacity grow serves subsequently *arriving* jobs on
    the new servers but cannot re-schedule already-committed ones — the
    same way work already dispatched to a server finishes where it was
    sent.  Held-slot waiters, by contrast, are still parked and do get
    admitted by a grow."""

    def __init__(self, name: str, capacity: int = 1):
        self.name = name
        self.capacity = max(1, int(capacity))
        self.initial_capacity = self.capacity
        self._free_at = [0.0] * self.capacity   # analytic-job slot frees
        heapq.heapify(self._free_at)
        self._in_system: list = []              # ends of analytic jobs
        self._waiting: list = []                # starts of queued analytic
        self._held = 0                          # granted held slots
        self._wait_q: deque = deque()           # (proc, label, t_enqueued)
        # stats
        self.n_requests = 0
        self.total_wait = 0.0
        self.total_service = 0.0
        self.max_queue_depth = 0       # max jobs/processes waiting
        self.max_in_system = 0         # max queued-or-in-service
        self.last_busy_t = 0.0

    @property
    def drained(self) -> bool:
        """True while a fault drain holds the capacity at 0."""
        return self.capacity == 0

    # -- analytic one-shot jobs -----------------------------------------
    def _observe(self, t: float):
        while self._in_system and self._in_system[0] <= t:
            heapq.heappop(self._in_system)
        while self._waiting and self._waiting[0] <= t:
            heapq.heappop(self._waiting)

    def depth(self, t: float) -> int:
        """Jobs queued or in service at time ``t``."""
        self._observe(t)
        return len(self._in_system) + self._held + len(self._wait_q)

    def queue_len(self, t: float) -> int:
        """Jobs *waiting* (not yet in service) at time ``t`` — the
        autoscaler's primary pressure signal."""
        self._observe(t)
        return len(self._waiting) + len(self._wait_q)

    def in_service(self, t: float) -> int:
        """Jobs currently occupying a server at time ``t``."""
        self._observe(t)
        return (len(self._in_system) - len(self._waiting)) + self._held

    def request(self, t: float, service_s: float) -> float:
        """FIFO-enqueue a job of ``service_s``; returns the queueing wait.
        The job occupies a server during [t + wait, t + wait + service_s)."""
        self._observe(t)
        if not self._free_at:
            raise RuntimeError(
                f"{self.name} is fully drained (capacity 0); analytic "
                f"requests cannot park — run churn scenarios in the "
                f"event-driven engine mode")
        start = max(t, heapq.heappop(self._free_at))
        end = start + service_s
        heapq.heappush(self._free_at, end)
        heapq.heappush(self._in_system, end)
        if start > t:
            heapq.heappush(self._waiting, start)
        self.n_requests += 1
        self.total_wait += start - t
        self.total_service += service_s
        self.max_queue_depth = max(self.max_queue_depth, len(self._waiting))
        self.max_in_system = max(self.max_in_system, len(self._in_system))
        self.last_busy_t = max(self.last_busy_t, end)
        return start - t

    # -- held slots (driven by SimKernel) --------------------------------
    def hold(self, t: float) -> bool:
        """Grant a slot immediately if one is free; called by the kernel
        when a process yields ("acquire", self)."""
        if self._held < self.capacity:
            self._held += 1
            self.n_requests += 1
            self.max_in_system = max(self.max_in_system,
                                     self._held + len(self._wait_q))
            return True
        return False

    def enqueue_waiter(self, proc, label: str, t: float) -> None:
        self._wait_q.append((proc, label, t))
        self.max_queue_depth = max(self.max_queue_depth, len(self._wait_q))
        self.max_in_system = max(self.max_in_system,
                                 self._held + len(self._wait_q))

    def _admit_waiter(self, t: float):
        """Move the head waiter into a held slot, accounting its wait."""
        proc, label, t_enq = self._wait_q.popleft()
        self._held += 1
        self.n_requests += 1
        waited = t - t_enq
        self.total_wait += waited
        return proc, label, waited

    def unhold(self, t: float):
        """Release a held slot at ``t``; returns the woken head waiter as
        (proc, label, waited_s) — the slot transfers to it — or None.
        After a
        capacity shrink the freed slot may itself be retiring
        (``_held > capacity``): it then drains instead of re-granting."""
        if self._held <= 0:
            raise RuntimeError(f"release without acquire on {self.name}")
        self.last_busy_t = max(self.last_busy_t, t)
        self._held -= 1
        if self._wait_q and self._held < self.capacity:
            return self._admit_waiter(t)
        return None

    # -- dynamic capacity (autoscaler) -----------------------------------
    def set_capacity(self, new_capacity: int, t: float):
        """Resize to ``new_capacity`` servers at time ``t``.

        Grow: the added servers come up free at ``t`` and parked held-slot
        waiters are admitted immediately — returned as ``[(proc, label,
        waited_s), ...]`` for the caller to ``SimKernel.wake()``.
        Shrink: drain-only —
        the idlest servers retire first and anything in flight (analytic
        backlog or held slots) runs to completion; excess held slots fall
        away one release at a time via ``unhold``.  ``new_capacity=0`` is
        the fault injector's forced node drain: every server retires and
        held-slot waiters stay parked until a restore grows the pool
        again (the autoscaler itself never requests 0 — its shrink floor
        is the initial capacity)."""
        new_cap = max(0, int(new_capacity))
        woken = []
        if new_cap > self.capacity:
            for _ in range(new_cap - self.capacity):
                heapq.heappush(self._free_at, t)
            self.capacity = new_cap
            while self._wait_q and self._held < self.capacity:
                woken.append(self._admit_waiter(t))
        elif new_cap < self.capacity:
            entries = sorted(self._free_at)
            self._free_at = entries[self.capacity - new_cap:]
            heapq.heapify(self._free_at)
            self.capacity = new_cap
        return woken

    # -- planner view ----------------------------------------------------
    def next_free(self) -> float:
        """Load signal for the placement planner: earliest projected
        availability.  Exact for analytic queues; for held slots a
        saturation heuristic (last completion + pressure per waiter).

        A fully drained pool (capacity 0 — the fault injector's forced
        node loss) projects ``inf``: with no servers there is no
        projected availability, and the pre-fix ``0.0`` made a *drained*
        node look like the cheapest target in the fleet the moment its
        wait queue emptied.  The planner's busy view still overlays a
        pending capacity grow (the scheduled restore), so a node about
        to come back is scored by its restore time, not ``inf``."""
        if self.capacity == 0:
            return math.inf
        base = self._free_at[0] if self._free_at else 0.0
        if self._held >= self.capacity:
            base = max(base, self.last_busy_t) + \
                0.25 * (len(self._wait_q) + 1)
        return base

    def stats(self) -> Dict[str, float]:
        return {
            "requests": self.n_requests,
            "total_wait_s": round(self.total_wait, 6),
            "total_service_s": round(self.total_service, 6),
            "mean_wait_s": round(self.total_wait / max(self.n_requests, 1),
                                 6),
            "max_queue_depth": self.max_queue_depth,
            "max_in_system": self.max_in_system,
        }


class _BusyView:
    """Read-only mapping adapter (``.get(node, default)``) exposing a
    resource kind's earliest-free times to the placement planner.

    Autoscale-aware: when the pool records a *pending* capacity grow for
    the resource (a scale-up decided but still provisioning), the view
    projects availability at the provisioning ready time — a pool
    mid-scale-up is cheaper than its current queue depth suggests, so the
    planner keeps routing to it instead of stampeding the neighbors."""

    def __init__(self, pool: "ResourcePool", kind: str):
        self._pool = pool
        self._kind = kind

    def get(self, node: str, default: float = 0.0) -> float:
        res = self._pool.peek(self._kind, node)
        if res is None:
            return default
        nf = res.next_free()
        ready = self._pool.pending_grow_ready(res.name)
        return min(nf, ready) if ready is not None else nf


class ResourcePool:
    """All simulated resources of one engine, keyed by (kind, node)."""

    CPU, KVS = "cpu", "kvs"

    def __init__(self, cpu_capacity: Optional[Callable[[str], int]] = None):
        self._res: Dict[Tuple[str, str], SlotResource] = {}
        self._cpu_capacity = cpu_capacity or (lambda node: 1)
        # resource name -> provisioning ready time of an in-flight grow
        # (set/cleared by the autoscaler; read by the planner's busy view)
        self._pending_grow: Dict[str, float] = {}

    def peek(self, kind: str, node: str) -> Optional[SlotResource]:
        return self._res.get((kind, node))

    def _get(self, kind: str, node: str, capacity: int) -> SlotResource:
        key = (kind, node)
        res = self._res.get(key)
        if res is None:
            res = self._res[key] = SlotResource(f"{kind}:{node}", capacity)
        return res

    def cpu(self, node: str) -> SlotResource:
        # capacity is only consulted when the resource is first created,
        # so the callback (which may resolve a topology snapshot) is not
        # re-invoked on the per-admission hot path
        key = (self.CPU, node)
        res = self._res.get(key)
        if res is None:
            res = self._res[key] = SlotResource(
                f"{self.CPU}:{node}", self._cpu_capacity(node))
        return res

    def kvs(self, node: str) -> SlotResource:
        return self._get(self.KVS, node, 1)

    def busy_view(self, kind: str = CPU) -> _BusyView:
        return _BusyView(self, kind)

    # -- pending capacity grows (autoscaler provisioning model) ----------
    def note_pending_grow(self, name: str, ready_t: float) -> None:
        """Record that ``name`` has a capacity grow arriving at
        ``ready_t`` (simulated seconds)."""
        self._pending_grow[name] = ready_t

    def clear_pending_grow(self, name: str) -> None:
        self._pending_grow.pop(name, None)

    def pending_grow_ready(self, name: str) -> Optional[float]:
        return self._pending_grow.get(name)

    def resources(self, kind: Optional[str] = None):
        """All live resources (of one kind), in deterministic key order —
        the autoscaler's scan set."""
        return [res for (k, node), res in sorted(self._res.items())
                if kind is None or k == kind]

    def capacities(self, kind: Optional[str] = None) -> Dict[str, int]:
        return {res.name: res.capacity for res in self.resources(kind)}

    def queue_stats(self, kind: str = KVS) -> Dict[str, Dict[str, float]]:
        return {node: res.stats() for (k, node), res in sorted(
            self._res.items()) if k == kind}
