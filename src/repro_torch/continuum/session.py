"""StateSession: the one storage surface the workflow engine speaks.

Databelt's core claim is a *single continuous data path* — the engine
should not care whether a state access is paid for with committed-schedule
queue accounting or as parked-waiter kernel events.  ``StateSession`` is a
per-instance facade over ``TwoTierStorage`` exposing exactly three
kernel-yieldable operations::

    session = StateSession(storage, kernel)          # event-driven default
    r        = yield from session.put(key, size, writer=node)
    st, r    = yield from session.get(key, reader)
    sts, r   = yield from session.get_fused(keys, reader)

The analytic-vs-event-driven distinction is a constructor **mode**:

* ``mode="event"`` (default) — ops park on the per-node KVS FIFOs as
  held-slot waiters (like CPU slots) and consume real simulated time, so
  an autoscale capacity grow re-admits the already-queued backlog.
* ``mode="analytic"`` — ops commit their queue slots at enqueue via
  ``SlotResource.request`` and consume **no** simulated time; the caller
  reads ``AccessResult.latency`` and decides what to sleep.  This is the
  pre-event-driven engine pinned bit-identically (the opt-out path).

Both modes drive the same internal operation path in
``TwoTierStorage`` (``_op_put``/``_op_get``/``_op_get_fused``) — the mode
only chooses the op clock.  Every op is a generator in both modes (the
analytic ones simply never yield), so engine code is mode-free: one
``yield from`` per state touch, no branching.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.continuum.storage import (TwoTierStorage, _AnalyticClock,
                                     _EventClock)
from repro_torch.core.keys import StateKey

MODES = ("event", "analytic")


class StateSession:
    """Per-instance storage facade bound to a kernel and a queueing mode."""

    def __init__(self, storage: TwoTierStorage, kernel=None,
                 mode: str = "event"):
        if mode not in MODES:
            raise ValueError(f"unknown StateSession mode {mode!r}; "
                             f"choose one of {MODES}")
        if mode == "event" and kernel is None:
            raise ValueError("event-driven StateSession needs a kernel")
        self.storage = storage
        self.kernel = kernel
        self.mode = mode
        # flight-recorder parent span: the engine points this at the
        # current phase span so storage-op spans nest under it.  Only
        # consulted when storage.recorder is attached.
        self.trace_parent = None

    def _clock(self):
        if self.mode == "event":
            return _EventClock(self.storage, self.kernel)
        t = self.kernel.now if self.kernel is not None else 0.0
        return _AnalyticClock(self.storage, t, kernel=self.kernel)

    # -- the three state touchpoints -------------------------------------
    def put(self, key: StateKey, size: float, *,
            writer: Optional[str] = None, global_sync: bool = False,
            account: bool = True, replicate_global: bool = True,
            payload=None):
        """Write ``size`` bytes from ``writer`` to ``key.storage_address``
        (plus the global-tier replica fan-out).  ``global_sync`` puts the
        primary cloud replica on the critical path (the stateless
        baseline's durability cost); ``account=False`` registers the key
        without charging any queue (fused groups registering their
        already-merged outgoing keys)."""
        clock = self._clock()
        gen = self.storage._op_put(
            key, size, payload, clock, writer_node=writer,
            replicate_global=replicate_global, global_sync=global_sync,
            account=account)
        # account=False puts are bookkeeping (no queue, no time): not a
        # storage op worth a span
        if self.storage.recorder is None or not account:
            return gen
        return self._traced("put", gen, clock, bytes=size,
                            writer=writer or key.storage_address,
                            global_sync=global_sync)

    def get(self, key: StateKey, reader: str):
        """Resolve ``key`` from ``reader``: reader-local → holder node →
        global tier (home shard, then cross-region with read-repair)."""
        clock = self._clock()
        gen = self.storage._op_get(key, reader, clock)
        if self.storage.recorder is None:
            return gen
        return self._traced("get", gen, clock, reader=reader)

    def get_fused(self, keys, reader: str):
        """Grouped retrieval for a fusion group: one request per source
        node (paper §4.2) instead of one per function."""
        clock = self._clock()
        gen = self.storage._op_get_fused(keys, reader, clock)
        if self.storage.recorder is None:
            return gen
        return self._traced("get_fused", gen, clock, reader=reader,
                            n_keys=len(keys))

    def _traced(self, op: str, gen, clock, **attrs):
        """Wrap one storage-op generator in a span: drives the op
        unchanged (``yield from`` passes every kernel effect through)
        and records tier / queue-wait / service / bytes attribution from
        its ``AccessResult``.  Only ever constructed when a recorder is
        attached — the untraced path returns the raw op generator."""
        rec = self.storage.recorder
        t0 = clock.now
        out = yield from gen
        r = out[1] if isinstance(out, tuple) else out
        rec.complete(op, "storage", r.node or op, t0, clock.now,
                     parent=self.trace_parent, tier=r.tier,
                     hops=r.hops, latency_s=r.latency,
                     network_latency_s=r.network_latency,
                     queue_wait_s=r.queue_wait_s,
                     service_s=r.service_s,
                     global_keys=r.global_keys, **attrs)
        mr = rec.metrics
        mr.counter(f"storage.{op}.ops").add(1)
        mr.counter(f"storage.tier.{r.tier or 'unknown'}").add(1)
        if math.isfinite(r.latency):
            mr.histogram(f"storage.{op}.latency_s").observe(r.latency)
            mr.histogram("storage.queue_wait_s").observe(r.queue_wait_s)
        return out

    # -- pure peeks (no queue mutation, no time) --------------------------
    def peek_network_latency(self, key: StateKey, reader: str,
                             t: Optional[float] = None) -> float:
        """Network handoff cost (path latency + wire transfer) a read of
        ``key`` from ``reader`` would pay right now — the engine's SLO
        accounting signal.  Pure: consumes no KVS queue service time and
        never read-repairs."""
        st = self.storage
        now = t if t is not None else (
            self.kernel.now if self.kernel is not None else 0.0)
        graph = st.graph_fn(now)
        loc = st._locate(key, reader, graph)
        if loc is None:
            return math.inf
        stored, src, _ = loc
        lat, _ = st._transfer(graph, src, reader, stored.size)
        return 0.0 if src == reader else lat
