"""Happens-before race sanitizer for concurrent kernel processes.

databelt-lint's static DB010–DB013 checks flag race *shapes*; this module
is the runtime half: ``SimKernel(race_detect=True)`` attaches a
``RaceDetector`` that watches every ``kernel.note_access(obj, field,
mode)`` hook the simulator threads through shared state
(``TwoTierStorage`` buckets, the global tier, ``ContinuumNetwork``
topology overrides, ``SlotResource`` capacities, the autoscaler's
latency window) and reports conflicting accesses that the happens-before
order does not serialize.

The happens-before model (see ``src/repro/sim/README.md``):

* **event-heap time order** — the kernel pops events in ``(time, seq)``
  order and two runs of one seed replay identically, so accesses at
  *different* simulated times are ordered by the clock itself.  Only
  same-timestamp accesses can race: their relative order is decided by
  the ``seq`` tie-break, i.e. by incidental event *insertion* order,
  which is exactly what refactors and scheduling changes perturb.
* **spawn/wake edges** — everything a process did before ``spawn``-ing
  or ``wake``-ing another happens before everything the spawned/woken
  process does (deferred ``call_at`` closures inherit their creator's
  history the same way).
* **acquire→release edges** — a ``("release", res)`` publishes the
  releaser's history to the next process granted a slot on ``res``, so
  critical sections under one resource are ordered even inside one
  timestamp.

Within one process, segments (the spans between yields) are ordered by
program order.  The implementation is FastTrack-style: each scheduling
context carries a vector clock (dict ``ctx -> segment``), each access is
recorded as a single epoch ``(ctx, segment)``, and conflict checks are
one dict lookup.  Access tables are flushed whenever simulated time
advances — cross-timestamp pairs are ordered by the clock — which keeps
memory bounded by per-timestamp activity, not run length.

Everything is passive: detection never schedules events, so a run with
``race_detect=True`` is event-for-event identical to the same run with
it off (pinned in ``tests/test_races.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: stop accumulating after this many reports — a racy hot loop would
#: otherwise flood memory with one report per iteration
MAX_REPORTS = 64

_ROOT = 0   # ctx id of the scheduler itself (spawns made outside events)


@dataclass(frozen=True)
class RaceAccess:
    """One side of a conflicting pair."""
    event_index: int            # kernel.events_processed at access time
    time: float                 # simulated time of the access
    label: str                  # process/call label that made the access
    mode: str                   # "r" | "w"


@dataclass
class RaceReport:
    """Two conflicting accesses the happens-before order leaves
    unordered: their relative order is decided only by the event heap's
    ``seq`` tie-break and would not survive a scheduling perturbation."""
    obj: str                    # repr-ish identity of the shared object
    obj_field: str              # which field/key of it
    first: RaceAccess
    second: RaceAccess

    def describe(self) -> str:
        return (f"race on {self.obj}.{self.obj_field} at "
                f"t={self.second.time:.6f}: "
                f"{self.first.mode} by {self.first.label!r} "
                f"(event {self.first.event_index}) vs "
                f"{self.second.mode} by {self.second.label!r} "
                f"(event {self.second.event_index}) — unordered by "
                f"happens-before (seq tie-break only)")


class RaceDetector:
    """Vector-clock happens-before tracker driven by ``SimKernel``.

    The kernel calls ``on_push`` when it schedules an event (the new
    event inherits the scheduling context's history), ``on_fire`` when
    it pops one (establishing the current context), ``on_release`` /
    ``join_resource`` around slot handoffs, and ``note`` for every
    shared-state access.  All bookkeeping is reads + dict updates —
    never a kernel event — so detection cannot perturb the run."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.reports: List[RaceReport] = []
        # ctx id -> vector clock (ctx id -> latest segment seen)
        self._vc: Dict[int, Dict[int, int]] = {_ROOT: {_ROOT: 1}}
        # durable ctx ids for process generators (id(gen) is only unique
        # while the generator is alive, so keep a strong ref per ctx)
        self._ctx_of: Dict[int, int] = {}     # id(proc) -> ctx id
        self._pin: Dict[int, object] = {}     # ctx id -> proc (strong ref)
        self._next_ctx = 1
        # pending joins keyed by heap seq: VC snapshots the fired event
        # must merge (its creator's history, plus any resource handoff)
        self._pending: Dict[int, List[Dict[int, int]]] = {}
        # resource identity -> accumulated release history
        self._res_vc: Dict[int, Dict[int, int]] = {}
        self._res_pin: Dict[int, object] = {}
        # current context (set by on_fire; _ROOT outside any event)
        self._cur = _ROOT
        self._cur_label = "<root>"
        # same-timestamp access tables, flushed when time advances:
        # (id(obj), field) -> (last_write, reads-since-write)
        self._accesses: Dict[Tuple[int, str],
                             Tuple[Optional[Tuple[int, int, RaceAccess]],
                                   List[Tuple[int, int, RaceAccess]]]] = {}
        self._obj_pin: Dict[int, object] = {}
        self._table_t: float = float("nan")

    # -- kernel lifecycle hooks ------------------------------------------
    def _ctx_for(self, proc) -> int:
        cid = self._ctx_of.get(id(proc))
        if cid is None:
            self._next_ctx += 1
            cid = self._next_ctx
            self._ctx_of[id(proc)] = cid
            self._pin[cid] = proc
            self._vc[cid] = {cid: 0}
        return cid

    def on_push(self, seq: int) -> None:
        """A new heap event was scheduled from the current context: it
        inherits everything the scheduler has seen so far."""
        self._pending.setdefault(seq, []).append(
            dict(self._vc[self._cur]))

    def join_resource(self, seq: int, res) -> None:
        """The event at ``seq`` is a slot grant on ``res``: it also
        inherits the accumulated history of every release on ``res``
        (the acquire→release edge)."""
        # repro: allow(DB004): entries only exist for resources pinned
        # in _res_pin (on_release), so the id cannot have been recycled
        rvc = self._res_vc.get(id(res))
        if rvc:
            self._pending.setdefault(seq, []).append(dict(rvc))

    def on_release(self, res) -> None:
        """The current context released a slot on ``res``: publish its
        history to whichever process is granted the slot next."""
        rid = id(res)
        # repro: allow(DB004): _res_pin pins a strong ref under the same
        # id key on the next line, so the id cannot be recycled
        rvc = self._res_vc.setdefault(rid, {})
        self._res_pin[rid] = res
        for c, s in self._vc[self._cur].items():
            if rvc.get(c, -1) < s:
                rvc[c] = s

    def on_fire(self, seq: int, kind: str, payload, label: str) -> None:
        """An event was popped: establish the running context, merge any
        pending joins, and start a fresh segment (every fire is an
        interleaving point)."""
        if kind == "proc":
            cid = self._ctx_for(payload)
        else:
            # a deferred call is its own one-shot context
            self._next_ctx += 1
            cid = self._next_ctx
            self._vc[cid] = {cid: 0}
        vc = self._vc[cid]
        for joined in self._pending.pop(seq, ()):
            for c, s in joined.items():
                if vc.get(c, -1) < s:
                    vc[c] = s
        vc[cid] = vc.get(cid, 0) + 1          # new segment
        self._cur = cid
        self._cur_label = label

    def on_proc_exit(self, proc) -> None:
        """A generator ran to completion: drop its pin and vector clock
        (its history lives on in whatever it spawned/released into —
        ``on_push``/``on_release`` copy snapshots)."""
        # repro: allow(DB004): the caller still holds proc, and this pop
        # removes the pinned entry — ids free only after their entry does
        cid = self._ctx_of.pop(id(proc), None)
        if cid is not None:
            self._pin.pop(cid, None)
            self._vc.pop(cid, None)

    # -- the access hook --------------------------------------------------
    def note(self, obj, obj_field: str, mode: str) -> None:
        """Record one shared-state access by the current context and
        report a conflict with any same-timestamp access the
        happens-before order leaves unordered."""
        now = self.kernel.now
        if now != self._table_t:
            # time advanced: every earlier access is ordered by the clock
            self._accesses.clear()
            self._obj_pin.clear()
            self._table_t = now
        # repro: allow(DB004): _obj_pin pins a strong ref per id below;
        # the table is flushed every time simulated time advances
        key = (id(obj), obj_field)
        entry = self._accesses.get(key)
        if entry is None:
            entry = (None, [])
            self._obj_pin[id(obj)] = obj
        last_write, reads = entry
        cur = self._cur
        vc = self._vc[cur]
        acc = RaceAccess(event_index=self.kernel.events_processed,
                         time=now, label=self._cur_label, mode=mode)
        mine = (cur, vc[cur], acc)
        if mode == "w":
            if last_write is not None:
                self._check(obj, obj_field, last_write, mine, vc)
            for prior in reads:
                self._check(obj, obj_field, prior, mine, vc)
            self._accesses[key] = (mine, [])
        else:
            if last_write is not None:
                self._check(obj, obj_field, last_write, mine, vc)
            reads.append(mine)
            self._accesses[key] = (last_write, reads)

    def _check(self, obj, obj_field: str, prior, mine, vc) -> None:
        pctx, pseg, pacc = prior
        cctx = mine[0]
        # same context: program order.  Different context: the prior
        # access (which fired earlier within this timestamp) happens
        # before us iff our vector clock has caught up to its segment.
        if pctx == cctx or vc.get(pctx, -1) >= pseg:
            return
        if len(self.reports) >= MAX_REPORTS:
            return
        self.reports.append(RaceReport(
            obj=type(obj).__name__, obj_field=obj_field,
            first=pacc, second=mine[2]))

    # -- results ----------------------------------------------------------
    @property
    def ok(self) -> bool:
        return not self.reports

    def describe(self) -> str:
        if not self.reports:
            return "race-clean: no unordered conflicting accesses"
        lines = [f"{len(self.reports)} race(s) detected "
                 f"(first conflicting event localized per report):"]
        lines.extend(r.describe() for r in self.reports)
        return "\n".join(lines)
