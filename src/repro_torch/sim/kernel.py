"""Discrete-event simulation kernel for the 3D-continuum simulator.

A ``SimKernel`` owns a simulated clock and an event heap.  Work is
expressed as *processes*: plain Python generators that ``yield`` either

* a non-negative float — sleep that many simulated seconds;
* ``("acquire", resource)`` — claim a ``SlotResource`` server, blocking
  FIFO until one frees up;
* ``("release", resource)`` — give the server back, waking the head
  waiter (the process itself continues at the same instant).

The kernel interleaves all live processes in global time order, which is
what turns N workflow instances into genuinely *concurrent* executions — a
process that sleeps through a storage transfer observes every queue
mutation other processes made in the meantime.

*Daemon* processes (``spawn(..., daemon=True)``) are periodic control
loops — e.g. the SLO-aware autoscaler — that must not keep the simulation
alive: ``run()`` returns as soon as only daemon events remain in the heap.
A daemon must not block on resources (it would be re-queued as a regular
process and pin the loop open).

Determinism rules (guarded, not assumed):

* No wall clock.  The kernel never reads ``time.*``; simulated time only
  advances by popping the heap.  Negative delays raise.
* Ties break on a monotonically increasing sequence number, so two runs
  with the same seed produce bit-identical event orders.
* With ``record_trace=True`` every event append is logged as
  ``(time, seq, label)``; two runs of the same seeded workload must produce
  identical traces (see ``tests/test_sim_kernel.py``).
* With ``race_detect=True`` a happens-before race sanitizer
  (``repro_torch.sim.races``) watches every ``note_access`` hook and reports
  conflicting same-timestamp accesses no spawn/wake/acquire-release edge
  orders — interleavings whose order rests on the ``seq`` tie-break alone.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Callable, Generator, List, Optional, Tuple, Union

Trace = List[Tuple[float, int, str]]

#: The effect ops a process may yield — the runtime protocol
#: ``_step_proc`` dispatches on.  databelt-lint's DB005 check pins its
#: ``AnalysisConfig.known_ops`` inventory to this tuple (equality test in
#: ``tests/test_races.py``; the lint stays importable without the sim's
#: numpy dependencies, so it cannot import this symbol directly).
KNOWN_EFFECT_OPS: Tuple[str, ...] = ("acquire", "release")


class SimKernel:
    """Event-heap scheduler driving generator processes in simulated time."""

    def __init__(self, start: float = 0.0,
                 record_trace: Union[bool, str] = False,
                 race_detect: bool = False):
        self.now = float(start)
        self._heap: list = []          # (time, seq, kind, payload, label,
                                       #  daemon)
        self._seq = 0
        self._live = 0                 # non-daemon events in the heap
        self.events_processed = 0
        # record_trace=True keeps the full (time, seq, label) list;
        # record_trace="hash" folds every entry into a streaming digest
        # instead (O(1) memory — the replay sanitizer's big-run mode).
        # Both feed ``trace_hash()`` with identical encodings, so a
        # hash-mode run can be compared against a recorded one.
        self.trace: Optional[Trace] = [] if record_trace is True else None
        self._hash = hashlib.blake2b(digest_size=16) \
            if record_trace == "hash" else None
        self._tracing = self.trace is not None or self._hash is not None
        # optional flight recorder (repro_torch.sim.trace.SpanRecorder):
        # attached by a traced run; every hook below is a single
        # ``is not None`` check so the disabled path allocates nothing
        self.recorder = None
        # optional happens-before race sanitizer (repro_torch.sim.races):
        # passive — it never schedules events, so a race-detected run is
        # event-for-event identical to the same run with it off.  Same
        # single ``is not None`` hook discipline as the recorder.
        self.races = None
        if race_detect:
            from repro_torch.sim.races import RaceDetector
            self.races = RaceDetector(self)

    def note_access(self, obj, field: str, mode: str) -> None:
        """Race-sanitizer hook: record a read (``mode="r"``) or write
        (``"w"``) of ``field`` on shared ``obj`` by the currently
        running process.  No-op unless ``race_detect=True``; call sites
        guard on ``kernel.races is not None`` to keep the disabled path
        at one attribute check."""
        if self.races is not None:
            self.races.note(obj, field, mode)

    def _note(self, t: float, seq: int, label: str) -> None:
        if self.trace is not None:
            self.trace.append((t, seq, label))
        else:
            self._hash.update(f"{t!r}|{seq}|{label}\n".encode())

    def trace_hash(self) -> Optional[str]:
        """Digest of the event trace so far (hex).  Identical encoding
        for both trace modes; None when tracing is off."""
        if self.trace is not None:
            h = hashlib.blake2b(digest_size=16)
            for t, seq, label in self.trace:
                h.update(f"{t!r}|{seq}|{label}\n".encode())
            return h.hexdigest()
        if self._hash is not None:
            return self._hash.hexdigest()
        return None

    # -- scheduling ------------------------------------------------------
    def _push(self, t: float, kind: str, payload, label: str,
              daemon: bool = False):
        if t < self.now - 1e-12:
            raise ValueError(
                f"event scheduled in the past: t={t} < now={self.now}")
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload, label,
                                    daemon))
        if not daemon:
            self._live += 1
        if self.races is not None:
            # spawn/wake/call HB edge: the new event inherits the
            # scheduling context's history
            self.races.on_push(self._seq)
        if self._tracing:
            self._note(t, self._seq, f"schedule:{label}")

    def call_at(self, t: float, fn: Callable[[], None],
                label: str = "call") -> None:
        """Run ``fn()`` at absolute simulated time ``t`` (deferred event —
        e.g. an async global-replication write arriving at the cloud KVS)."""
        self._push(max(t, self.now), "call", fn, label)

    def call_later(self, delay: float, fn: Callable[[], None],
                   label: str = "call") -> None:
        self.call_at(self.now + delay, fn, label)

    def spawn(self, proc: Generator, label: str = "proc",
              at: Optional[float] = None, daemon: bool = False) -> None:
        """Register a process generator; it first runs at ``at`` (default:
        now).  The generator yields non-negative delays in seconds.
        ``daemon`` processes never keep ``run()`` alive on their own."""
        t = self.now if at is None else at
        self._push(t, "proc", proc, label, daemon=daemon)

    def wake(self, proc: Generator, label: str = "proc") -> None:
        """Re-schedule a process that was parked outside the heap (a
        resource waiter admitted by a capacity grow) at the current time."""
        self._push(self.now, "proc", proc, label)

    def log(self, label: str) -> None:
        """Record a named point-event in the trace at the current time."""
        if self._tracing:
            self._seq += 1
            self._note(self.now, self._seq, label)

    # -- driving ---------------------------------------------------------
    def _step_proc(self, proc: Generator, label: str, daemon: bool = False):
        try:
            item = next(proc)
        except StopIteration:
            if self.races is not None:
                self.races.on_proc_exit(proc)
            return
        if isinstance(item, tuple):
            op, res = item
            if daemon:
                # a parked daemon would be re-pushed as a live process on
                # wake and pin run() open forever — fail loudly instead
                raise ValueError(
                    f"daemon process {label!r} must not block on "
                    f"resources (yielded {op!r})")
            rec = self.recorder
            if op == "acquire":
                if res.hold(self.now):
                    if self._tracing:
                        self.log(f"grant:{label}@{res.name}")
                    if rec is not None:
                        rec.instant("grant", "kernel", res.name,
                                    proc=label)
                    self._push(self.now, "proc", proc, label, daemon=daemon)
                    if self.races is not None:
                        # acquire→release edge: the grant inherits every
                        # prior releaser's history on this resource
                        self.races.join_resource(self._seq, res)
                else:
                    res.enqueue_waiter(proc, label, self.now)
                    if self._tracing:
                        self.log(f"wait:{label}@{res.name}")
                    if rec is not None:
                        rec.instant("wait", "kernel", res.name,
                                    proc=label)
                return
            if op == "release":
                if self._tracing:
                    self.log(f"free:{label}@{res.name}")
                if rec is not None:
                    rec.instant("free", "kernel", res.name, proc=label)
                if self.races is not None:
                    # publish the releaser's history to the next grantee
                    self.races.on_release(res)
                woken = res.unhold(self.now)
                if woken is not None:
                    wproc, wlabel, waited = woken
                    if self._tracing:
                        self.log(f"grant:{wlabel}@{res.name}")
                    if rec is not None:
                        if waited > 0.0:
                            rec.complete("slot_wait", "kernel", res.name,
                                         self.now - waited, self.now,
                                         proc=wlabel)
                        rec.instant("grant", "kernel", res.name,
                                    proc=wlabel)
                    self._push(self.now, "proc", wproc, wlabel)
                    if self.races is not None:
                        self.races.join_resource(self._seq, res)
                self._push(self.now, "proc", proc, label, daemon=daemon)
                return
            raise ValueError(f"process {label!r} yielded unknown op "
                             f"{op!r} — the kernel only understands "
                             f"{KNOWN_EFFECT_OPS}")
        delay = 0.0 if item is None else float(item)
        if delay < 0.0:
            raise ValueError(f"process {label!r} yielded negative delay "
                             f"{delay}")
        self._push(self.now + delay, "proc", proc, label, daemon=daemon)

    def run(self, until: Optional[float] = None) -> float:
        """Pop events in (time, seq) order until only daemon events remain
        (or simulated time passes ``until``).  Returns the final clock.

        With ``until`` given, the clock always advances to the end of the
        window: ``now == max(now, until)`` on return even when no event
        fires at ``until`` exactly.  (Pre-fix the clock stuck at the last
        *fired* event, so daemons sampling "time at end of window"
        observed a stale clock — pinned in ``tests/test_sim_kernel.py``.)

        The loop body is the simulator's hottest path (one iteration per
        event; a 100k-instance run is several million events), so locals
        are bound once and the no-trace fast path skips all formatting.
        """
        heap = self._heap
        pop = heapq.heappop
        rec = self.recorder
        races = self.races
        while heap and self._live > 0:
            if until is not None and heap[0][0] > until:
                break
            t, seq, kind, payload, label, daemon = pop(heap)
            if not daemon:
                self._live -= 1
            if t > self.now:
                self.now = t
            elif t < self.now - 1e-12:
                raise AssertionError("event heap went backwards")
            self.events_processed += 1
            if races is not None:
                races.on_fire(seq, kind, payload, label)
            if self._tracing:
                self._note(self.now, seq, f"fire:{label}")
            if daemon and rec is not None:
                rec.instant("daemon-wake", "kernel", label)
            if kind == "proc":
                self._step_proc(payload, label, daemon)
            else:
                payload()
        if until is not None and until > self.now:
            self.now = until
        return self.now
