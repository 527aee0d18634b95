"""Flight recorder: deterministic span tracing + metric registry.

The paper's headline claims are latency *attributions* — where an
instance's time went (queue wait vs transfer vs fetch vs execute vs
offload), which storage tier served a read, what the autoscaler and the
fault injector were doing at that moment.  ``SpanRecorder`` captures
exactly that as a span/event stream:

* **spans** — named intervals with parent/child links, a category
  (``instance`` / ``phase`` / ``storage`` / ``kernel``), a *track* (the
  Perfetto lane: ``inst:<wid>`` for instance lanes, a resource or node
  name for infrastructure) and key-value attrs.
* **instants** — zero-duration markers (resource grant/wait/free,
  daemon wakes, autoscale resizes, fault drains/link losses).
* **metrics** — a ``MetricRegistry`` of named counters and O(1)
  count/sum/min/max histograms fed alongside the spans.

Contracts (enforced by ``tests/test_trace.py``):

* **Off by default, near-zero cost.**  Producers hold a ``recorder``
  attribute that is ``None`` unless a run opted in; every emission site
  is a single ``is not None`` check and the disabled path allocates
  nothing (the fig16 100k-instance yardstick must hold).
* **Sim-clock timestamps only.**  A recorder is ``bind()``-bound to a
  ``SimKernel`` and reads ``kernel.now``; it never touches ``time.*``
  (databelt-lint DB008 guards every emission call site).
* **Replay-deterministic.**  Span ids are a plain counter, emission
  order is event order, and no wall-clock or address-dependent value is
  recorded — two runs of the same seeded ``Scenario`` produce
  bit-identical streams (``TraceReport.to_events()`` equality),
  including under ``FaultPlan`` churn.

``TraceReport`` (the frozen result) adds ``breakdown()`` — per-phase
latency attribution and SLO-miss blame — and ``export_perfetto(path)``
emitting Chrome-trace JSON loadable in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: span categories the stack emits (open set — these are the built-ins)
CATEGORIES = ("instance", "phase", "storage", "kernel", "autoscale",
              "fault")


@dataclass(slots=True)
class Span:
    """A named interval on one track; ``t_end < 0`` marks a still-open
    span (closed by ``SpanRecorder.end`` or at ``report()`` time)."""
    span_id: int
    parent_id: Optional[int]
    name: str
    category: str
    track: str
    t_start: float
    t_end: float = -1.0
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(self.t_end - self.t_start, 0.0)


@dataclass(slots=True)
class Instant:
    """A zero-duration marker on one track."""
    name: str
    category: str
    track: str
    t: float
    attrs: Dict[str, object] = field(default_factory=dict)


class Counter:
    """Monotonic named counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n


class Histogram:
    """O(1) count/sum/min/max summary — no samples retained, so a 100k
    fleet's latencies fold into four numbers."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricRegistry:
    """Named counters + histograms; instruments are created on first use
    and snapshots are key-sorted (deterministic serialization)."""

    __slots__ = ("_counters", "_histograms")

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "histograms": {k: {"count": h.count, "sum": h.sum,
                               "min": h.min if h.count else 0.0,
                               "max": h.max if h.count else 0.0,
                               "mean": h.mean}
                           for k, h in sorted(self._histograms.items())},
        }


class SpanRecorder:
    """The live collector one traced run writes into.

    Bound to a kernel for timestamps (``bind``); producers check their
    ``recorder`` attribute for ``None`` before every call, so a disabled
    run never reaches this class.  Span ids are a plain counter — the
    id *is* the emission order, which makes the stream replay-diffable.
    """

    __slots__ = ("spans", "instants", "metrics", "_clock", "_open",
                 "_next_id")

    def __init__(self):
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self.metrics = MetricRegistry()
        self._clock = None            # object with a ``.now`` (SimKernel)
        self._open: Dict[int, Span] = {}
        self._next_id = 0

    def bind(self, kernel) -> "SpanRecorder":
        """Point timestamps at ``kernel.now`` (re-bindable: a sequential
        Scenario shares one recorder across per-instance kernels)."""
        self._clock = kernel
        return self

    def _now(self, t: Optional[float]) -> float:
        if t is not None:
            return t
        return self._clock.now if self._clock is not None else 0.0

    # -- emission --------------------------------------------------------
    def begin(self, name: str, category: str, track: str,
              parent: Optional[int] = None, t: Optional[float] = None,
              **attrs) -> int:
        """Open a span; returns its id for ``end``/child linking."""
        self._next_id += 1
        span = Span(self._next_id, parent, name, category, track,
                    self._now(t), attrs=attrs)
        self.spans.append(span)
        self._open[span.span_id] = span
        return span.span_id

    def end(self, span_id: int, t: Optional[float] = None,
            **attrs) -> None:
        """Close an open span, merging any extra attrs."""
        span = self._open.pop(span_id)
        span.t_end = self._now(t)
        if attrs:
            span.attrs.update(attrs)

    def complete(self, name: str, category: str, track: str,
                 t0: float, t1: float, parent: Optional[int] = None,
                 **attrs) -> int:
        """Record an already-finished interval in one call."""
        self._next_id += 1
        self.spans.append(Span(self._next_id, parent, name, category,
                               track, t0, t1, attrs))
        return self._next_id

    def instant(self, name: str, category: str, track: str,
                t: Optional[float] = None, **attrs) -> None:
        self.instants.append(Instant(name, category, track,
                                     self._now(t), attrs))

    # -- results ---------------------------------------------------------
    def report(self) -> "TraceReport":
        """Freeze the stream: spans still open close at the current
        clock (deterministic — dict preserves insertion order)."""
        now = self._now(None)
        for span in self._open.values():
            span.t_end = max(now, span.t_start)
        self._open.clear()
        return TraceReport(spans=list(self.spans),
                           instants=list(self.instants),
                           metrics=self.metrics.snapshot())


def _json_safe(v):
    """JSON rejects inf/NaN (a missing-state read records latency=inf);
    stringify non-finite floats so strict loaders accept the export."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


@dataclass
class TraceReport:
    """Frozen result of one traced run: the span/instant streams plus a
    metrics snapshot, with the two consumers the benchmarks need —
    per-phase latency attribution and Perfetto export."""

    spans: List[Span] = field(default_factory=list)
    instants: List[Instant] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    # -- determinism surface ---------------------------------------------
    def to_events(self) -> list:
        """The stream as plain comparable tuples — the replay-diff
        surface (two runs of the same spec must compare equal)."""
        out = [("span", s.span_id, s.parent_id, s.name, s.category,
                s.track, s.t_start, s.t_end,
                tuple(sorted(s.attrs.items())))
               for s in self.spans]
        out += [("instant", i.name, i.category, i.track, i.t,
                 tuple(sorted(i.attrs.items())))
                for i in self.instants]
        return out

    # -- latency attribution ---------------------------------------------
    def breakdown(self) -> dict:
        """Attribute every traced instance's wall time to its phases.

        Returns ``per_phase_s`` (fleet totals per phase name),
        ``instances`` (per-root wall/attributed seconds, coverage
        fraction, dominant phase), ``min_fraction`` (the coverage
        floor — the engine's phase spans must cover >=95% of each
        instance), and ``slo_blame``: for every instance with SLO
        violations, one count against its *dominant* phase — the
        "where did the miss come from" answer."""
        phase_children: Dict[int, Dict[str, float]] = {}
        for s in self.spans:
            if s.category == "phase" and s.parent_id is not None:
                bucket = phase_children.setdefault(s.parent_id, {})
                bucket[s.name] = bucket.get(s.name, 0.0) + s.duration
        per_phase: Dict[str, float] = {}
        instances = []
        blame: Dict[str, int] = {}
        min_fraction = 1.0
        for root in self.spans:
            if root.category != "instance":
                continue
            wall = root.duration
            phases = phase_children.get(root.span_id, {})
            attributed = sum(phases.values())
            for name, secs in phases.items():
                per_phase[name] = per_phase.get(name, 0.0) + secs
            # ties break on sorted phase name — deterministic
            dominant = max(sorted(phases), key=phases.get) \
                if phases else ""
            fraction = attributed / wall if wall > 0 else 1.0
            min_fraction = min(min_fraction, fraction)
            violations = int(root.attrs.get("slo_violations", 0))
            instances.append({
                "instance": root.name,
                "wall_s": wall,
                "attributed_s": attributed,
                "fraction": fraction,
                "dominant_phase": dominant,
                "slo_violations": violations,
            })
            if violations > 0 and dominant:
                blame[dominant] = blame.get(dominant, 0) + 1
        return {
            "per_phase_s": {k: per_phase[k] for k in sorted(per_phase)},
            "instances": instances,
            "min_fraction": min_fraction,
            "slo_blame": {k: blame[k] for k in sorted(blame)},
        }

    # -- Perfetto / chrome://tracing export ------------------------------
    def export_perfetto(self, path: Optional[str] = None) -> dict:
        """Chrome-trace JSON: one pid per track (node tracks + one lane
        per instance), ``X`` complete events for spans, ``i`` instants,
        ``M`` metadata naming each track.  Timestamps are simulated
        seconds scaled to microseconds.  Returns the document; writes it
        to ``path`` when given."""
        pids: Dict[str, int] = {}

        def pid(track: str) -> int:
            p = pids.get(track)
            if p is None:
                p = pids[track] = len(pids) + 1
            return p

        events = []
        for s in self.spans:
            events.append({
                "name": s.name, "cat": s.category, "ph": "X",
                "pid": pid(s.track), "tid": 1,
                "ts": s.t_start * 1e6, "dur": s.duration * 1e6,
                "args": {k: _json_safe(v)
                         for k, v in sorted(s.attrs.items())},
            })
        for i in self.instants:
            events.append({
                "name": i.name, "cat": i.category, "ph": "i", "s": "t",
                "pid": pid(i.track), "tid": 1, "ts": i.t * 1e6,
                "args": {k: _json_safe(v)
                         for k, v in sorted(i.attrs.items())},
            })
        meta = [{"name": "process_name", "ph": "M", "pid": p, "tid": 1,
                 "args": {"name": track}}
                for track, p in pids.items()]
        doc = {"traceEvents": meta + events,
               "displayTimeUnit": "ms",
               "otherData": {"metrics": self.metrics}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
