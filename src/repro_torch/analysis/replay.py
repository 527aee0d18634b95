"""Runtime replay sanitizer: run a scenario twice, pinpoint the first
divergent event.

The golden tests can only say "replay broke"; this module says *where*.
``diff_traces`` compares two kernel event traces entry by entry and
reports the first divergence as (index, simulated time, label, payload
digest) per side, plus the digest of the common prefix — enough to
bisect which process injected the nondeterminism.  ``verify_scenario``
(the engine behind ``Scenario.verify_replay()``) drives two fresh runs
of the same spec with tracing on and also cross-checks the metric
vectors.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

TraceEntry = Tuple[float, int, str]


def digest_entries(entries: Sequence[TraceEntry]) -> str:
    """Stable digest of a trace (prefix); the same encoding
    ``SimKernel.trace_hash`` uses, so a hash-mode run and a recorded
    trace agree."""
    h = hashlib.blake2b(digest_size=16)
    for t, seq, label in entries:
        h.update(f"{t!r}|{seq}|{label}\n".encode())
    return h.hexdigest()


@dataclass
class Divergence:
    """The first event where two replays of one spec disagree."""
    index: int                       # position in the event trace
    time_a: Optional[float]
    time_b: Optional[float]
    label_a: Optional[str]
    label_b: Optional[str]
    digest_a: Optional[str]          # digest of the divergent entry
    digest_b: Optional[str]
    prefix_digest: str               # digest of the agreed prefix

    def describe(self) -> str:
        def side(t, label, d):
            if label is None:
                return "<trace ended>"
            return f"t={t:.6f} {label} [{d}]"
        return (f"first divergent event at index {self.index}: "
                f"run A {side(self.time_a, self.label_a, self.digest_a)}"
                f" vs run B "
                f"{side(self.time_b, self.label_b, self.digest_b)} "
                f"(common prefix {self.index} events, "
                f"digest {self.prefix_digest})")


@dataclass
class ReplayCheck:
    """Outcome of running one spec twice."""
    ok: bool
    events_a: int
    events_b: int
    trace_digest: str                # full-trace digest of run A
    divergence: Optional[Divergence] = None
    metrics_match: bool = True
    notes: List[str] = field(default_factory=list)

    def describe(self) -> str:
        if self.ok:
            return (f"replay OK: {self.events_a} events, trace digest "
                    f"{self.trace_digest}")
        parts = [f"replay DIVERGED ({self.events_a} vs {self.events_b} "
                 f"events)"]
        if self.divergence is not None:
            parts.append(self.divergence.describe())
        parts.extend(self.notes)
        return "\n".join(parts)


def _entry_digest(e: TraceEntry) -> str:
    return digest_entries([e])


def diff_traces(a: Sequence[TraceEntry],
                b: Sequence[TraceEntry]) -> Optional[Divergence]:
    """First entry where the traces differ, or None when identical."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return Divergence(
                index=i,
                time_a=a[i][0], time_b=b[i][0],
                label_a=a[i][2], label_b=b[i][2],
                digest_a=_entry_digest(a[i]),
                digest_b=_entry_digest(b[i]),
                prefix_digest=digest_entries(a[:i]))
    if len(a) != len(b):
        longer, which = (a, "a") if len(a) > len(b) else (b, "b")
        e = longer[n]
        return Divergence(
            index=n,
            time_a=e[0] if which == "a" else None,
            time_b=e[0] if which == "b" else None,
            label_a=e[2] if which == "a" else None,
            label_b=e[2] if which == "b" else None,
            digest_a=_entry_digest(e) if which == "a" else None,
            digest_b=_entry_digest(e) if which == "b" else None,
            prefix_digest=digest_entries(a[:n]))
    return None


# differs from repro/analysis/replay.py:112: the device of real compute
def verify_scenario(scenario, *, device="cuda") -> ReplayCheck:
    """Run ``scenario`` twice (fresh engine each run, tracing forced on)
    and localize any divergence.  The scenario is not mutated.
    ``device`` goes to ``Scenario.run``: it binds the flood bodies of a
    ``real_compute`` spec; a virtual spec touches no device."""
    traced = scenario.replace(record_trace=True)
    # differs from repro/analysis/replay.py:116-117: run(device=)
    ra = traced.run(device=device)
    rb = traced.run(device=device)
    ta, tb = ra.trace or [], rb.trace or []
    div = diff_traces(ta, tb)
    notes: List[str] = []
    lat_match = ra.latencies == rb.latencies
    if not lat_match:
        notes.append("metric vectors differ (latencies)")
    if div is None and not lat_match:
        notes.append("traces identical but metrics differ — "
                     "nondeterminism lives outside traced events "
                     "(metric bookkeeping?)")
    return ReplayCheck(
        ok=div is None and lat_match,
        events_a=len(ta), events_b=len(tb),
        trace_digest=digest_entries(ta),
        divergence=div,
        metrics_match=lat_match,
        notes=notes)
