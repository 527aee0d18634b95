"""Aggregate metrics for concurrent simulation runs.

Two collection modes, one report type:

* **full** (default) — ``ParallelReport`` materializes every
  ``InstanceMetrics``; fleet percentiles are exact, computed from ONE
  sort of the latency list (vectorized through ``numpy`` above
  ``_NP_SORT_MIN`` elements, with interpolation arithmetic identical to
  the scalar path — bit-for-bit the same values).
* **aggregate** — for 100k+-instance scale runs: a ``FleetAggregate``
  folds each completing instance into O(1) running state (count/sum/
  min/max per metric plus P² streaming-quantile sketches for
  p50/p95/p99), so memory stays constant in the fleet size.  Count/sum
  statistics are bit-identical to the full mode on the same event
  order; sketch percentiles are approximations (see ``P2Quantile``),
  pinned within tolerance by ``tests/test_scale.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# below this, sorting through numpy costs more than it saves
_NP_SORT_MIN = 1024


def _percentile_sorted(xs, p: float) -> float:
    """Linear-interpolated percentile over an ALREADY-SORTED sequence.
    Exactly the arithmetic of the historical ``percentile`` (same ops,
    same association), so values are bit-identical regardless of whether
    the caller sorted with ``sorted`` or ``numpy``."""
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return float(xs[0])
    rank = (p / 100.0) * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(xs[lo]) * (1.0 - frac) + float(xs[hi]) * frac


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (p in [0, 100]); 0.0 on empty.

    Edge semantics (pinned in ``tests/test_scale.py``): ``p=0`` is the
    minimum, ``p=100`` the maximum, a single sample is every percentile
    of itself, and all-equal inputs return that value for every p."""
    if len(xs) >= _NP_SORT_MIN:
        return _percentile_sorted(np.sort(np.asarray(xs, dtype=float)), p)
    return _percentile_sorted(sorted(xs), p)


class P2Quantile:
    """P² streaming quantile estimator (Jain & Chlamtac, CACM 1985).

    Five markers track (min, q/2, q, (1+q)/2, max); each observation is
    O(1) and no samples are retained.  With fewer than five observations
    the estimate is the exact percentile of what has been seen.  The
    estimate converges to the true quantile for stationary streams; the
    scale benchmarks pin it within a few percent of exact on
    fig13-shaped latency distributions."""

    __slots__ = ("q", "count", "_boot", "_h", "_pos", "_des", "_inc")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"P2Quantile needs 0 < q < 1, got {q}")
        self.q = q
        self.count = 0
        self._boot: List[float] = []     # first five observations
        self._h: Optional[List[float]] = None   # marker heights
        self._pos: List[int] = []        # marker positions (1-based)
        self._des: List[float] = []      # desired positions
        self._inc = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.count += 1
        if self._h is None:
            self._boot.append(x)
            if len(self._boot) == 5:
                self._boot.sort()
                self._h = list(self._boot)
                self._pos = [1, 2, 3, 4, 5]
                q = self.q
                self._des = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                             3.0 + 2.0 * q, 5.0]
            return
        h, pos, des = self._h, self._pos, self._des
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1
        for i in range(5):
            des[i] += self._inc[i]
        for i in (1, 2, 3):
            d = des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1):
                d = 1 if d > 0 else -1
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:        # parabolic estimate left the bracket: linear
                    h[i] = h[i] + d * (h[i + d] - h[i]) / (pos[i + d]
                                                           - pos[i])
                pos[i] += d

    def _parabolic(self, i: int, d: int) -> float:
        h, n = self._h, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def value(self) -> float:
        if self._h is None:
            return percentile(self._boot, self.q * 100.0)
        return self._h[2]


@dataclass
class FleetAggregate:
    """O(1)-memory running aggregate of a fleet of ``InstanceMetrics``.

    ``observe(m, start, end)`` folds one completed instance in; integer
    counters and min/max/makespan are then exactly what the materialized
    list would produce, float sums agree up to summation order (folded in
    completion order rather than instance-index order), and latency
    percentiles come from P² sketches instead of a stored list.
    This is what lets ``run_parallel(collect="aggregate")`` hold a
    100k–1M instance run in constant memory."""

    count: int = 0
    latency_sum: float = 0.0
    latency_min: float = 0.0
    latency_max: float = 0.0
    read_time_sum: float = 0.0
    write_time_sum: float = 0.0
    compute_time_sum: float = 0.0
    reads: int = 0
    local_reads: int = 0
    global_reads: int = 0
    hops_sum: int = 0
    hops_n: int = 0
    slo_violations: int = 0
    handoffs: int = 0
    storage_ops: int = 0
    first_start: float = 0.0
    last_end: float = 0.0
    sketches: Dict[int, P2Quantile] = field(
        default_factory=lambda: {50: P2Quantile(0.50),
                                 95: P2Quantile(0.95),
                                 99: P2Quantile(0.99)})

    def observe(self, m, start: float, end: float) -> None:
        lat = m.latency
        if self.count == 0:
            self.latency_min = self.latency_max = lat
            self.first_start, self.last_end = start, end
        else:
            self.latency_min = min(self.latency_min, lat)
            self.latency_max = max(self.latency_max, lat)
            self.first_start = min(self.first_start, start)
            self.last_end = max(self.last_end, end)
        self.count += 1
        self.latency_sum += lat
        self.read_time_sum += m.read_time
        self.write_time_sum += m.write_time
        self.compute_time_sum += m.compute_time
        self.reads += m.reads
        self.local_reads += m.local_reads
        self.global_reads += m.global_reads
        self.hops_sum += sum(m.hops)
        self.hops_n += len(m.hops)
        self.slo_violations += m.slo_violations
        self.handoffs += m.handoffs
        self.storage_ops += m.storage_ops
        for sk in self.sketches.values():
            sk.add(lat)

    # -- fleet statistics ------------------------------------------------
    @property
    def mean_latency(self) -> float:
        return self.latency_sum / self.count if self.count else 0.0

    @property
    def makespan(self) -> float:
        return max(self.last_end - self.first_start, 0.0)

    @property
    def local_availability(self) -> float:
        return self.local_reads / max(self.reads, 1)

    @property
    def mean_hops(self) -> float:
        return self.hops_sum / max(self.hops_n, 1)

    def quantile(self, p: int) -> float:
        return self.sketches[p].value() if p in self.sketches else 0.0


@dataclass
class ParallelReport:
    """Result of a concurrent driver run: per-instance metrics plus the
    fleet-level numbers the paper reports (throughput, tail latency) and
    per-node queue statistics from the resource pool.

    Indexing/iteration delegate to ``instances`` so existing callers that
    treated ``run_parallel``'s result as a list keep working.  In
    aggregate mode (``collect="aggregate"``) ``instances`` is empty and
    ``aggregate`` carries the fleet statistics; ``len()``, percentiles,
    throughput and ``mean_latency`` work identically in both modes."""

    instances: List = field(default_factory=list)
    start_times: List[float] = field(default_factory=list)
    end_times: List[float] = field(default_factory=list)
    makespan: float = 0.0
    throughput_rps: float = 0.0
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    kvs_queues: Dict[str, Dict[str, float]] = field(default_factory=dict)
    cpu_queues: Dict[str, Dict[str, float]] = field(default_factory=dict)
    events_processed: int = 0
    trace: Optional[list] = None
    # AutoscaleReport when the run had an autoscaler attached, else None
    autoscale: Optional[object] = None
    # FaultReport when the run had a fault injector attached, else None
    faults: Optional[object] = None
    # FleetAggregate when the run collected aggregates instead of
    # materialized per-instance metrics, else None
    aggregate: Optional[FleetAggregate] = None
    # repro_torch.sim.trace.TraceReport when the run had the flight recorder
    # attached (trace=...), else None
    trace_report: Optional[object] = None
    # list of repro_torch.sim.races.RaceReport when the run had the race
    # sanitizer attached (race_detect=True): empty = race-clean; None =
    # detection was off
    races: Optional[list] = None

    @property
    def race_clean(self) -> bool:
        """True when the race sanitizer ran and found nothing.  False
        both when races were found and when detection was off (an
        unverified run must not pass a race gate)."""
        return self.races is not None and not self.races

    @property
    def n_instances(self) -> int:
        if self.aggregate is not None:
            return self.aggregate.count
        return len(self.instances)

    @property
    def latencies(self) -> List[float]:
        return [m.latency for m in self.instances]

    @property
    def mean_latency(self) -> float:
        if self.aggregate is not None:
            return self.aggregate.mean_latency
        ls = self.latencies
        return sum(ls) / len(ls) if ls else 0.0

    @property
    def global_fallback_rate(self) -> float:
        """Share of all reads served by the global tier — the fleet's
        churn-observability signal.  A ratio of integer *sums* (not the
        mean of per-instance rates), so full and aggregate collect modes
        agree exactly."""
        if self.aggregate is not None:
            return self.aggregate.global_reads / max(
                self.aggregate.reads, 1)
        greads = sum(m.global_reads for m in self.instances)
        reads = sum(m.reads for m in self.instances)
        return greads / max(reads, 1)

    def max_kvs_depth(self, node: str) -> int:
        return int(self.kvs_queues.get(node, {}).get("max_queue_depth", 0))

    @classmethod
    def build(cls, instances, start_times, end_times, pool=None,
              events_processed: int = 0, trace=None,
              autoscale=None, faults=None,
              trace_report=None, races=None) -> "ParallelReport":
        lats = [m.latency for m in instances]
        t0 = min(start_times) if start_times else 0.0
        t1 = max(end_times) if end_times else 0.0
        makespan = max(t1 - t0, 0.0)
        # ONE sort serves p50/p95/p99 (the old path re-sorted per call)
        if len(lats) >= _NP_SORT_MIN:
            s = np.sort(np.asarray(lats, dtype=float))
        else:
            s = sorted(lats)
        return cls(
            instances=list(instances),
            start_times=list(start_times),
            end_times=list(end_times),
            makespan=makespan,
            throughput_rps=len(instances) / makespan if makespan > 0
            else 0.0,
            p50=_percentile_sorted(s, 50),
            p95=_percentile_sorted(s, 95),
            p99=_percentile_sorted(s, 99),
            kvs_queues=pool.queue_stats(pool.KVS) if pool else {},
            cpu_queues=pool.queue_stats(pool.CPU) if pool else {},
            events_processed=events_processed,
            trace=trace,
            autoscale=autoscale,
            faults=faults,
            trace_report=trace_report,
            races=races,
        )

    @classmethod
    def build_aggregate(cls, agg: FleetAggregate, pool=None,
                        events_processed: int = 0, trace=None,
                        autoscale=None, faults=None,
                        trace_report=None, races=None) -> "ParallelReport":
        """Fleet report from a running ``FleetAggregate`` — no
        per-instance lists, constant memory in the fleet size."""
        makespan = agg.makespan
        return cls(
            instances=[],
            makespan=makespan,
            throughput_rps=agg.count / makespan if makespan > 0 else 0.0,
            p50=agg.quantile(50),
            p95=agg.quantile(95),
            p99=agg.quantile(99),
            kvs_queues=pool.queue_stats(pool.KVS) if pool else {},
            cpu_queues=pool.queue_stats(pool.CPU) if pool else {},
            events_processed=events_processed,
            trace=trace,
            autoscale=autoscale,
            faults=faults,
            aggregate=agg,
            trace_report=trace_report,
            races=races,
        )

    # list-compat -------------------------------------------------------
    def __len__(self):
        return self.n_instances

    def __iter__(self):
        return iter(self.instances)

    def __getitem__(self, i):
        return self.instances[i]
