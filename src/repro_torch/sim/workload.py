"""Workload generators for the concurrent driver.

Open-loop generators fix arrival times in advance (requests keep coming no
matter how the system is doing — the throughput-measurement regime of
paper Fig 13); the closed-loop generator models a fixed client pool where a
client only issues its next workflow after the previous one completed.

All randomness flows through a seeded ``random.Random`` so the same seed
reproduces the identical arrival sequence (and, through the kernel's
deterministic event order, the identical event trace).

For 100k+-instance scale runs the driver consumes arrivals through
``iter_arrivals(workload, n, start)``, which prefers a generator-based
``iter_arrivals`` method on the workload (batched/streaming generation —
no n-element list is ever materialized) and falls back to iterating the
materialized ``arrivals`` list.  A streaming generator must yield exactly
the values its ``arrivals`` would return (same arithmetic, same RNG
sequence) so the two paths are interchangeable.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple


def iter_arrivals(workload, n: int, start: float = 0.0):
    """Arrival times of ``workload`` as an iterator, streaming when the
    generator supports it (open-loop only; closed-loop workloads have no
    arrival schedule)."""
    gen = getattr(workload, "iter_arrivals", None)
    if gen is not None:
        return gen(n, start)
    return iter(workload.arrivals(n, start))


@dataclass
class UniformStagger:
    """Open loop: instance i arrives at ``start + i * stagger``."""
    stagger: float = 0.05
    closed = False

    def arrivals(self, n: int, start: float = 0.0) -> List[float]:
        return [start + i * self.stagger for i in range(n)]

    def iter_arrivals(self, n: int, start: float = 0.0) -> Iterator[float]:
        """Streaming ``arrivals`` — identical values, no list."""
        for i in range(n):
            yield start + i * self.stagger


@dataclass
class OpenLoopPoisson:
    """Open loop with exponential inter-arrival gaps (rate per second)."""
    rate: float = 10.0
    seed: int = 0
    closed = False

    def arrivals(self, n: int, start: float = 0.0) -> List[float]:
        return list(self.iter_arrivals(n, start))

    def iter_arrivals(self, n: int, start: float = 0.0) -> Iterator[float]:
        """Streaming ``arrivals`` — same seeded RNG draw sequence, so the
        values match the materialized list exactly."""
        rng = random.Random(self.seed)
        t = start
        for _ in range(n):
            yield t
            t += rng.expovariate(self.rate)

    def __hash__(self):
        return hash((self.rate, self.seed))


@dataclass
class RegionalDiurnal:
    """Open loop, region-aware: every region runs its own Poisson arrival
    process whose rate follows a diurnal (sinusoidal) profile with a
    per-region *phase offset* — region r peaks ``r/regions`` of a period
    after region 0, the follow-the-sun pattern a planetary deployment
    sees.  The aggregate mean rate is ``rate`` (split evenly), so sweeps
    against a single-region baseline stay load-comparable.

    Arrivals are sampled by Lewis thinning against the per-region peak
    rate, all through seeded ``random.Random`` streams, so the same seed
    reproduces the identical (time, region) sequence.  ``arrivals`` is
    the standard driver hook; pass ``entry_for`` as ``run_parallel``'s
    ``entry=`` callable to make each instance enter at the region that
    generated it (instead of round-robin spreading)."""
    regions: int = 2
    rate: float = 10.0            # aggregate mean arrival rate (rps)
    peak_to_trough: float = 3.0   # diurnal amplitude (peak / trough rate)
    period_s: float = 240.0       # one compressed "day" of simulated time
    seed: int = 0
    entry_template: str = "drone{r}"
    closed = False
    _plan: List[Tuple[float, int]] = field(default_factory=list,
                                           repr=False)

    def _rate_at(self, region: int, t: float, start: float) -> float:
        base = self.rate / max(self.regions, 1)
        amp = (self.peak_to_trough - 1) / (self.peak_to_trough + 1)
        phase = region / max(self.regions, 1)
        return base * (1 + amp * math.sin(
            2 * math.pi * ((t - start) / self.period_s - phase)))

    def plan(self, n: int, start: float = 0.0) -> List[Tuple[float, int]]:
        """The merged arrival schedule: n ``(time, region)`` pairs in
        non-decreasing time order."""
        base = self.rate / max(self.regions, 1)
        amp = (self.peak_to_trough - 1) / (self.peak_to_trough + 1)
        lam_max = base * (1 + amp)
        rngs = [random.Random(self.seed * 1000003 + r)
                for r in range(self.regions)]

        def draw(region: int, t: float) -> float:
            while True:
                t += rngs[region].expovariate(lam_max)
                if rngs[region].random() * lam_max <= \
                        self._rate_at(region, t, start):
                    return t

        nxt = [draw(r, start) for r in range(self.regions)]
        out: List[Tuple[float, int]] = []
        while len(out) < n:
            r = min(range(self.regions), key=lambda i: (nxt[i], i))
            out.append((nxt[r], r))
            nxt[r] = draw(r, nxt[r])
        return out

    def arrivals(self, n: int, start: float = 0.0) -> List[float]:
        self._plan = self.plan(n, start)
        return [t for t, _ in self._plan]

    def region_of(self, i: int) -> int:
        if not self._plan:
            raise RuntimeError("call arrivals() before region_of()")
        return self._plan[i][1]

    def entry_for(self, i: int) -> str:
        """Entry node for instance ``i`` — the region whose arrival
        process generated it."""
        return self.entry_template.format(r=self.region_of(i))


@dataclass
class ClosedLoop:
    """``clients`` concurrent clients, each running instances back-to-back
    with an optional think time; n total instances are split round-robin."""
    clients: int = 4
    think_time: float = 0.0
    closed = True

    def per_client(self, n: int) -> List[int]:
        base, extra = divmod(n, max(self.clients, 1))
        return [base + (1 if i < extra else 0)
                for i in range(max(self.clients, 1))]
