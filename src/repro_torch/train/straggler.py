"""Straggler detection & mitigation — R-5 availability applied to a fleet.

``StragglerMonitor`` tracks per-host step-time EWMAs; hosts slower than
``threshold`` x the fleet median are flagged.  The mitigation mirrors the
paper's Identify phase: flagged hosts drop out of ``available()`` so the
Databelt planner (and the elastic mesh builder) excludes them, and the
deterministic data pipeline rebalances shards by construction (batches are
a function of (seed, step), not of topology).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HostStat:
    ewma_s: float = 0.0
    samples: int = 0


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.3,
                 min_samples: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.min_samples = min_samples
        self.hosts: Dict[str, HostStat] = {}

    def record(self, host: str, step_time_s: float):
        st = self.hosts.setdefault(host, HostStat())
        st.ewma_s = step_time_s if st.samples == 0 else \
            (1 - self.alpha) * st.ewma_s + self.alpha * step_time_s
        st.samples += 1

    def fleet_median(self) -> float:
        vals = [s.ewma_s for s in self.hosts.values()
                if s.samples >= self.min_samples]
        return statistics.median(vals) if vals else 0.0

    def stragglers(self) -> List[str]:
        med = self.fleet_median()
        if med <= 0:
            return []
        return sorted(h for h, s in self.hosts.items()
                      if s.samples >= self.min_samples
                      and s.ewma_s > self.threshold * med)

    def available(self, host: str) -> bool:
        """Drop-in for the planner's a_n(t) (R-5)."""
        return host not in set(self.stragglers())

    def healthy_hosts(self) -> List[str]:
        return sorted(h for h in self.hosts if self.available(h))
