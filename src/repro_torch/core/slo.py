"""Formalized requirements R-1..R-7 (paper §3.1.2) as executable checks.

Each check takes the topology + a (tentative) placement and returns a bool
(or a violation record).  The planner uses them as hard constraints; the
simulator uses them for SLO-violation accounting.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.topology import SAT, TopologyGraph


@dataclass(frozen=True)
class SLO:
    """Per-edge handoff latency bound S_ij (seconds). Paper scenario: 60 ms.

    ``max_migration_s`` (Algorithm 2's t_max) is a separate, larger budget:
    the proactive state migration runs in the background between function
    completions, so it may take up to the inter-function gap — only the
    consumer-visible handoff must meet the 60 ms SLO."""
    max_handoff_s: float = 0.060
    max_migration_s: float = 2.0


@dataclass
class FunctionDemand:
    """Resource demand of one function f_i."""
    name: str
    cpu: float = 1.0
    mem: float = 256e6
    power: float = 5.0      # P_i (watts)
    t_exc: float = 2.0      # temperature increase on the host (C)


def r1_resource_capacity(graph: TopologyGraph, placement: Dict[str, str],
                         demands: Dict[str, FunctionDemand]) -> bool:
    """sum_i D_i x_{i,n} <= R_n for all n."""
    mem: Dict[str, float] = {}
    cpu: Dict[str, float] = {}
    for f, n in placement.items():
        d = demands[f]
        mem[n] = mem.get(n, 0.0) + d.mem
        cpu[n] = cpu.get(n, 0.0) + d.cpu
    for n, used in mem.items():
        node = graph.nodes.get(n)
        if node is None or node.mem_used + used > node.mem:
            return False
    for n, used in cpu.items():
        node = graph.nodes.get(n)
        if node is None or node.cpu_used + used > node.cpu:
            return False
    return True


def r2_temperature(graph: TopologyGraph, placement: Dict[str, str],
                   demands: Dict[str, FunctionDemand]) -> bool:
    """T_orb^n + sum_i T_exc^{in} <= T_max^n (satellites only)."""
    heat: Dict[str, float] = {}
    for f, n in placement.items():
        heat[n] = heat.get(n, 0.0) + demands[f].t_exc
    for n, h in heat.items():
        node = graph.nodes.get(n)
        if node is None:
            return False
        if node.kind == SAT and \
                node.t_orb + node.temp_extra + h > node.t_max:
            return False
    return True


def r3_energy(graph: TopologyGraph, placement: Dict[str, str],
              demands: Dict[str, FunctionDemand]) -> bool:
    """sum_i P_i x_{i,n} <= P_avail^n."""
    power: Dict[str, float] = {}
    for f, n in placement.items():
        power[n] = power.get(n, 0.0) + demands[f].power
    for n, p in power.items():
        node = graph.nodes.get(n)
        if node is None or node.power_used + p > node.power_avail:
            return False
    return True


def r4_slo(graph: TopologyGraph, src: str, dst: str, slo: SLO) -> bool:
    """L(ns, nd) <= S_ij along the best path."""
    _, lat = graph.dijkstra(src, dst)
    return lat <= slo.max_handoff_s


def r5_availability(available_ids, placement: Dict[str, str]) -> bool:
    """Placement restricted to A(t)."""
    return all(n in available_ids for n in placement.values())


def r6_single_placement(placement: Dict[str, str], functions) -> bool:
    """sum_n x_{i,n} = 1 for all f_i."""
    return all(f in placement for f in functions)


def locality_penalty(graph: TopologyGraph, ns: str, nd: str,
                     gamma_per_hop: float = 0.005) -> float:
    """gamma(ns, nd): 0 when local, grows with network distance (R-7)."""
    if ns == nd:
        return 0.0
    return gamma_per_hop * graph.hops(ns, nd)


def check_all(graph: TopologyGraph, placement: Dict[str, str],
              demands: Dict[str, FunctionDemand],
              available_ids, functions) -> bool:
    return (r1_resource_capacity(graph, placement, demands)
            and r2_temperature(graph, placement, demands)
            and r3_energy(graph, placement, demands)
            and r5_availability(available_ids, placement)
            and r6_single_placement(placement, functions))
