"""Baseline state-placement strategies from the paper's evaluation:

* Stateless — all state lives in the global KVS on the cloud node; every
  function fetches from / writes to the cloud, and every write pays the
  synchronous global-tier durability leg (``global_sync``).
* Random    — state is stored on a uniformly random cluster node.

Both implement the ``StateStrategy`` contract (`repro_torch.core.strategy`) and
are registered as ``"stateless"`` / ``"random"``.
"""
from __future__ import annotations

import random

from repro_torch.core.keys import StateKey
from repro_torch.core.slo import SLO
from repro_torch.core.strategy import StateStrategy, register_strategy
from repro_torch.core.topology import CLOUD


@register_strategy("stateless")
class StatelessPlacement(StateStrategy):
    # the baseline's defining cost: cloud durability on the critical path
    global_sync = True

    def offload_state(self, function_id: str, host: str, t: float,
                      key: StateKey) -> StateKey:
        """All state goes to the cloud KVS — the *nearest* region's cloud
        in a multi-region topology, so stateless traffic shards across
        per-region queues instead of funneling into one global one (with a
        single cloud this is the original behavior exactly)."""
        graph = self.graph_fn(t)
        cloud = graph.nearest_of_kind(host, CLOUD) or host
        return key.moved(cloud)


@register_strategy("random")
class RandomPlacement(StateStrategy):
    def __init__(self, graph_fn, available=None, slo: SLO = SLO(), *,
                 seed: int = 0):
        super().__init__(graph_fn, available, slo, seed=seed)
        self.rng = random.Random(seed)
        self._ids_for: object = None      # snapshot the memo belongs to
        self._ids: list = []

    def offload_state(self, function_id: str, host: str, t: float,
                      key: StateKey) -> StateKey:
        graph = self.graph_fn(t)
        # snapshots are cached per time quantum, so identity comparison
        # memoizes the sorted id list across the ops sharing a snapshot
        if graph is not self._ids_for:
            self._ids_for, self._ids = graph, sorted(graph.nodes)
        return key.moved(self.rng.choice(self._ids))
