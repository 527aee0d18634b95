"""State-strategy protocol + registry: the engine↔strategy contract.

The workflow engine used to duck-type three placer classes behind an
``if strategy == ...`` ladder.  This module formalizes the contract as a
``StateStrategy`` base class (Identify/Compute-style *plan* hooks plus the
data-plane ``offload_state``) and a string registry, so ``"databelt"`` /
``"random"`` / ``"stateless"`` — and future cost-aware policies — are
drop-in::

    @register_strategy("my-policy")
    class MyPolicy(StateStrategy):
        def offload_state(self, function_id, host, t, key):
            return key.moved(...)

    eng = WorkflowEngine(net, strategy="my-policy")

Every strategy is constructed with the same factory signature
``(graph_fn, available, slo, seed=...)``; strategies that need no
randomness or availability simply ignore those arguments.  Behavioral
knobs the engine used to special-case by name live on the strategy as
class attributes (``global_sync`` — synchronous global-tier durability on
every put, the stateless baseline's defining cost — plus the paper's
Table 2 CPU/RAM resource proxies).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Type

from repro_torch.core.keys import StateKey
from repro_torch.core.slo import SLO


class StateStrategy:
    """Base class for state-placement strategies.

    Control plane (precomputed, off the critical path — paper §4.1):

    * ``plan_state_placement(function_id, host, dst, data_size, t)`` —
      called before a function with a downstream consumer at ``dst``
      completes; may precompute a placement decision.
    * ``plan_terminal_state(function_id, host, data_size, t)`` — called
      for terminal functions on multi-region topologies; may propagate
      the final state toward its serving region.

    Data plane (at function completion):

    * ``offload_state(function_id, host, t, key)`` — must return the
      (possibly moved) ``StateKey`` under which the produced state is
      stored.
    """

    #: registry name; set by ``@register_strategy``
    name: str = ""
    #: when True the engine's puts pay the synchronous global-tier
    #: durability leg (the stateless baseline); async replication else
    global_sync: bool = False
    #: simulated resource proxies (paper Table 2 reports flat ~16% CPU /
    #: ~1.4 GB for the baselines, slightly higher CPU for Databelt)
    cpu_pct_proxy: float = 16.0
    ram_mb_proxy: float = 1423.0

    def __init__(self, graph_fn, available=None, slo: SLO = SLO(), *,
                 seed: int = 0):
        self.graph_fn = graph_fn
        self.available = available
        self.slo = slo

    # -- control plane (default: no precomputation) ----------------------
    def plan_state_placement(self, function_id: str, host: str, dst: str,
                             data_size: float, t: float):
        return None

    def plan_terminal_state(self, function_id: str, host: str,
                            data_size: float, t: float):
        return None

    # -- data plane ------------------------------------------------------
    def offload_state(self, function_id: str, host: str, t: float,
                      key: StateKey) -> StateKey:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[StateStrategy]] = {}


def register_strategy(name: str,
                      override: bool = False) -> Callable[[Type], Type]:
    """Class decorator: make ``cls`` resolvable as ``strategy=name``.
    Re-registering an existing name raises unless ``override=True`` —
    silently shadowing a builtin would swap every engine's policy."""
    def deco(cls: Type) -> Type:
        prior = _REGISTRY.get(name)
        if prior is not None and prior is not cls and not override:
            raise ValueError(
                f"strategy {name!r} already registered to "
                f"{prior.__name__}; pass override=True to replace it")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def unregister_strategy(name: str) -> None:
    """Remove ``name`` from the registry (tests registering throwaway
    policies clean up with this)."""
    _REGISTRY.pop(name, None)


def _ensure_builtins() -> None:
    """Import the in-tree strategy modules so their ``@register_strategy``
    decorators have run (lazy: avoids an import cycle at module load)."""
    import repro_torch.core.baselines   # noqa: F401
    import repro_torch.core.propagation  # noqa: F401


def available_strategies() -> tuple:
    """Registered strategy names, sorted (for error messages and docs)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def make_strategy(strategy, graph_fn, available, slo: SLO = SLO(), *,
                  seed: int = 0) -> StateStrategy:
    """Resolve ``strategy`` — a registered name or an already-constructed
    ``StateStrategy`` instance — into an instance bound to this topology."""
    if isinstance(strategy, StateStrategy):
        return strategy
    _ensure_builtins()
    cls = _REGISTRY.get(strategy)
    if cls is None:
        raise ValueError(
            f"unknown state strategy {strategy!r}; registered: "
            f"{', '.join(available_strategies())}")
    return cls(graph_fn, available, slo, seed=seed)
