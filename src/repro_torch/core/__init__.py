from repro_torch.core.topology import Node, Link, TopologyGraph  # noqa: F401
from repro_torch.core.keys import StateKey  # noqa: F401
from repro_torch.core.strategy import (StateStrategy, available_strategies,  # noqa: F401
                                 make_strategy, register_strategy)
from repro_torch.core.propagation import identify, compute, offload, Databelt  # noqa: F401
from repro_torch.core.fusion import FusionGroup, plan_fusion_groups  # noqa: F401
from repro_torch.core.baselines import RandomPlacement, StatelessPlacement  # noqa: F401
