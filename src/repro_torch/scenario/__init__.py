from repro_torch.scenario.spec import (NetworkSpec, Scenario,  # noqa: F401
                                 ScenarioReport, WorkloadSpec,
                                 workflow_maker)
from repro_torch.sim.autoscale import AutoscalePolicy  # noqa: F401
from repro_torch.sim.faults import FaultEvent, FaultPlan  # noqa: F401
