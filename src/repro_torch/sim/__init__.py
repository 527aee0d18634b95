from repro_torch.sim.autoscale import (AutoscalePolicy, AutoscaleReport,  # noqa: F401
                                 Autoscaler)
from repro_torch.sim.faults import (FaultEvent, FaultInjector,  # noqa: F401
                              FaultPlan, FaultReport)
from repro_torch.sim.kernel import SimKernel  # noqa: F401
from repro_torch.sim.metrics import ParallelReport, percentile  # noqa: F401
from repro_torch.sim.resources import ResourcePool, SlotResource  # noqa: F401
from repro_torch.sim.trace import (MetricRegistry, SpanRecorder,  # noqa: F401
                             TraceReport)
from repro_torch.sim.workload import (ClosedLoop, OpenLoopPoisson,  # noqa: F401
                                RegionalDiurnal, UniformStagger)
