from repro_torch.serverless.workflow import ServerlessFunction, Workflow  # noqa: F401
from repro_torch.serverless.dag import (DagEdge, build_dag,  # noqa: F401
                                  branch_workflow, conditional_workflow,
                                  diamond_workflow, fanout_workflow)
from repro_torch.serverless.engine import WorkflowEngine, InstanceMetrics  # noqa: F401
