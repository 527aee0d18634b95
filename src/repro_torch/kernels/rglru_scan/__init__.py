from repro_torch.kernels.rglru_scan.ops import (  # noqa: F401
    plan, rglru_scan, rglru_scan_bsc)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: F401
    rglru_scan_ref, rglru_scan_walk_ref)
