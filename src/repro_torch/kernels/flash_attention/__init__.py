from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_bkg,
    variant,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref,
    flash_attention_wgmma_ref,
)
