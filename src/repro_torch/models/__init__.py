from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
)
