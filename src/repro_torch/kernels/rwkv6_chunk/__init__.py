from repro_torch.kernels.rwkv6_chunk.ops import wkv6, wkv6_bh  # noqa: F401
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_chunk_ref, wkv6_ref  # noqa: F401
