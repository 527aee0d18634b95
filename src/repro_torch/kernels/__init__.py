"""Hand-written Hopper kernels of the port, each beside its plain version.

The flash attention wrapper is the attention hook of ``models.attention`` by
default: on a CUDA tensor it launches the CUDA kernel, on a CPU tensor it
runs the plain version.  ``disable_flash_attention`` takes the hook out and
leaves the model's plain attention path (the reference's jnp path);
``enable_flash_attention`` puts it back.

The RG-LRU scan (``rglru_scan``) and the RWKV-6 wkv (``rwkv6_chunk``) are
called directly by ``models.rglru`` and ``models.rwkv``, with the same rule:
the kernel on a CUDA tensor, the plain version on a CPU tensor.
"""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401


def enable_flash_attention():
    from repro_torch.models.attention import set_attention_impl
    set_attention_impl(flash_attention)


def disable_flash_attention():
    from repro_torch.models.attention import set_attention_impl
    set_attention_impl(None)
