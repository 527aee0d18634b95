"""rwkv6-7b [ssm] — Finch: data-dependent decay linear attention
[arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.  Time-mix with
data-dependent per-channel decay (ddlerp token shift + decay LoRA), matrix
state per head (head_dim 64), channel-mix FFN.  Chunked (MXU-friendly)
recurrence for train/prefill; O(1) state decode.
"""
from repro_torch.configs.base import RWKV, ModelConfig, register


@register("rwkv6-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,           # rwkv heads = d_model // rwkv_head_dim
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65_536,
        layer_pattern=(RWKV,),
        act="relu_sq",
        tie_embeddings=False,
        rwkv_head_dim=64,
    )
