"""h2o-danube-1.8b [dense] — llama+mistral mix with SWA  [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding-window
attention on every layer (mistral-style, window 4096), SiLU-gated MLP.
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, register


@register("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32_000,
        layer_pattern=(ATTN_LOCAL,),
        window_size=4096,
        rope_theta=10_000.0,
        act="silu",
        tie_embeddings=False,
    )
