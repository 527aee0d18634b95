"""gemma3-1b [dense]  [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.  5:1 local:global
interleave (window 512), split RoPE bases (10k local / 1M global), qk-norm,
128k context via SWA locals.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig, register


@register("gemma3-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262_144,
        layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        window_size=512,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        qk_norm=True,
        act="gelu",
        post_norms=True,
        tie_embeddings=True,
        embedding_scale=True,
    )
