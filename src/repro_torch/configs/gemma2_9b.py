"""gemma2-9b [dense]  [arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  Local/global
alternating (window 4096), attention logit softcap 50, final logit softcap 30,
post-norms (sandwich norm), GeGLU.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig, register


@register("gemma2-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10_000.0,
        act="gelu",
        post_norms=True,
        tie_embeddings=True,
        embedding_scale=True,
    )
