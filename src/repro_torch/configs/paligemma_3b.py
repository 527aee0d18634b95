"""paligemma-3b [vlm] — SigLIP + Gemma backbone  [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  The SigLIP vision
tower is a STUB: ``input_specs()`` supplies precomputed patch embeddings which
are prepended as a bidirectional prefix (prefix-LM masking, PaliGemma style).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257_216,
        layer_pattern=(ATTN_GLOBAL,),
        rope_theta=10_000.0,
        act="gelu",
        tie_embeddings=True,
        embedding_scale=True,
        frontend="vision",
        n_prefix_tokens=256,
    )
