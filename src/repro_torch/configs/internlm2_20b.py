"""internlm2-20b [dense] — GQA  [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, full causal
attention, SiLU-gated MLP.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("internlm2-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_544,
        layer_pattern=(ATTN_GLOBAL,),
        rope_theta=1_000_000.0,
        act="silu",
        tie_embeddings=False,
    )
