"""qwen3-moe-235b-a22b [moe]  [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) d_ff(expert)=1536 vocab=151936, 128 experts
top-8, qk-norm.  Expert parallelism maps experts onto the ``model`` mesh axis;
Adafactor keeps optimizer state within HBM at 235B scale.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151_936,
        layer_pattern=(ATTN_GLOBAL,),
        rope_theta=1_000_000.0,
        qk_norm=True,
        act="silu",
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=128,
            experts_per_token=8,
            d_ff_expert=1536,
        ),
        optimizer="adafactor",
    )
