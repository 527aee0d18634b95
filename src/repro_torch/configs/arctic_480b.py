"""arctic-480b [moe]  [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, 128 experts top-2
PLUS a parallel dense residual FFN (dense-MoE hybrid).  Adafactor optimizer
(AdamW fp32 state would not fit a single v5e pod at 480B).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig, register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        layer_pattern=(ATTN_GLOBAL,),
        rope_theta=10_000.0,
        act="silu",
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=128,
            experts_per_token=2,
            d_ff_expert=4864,
            dense_residual=True,
            d_ff_dense=4864,
        ),
        optimizer="adafactor",
        # measured: causal packing alone is collective-neutral for arctic
        # (the padded-head regression came from the MoE SP boundary, which
        # stays gated off) — see EXPERIMENTS.md §Perf Cell B
        attn_causal_pack="on",
    )
