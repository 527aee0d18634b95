"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.  Repeating block =
(recurrent, recurrent, local-attention); window 2048; RG-LRU width 2560 with
temporal conv width 4.  Fixed-size recurrent state => O(1) long-context decode.
"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
        window_size=2048,
        rope_theta=10_000.0,
        act="gelu",
        tie_embeddings=True,
        embedding_scale=True,
        d_rnn=2560,
        conv_width=4,
    )
