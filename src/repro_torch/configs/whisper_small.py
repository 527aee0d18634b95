"""whisper-small [audio] — encoder-decoder  [arXiv:2212.04356].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  The conv/mel frontend is a
STUB: ``input_specs()`` supplies precomputed frame embeddings fed straight to
the (bidirectional) encoder.  Decoder length = seq_len // dec_len_ratio.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51_865,
        layer_pattern=(ATTN_GLOBAL,),
        act="gelu_plain",
        tie_embeddings=True,
        encoder_decoder=True,
        dec_len_ratio=4,
        frontend="audio",
    )
