"""Model inputs of every architecture: concrete batches and shape stand-ins.

Port of ``repro.models.io``.  ``make_batch`` draws a random batch with the
reference's structure: ``tokens`` and ``labels`` (the tokens rolled by
one), plus whisper's precomputed frame embeddings ``frames`` (``seq``
encoder positions; the decoder gets ``seq // dec_len_ratio`` tokens) or
paligemma's precomputed patch embeddings ``patches`` (``n_prefix_tokens``
of the ``seq`` positions; ``labels`` is -1 over them).  ``batch_specs`` and
``decode_specs`` give the same structures as tensors on the meta device
(shapes and dtypes, no storage), as the reference's ShapeDtypeStructs;
``input_specs`` picks one of them by the shape's kind.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, batch: int | None = None,
                seq: int | None = None) -> dict:
    """Model inputs for a train/prefill step (token batch + stub frontends)."""
    B = batch if batch is not None else shape.global_batch
    S = seq if seq is not None else shape.seq_len
    if cfg.encoder_decoder:
        S_dec = max(S // cfg.dec_len_ratio, 1)
        return {"frames": _meta((B, S, cfg.d_model), torch.float32),
                "tokens": _meta((B, S_dec)), "labels": _meta((B, S_dec))}
    if cfg.frontend == "vision":
        P = cfg.n_prefix_tokens
        return {"patches": _meta((B, P, cfg.d_model), torch.float32),
                "tokens": _meta((B, S - P)), "labels": _meta((B, S))}
    return {"tokens": _meta((B, S)), "labels": _meta((B, S))}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 batch: int | None = None, seq: int | None = None) -> dict:
    """Inputs for one decode step: token, cache and position."""
    from repro_torch.models.transformer import init_cache
    B = batch if batch is not None else shape.global_batch
    S = seq if seq is not None else shape.seq_len
    return {"tokens": _meta((B, 1)), "cache": init_cache(cfg, B, S,
                                                         device="meta"),
            "pos": _meta(())}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, **kw) -> dict:
    """The dry-run's inputs of a cell: ``decode_specs`` for a decode shape,
    else ``batch_specs``."""
    if shape.kind == "decode":
        return decode_specs(cfg, shape, **kw)
    return batch_specs(cfg, shape, **kw)


def make_batch(cfg: ModelConfig, generator: torch.Generator, batch: int,
               seq: int) -> dict:
    """A random batch matching ``batch_specs``, drawn from ``generator`` on
    its device."""
    dev = generator.device

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=generator,
                             device=dev, dtype=torch.int32)

    def normal(n):
        return torch.randn((batch, n, cfg.d_model), generator=generator,
                           device=dev)
    if cfg.encoder_decoder:
        tok = tokens(max(seq // cfg.dec_len_ratio, 1))
        return {"frames": normal(seq), "tokens": tok,
                "labels": torch.roll(tok, -1, dims=1)}
    if cfg.frontend == "vision":
        P = cfg.n_prefix_tokens
        tok = tokens(seq - P)
        labels = torch.cat([torch.full((batch, P), -1, dtype=torch.int32,
                                       device=dev),
                            torch.roll(tok, -1, dims=1)], dim=1)
        return {"patches": normal(P), "tokens": tok, "labels": labels}
    tok = tokens(seq)
    return {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
