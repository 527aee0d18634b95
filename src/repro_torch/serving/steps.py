"""Serve-step builders: prefill and single-token decode (greedy head)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_decode, forward_prefill


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        logits, cache = forward_prefill(model, cfg, batch)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok.to(torch.int32), cache
    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, tokens, pos):
        logits, new_cache = forward_decode(model, cfg, cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok.to(torch.int32)[:, None], new_cache
    return decode_step
