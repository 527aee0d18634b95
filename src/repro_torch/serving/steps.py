"""Serve-step builders: prefill and single-token decode (greedy head)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import constrain
from repro_torch.models import forward_decode, forward_prefill


def _greedy(logits):
    """The argmax of each row's last logits, as int32.  Of a DTensor, the
    vocab is gathered first: DTensor's own argmax of a vocab shard gathers
    over every mesh dim that shards the tensor, and fails where the rows
    are split over two (the multi-pod mesh's ("pod", "data"))."""
    last = constrain(logits[:, -1], ("batch", None))
    return torch.argmax(last.float(), dim=-1).to(torch.int32)


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        logits, cache = forward_prefill(model, cfg, batch)
        return _greedy(logits), cache
    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, tokens, pos):
        logits, new_cache = forward_decode(model, cfg, cache, tokens, pos)
        return _greedy(logits)[:, None], new_cache
    return decode_step
