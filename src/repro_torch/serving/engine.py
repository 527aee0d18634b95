"""Batched serving engine: continuous batching over fixed decode slots.

Port of ``repro.serving.engine``, quirks included.  Requests (prompt token
arrays) queue; the engine packs them into ``n_slots`` decode lanes and
recycles a lane as soon as its request finishes (EOS or max tokens) — the
serving counterpart of the Databelt runtime: the KV-cache slot is the
"function state", kept device-local for the lifetime of the request.

As in the reference, prompts are fed one token at a time through decode for
all slots, one scalar position (the max over the active slots) serves a
step, and the next token is the greedy argmax taken in f32.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import forward_decode, init_cache


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    tokens_out: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, model, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = 1, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.budget = np.zeros(n_slots, np.int32)
        self.cache = init_cache(cfg, n_slots, max_len, dtype=torch.bfloat16,
                                device=self.device)
        self.completed: List[Request] = []

    def _decode(self, model, cache, tok, pos):
        return forward_decode(model, self.cfg, cache, tok, pos)

    def submit(self, req: Request):
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _admit(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                # lazy prefill: feed prompt tokens one by one through decode
                self.pos[i] = 0
                self.budget[i] = req.max_new
                self._feed_prompt(i, req)

    def _feed_prompt(self, i: int, req: Request):
        for t in req.prompt:
            tok = torch.full((self.n_slots, 1), int(t), dtype=torch.int32,
                             device=self.device)
            # only slot i's lane matters; others decode a dummy token into
            # their current position
            logits, self.cache = self._decode(self.model, self.cache, tok,
                                              int(self.pos[i]))
            self.pos[i] += 1
        self._last_logits = logits

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One decode step across all active slots; returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        toks = np.zeros((self.n_slots, 1), np.int32)
        for i in active:
            r = self.slots[i]
            toks[i, 0] = r.tokens_out[-1] if r.tokens_out else \
                (r.prompt[-1] if len(r.prompt) else 0)
        pos = int(max(self.pos[i] for i in active))
        logits, self.cache = self._decode(
            self.model, self.cache, torch.from_numpy(toks).to(self.device), pos)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1).cpu().numpy()
        for i in active:
            r = self.slots[i]
            t = int(nxt[i])
            r.tokens_out.append(t)
            self.pos[i] += 1
            self.budget[i] -= 1
            if t == self.eos_id or self.budget[i] <= 0 or \
                    self.pos[i] >= self.max_len - 1:
                r.done = True
                self.completed.append(r)
                self.slots[i] = None
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
