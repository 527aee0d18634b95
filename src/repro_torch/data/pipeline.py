"""Deterministic synthetic token pipeline with background prefetch.

Port of ``repro.data.pipeline``.  Batches are a pure function of (seed,
step), made in numpy by the reference's own code, so both packages see the
same tokens bit for bit; after a failure the run resumes at step k and sees
exactly the data it would have seen.  Generation runs ahead on a worker
thread (prefetch) so host-side data work overlaps device compute.  The
iterator yields numpy arrays: the training loop moves each batch to its
device (the reference's ``sharding`` argument, a ``device_put`` in the
worker, has no counterpart on one device).
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokens:
    """Markov-chain-ish token stream: correlated tokens so the LM loss has
    learnable structure (pure-random tokens would bottom out at ln V)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    def batch_for_step(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        V = self.cfg.vocab_size
        B, S = self.batch, self.seq
        if self.cfg.encoder_decoder:
            S_dec = max(S // self.cfg.dec_len_ratio, 1)
            tok = self._tokens(rng, B, S_dec, V)
            return {
                "frames": rng.standard_normal(
                    (B, S, self.cfg.d_model), dtype=np.float32),
                "tokens": tok,
                "labels": np.roll(tok, -1, axis=1),
            }
        if self.cfg.frontend == "vision":
            P = self.cfg.n_prefix_tokens
            tok = self._tokens(rng, B, S - P, V)
            labels = np.concatenate(
                [np.full((B, P), -1, np.int32), np.roll(tok, -1, axis=1)],
                axis=1)
            return {
                "patches": rng.standard_normal(
                    (B, P, self.cfg.d_model), dtype=np.float32),
                "tokens": tok,
                "labels": labels,
            }
        tok = self._tokens(rng, B, S, V)
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}

    @staticmethod
    def _tokens(rng, B, S, V):
        # zipfian unigram + local repetition structure
        base = np.minimum(rng.zipf(1.3, size=(B, S)), V - 1).astype(np.int32)
        rep = rng.random((B, S)) < 0.3
        out = base.copy()
        out[:, 1:][rep[:, 1:]] = out[:, :-1][rep[:, 1:]]
        return out

    # -- iterator with prefetch ----------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            b = self.batch_for_step(self._step)
            self._step += 1
            self._q.put(b)

    def start(self, step: int = 0):
        self._step = step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
