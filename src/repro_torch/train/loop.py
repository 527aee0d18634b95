"""Training loop with two-tier checkpointing and restart.  Port of
``repro.train.loop``.

``TrainLoop.run`` consumes the prefetching data pipeline, moves each batch
to the device and steps the train step; every N steps it snapshots to the
local tier (async) and less often to the global tier.  ``fail_at`` simulates
a node failure; a new loop on the same directory restores from the freshest
tier and resumes with the data order it would have seen.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.checkpoint import TwoTierCheckpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.optim import Optimizer, cosine_schedule
from repro_torch.train.steps import build_train_step, init_train_state


@dataclass
class LoopMetrics:
    steps: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class TrainLoop:
    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 batch: int, seq: int, lr: float = 3e-4,
                 ckpt_dir: Optional[str] = None, grad_accum: int = 1,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.optimizer = optimizer
        self.batch, self.seq = batch, seq
        self.seed = seed
        self.device = resolve_device(device)
        self.lr_fn = cosine_schedule(lr, 20, 2_000)
        self.step_fn = build_train_step(cfg, optimizer, self.lr_fn,
                                        grad_accum=grad_accum)
        self.ckpt = TwoTierCheckpoint(ckpt_dir) if ckpt_dir else None

    def init_or_restore(self):
        """The seeded initial state (drawn on the device), or the freshest
        checkpoint's copied into it: (state, first step)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = init_train_state(gen, self.cfg, self.optimizer,
                                 device=self.device)
        start = 0
        if self.ckpt is not None:
            restored, step = self.ckpt.restore(state)
            if restored is not None:
                state, start = restored, step
        return state, start

    def run(self, n_steps: int, fail_at: Optional[int] = None,
            log_every: int = 10) -> LoopMetrics:
        state, start = self.init_or_restore()
        data = SyntheticTokens(self.cfg, self.batch, self.seq,
                               seed=self.seed).start(step=start)
        m = LoopMetrics()
        try:
            for step in range(start, n_steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"simulated node failure @ {step}")
                # repro: allow(DB001): step timing measures the hardware
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in next(data).items()}
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                m.losses.append(loss)
                # repro: allow(DB001): step timing measures the hardware
                m.step_times.append(time.perf_counter() - t0)
                m.steps = step + 1
                if self.ckpt is not None:
                    self.ckpt.maybe_save(state, step + 1)
                if log_every and (step + 1) % log_every == 0:
                    print(f"step {step+1:5d} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"({m.step_times[-1]*1e3:.0f} ms)", flush=True)
        finally:
            data.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        return m
