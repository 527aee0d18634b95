"""Two-tier checkpointing — the Databelt local/global storage design applied
to training state.  Port of ``repro.checkpoint.twotier``.

* local tier  — fast dump ("state on the satellite"): written every
  ``local_every`` steps, asynchronously.
* global tier — durable full checkpoint ("state in the cloud"): written
  every ``global_every`` steps.

Restore prefers the freshest local checkpoint and falls back to the global
tier (exactly the paper's read path).  The state is a nested dict of
tensors, where a module stands for its named parameters (the train state's
``params``); a checkpoint holds them flattened by path.  The port's
optimizer updates tensors in place, so an asynchronous save copies every
tensor to the host before ``maybe_save`` returns: only the file write runs
on the background thread.  ``restore`` copies the saved tensors into the
given state's tensors (the reference rebuilds its pytree and re-shards it;
one device has no sharding to change).
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

import torch
from torch import nn


def flatten(state, prefix: str = "") -> dict:
    """{path: tensor} of a nested dict of tensors and modules."""
    if isinstance(state, nn.Module):
        state = dict(state.named_parameters())
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if not torch.is_tensor(state):
        raise TypeError(f"{prefix[:-1]}: {type(state).__name__} is not a "
                        f"tensor")
    return {prefix[:-1]: state}


class TwoTierCheckpoint:
    def __init__(self, root: str, local_every: int = 10,
                 global_every: int = 50, keep: int = 2):
        self.root = Path(root)
        self.local_dir = self.root / "local"
        self.global_dir = self.root / "global"
        self.local_every = local_every
        self.global_every = global_every
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self.local_dir.mkdir(parents=True, exist_ok=True)
        self.global_dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    def maybe_save(self, state, step: int):
        if step % self.global_every == 0:
            self._save(state, step, self.global_dir)
        elif step % self.local_every == 0:
            self._save_async(state, step, self.local_dir)

    @staticmethod
    def _to_host(state) -> dict:
        # a blocking copy: the snapshot is taken before the caller's next
        # in-place update
        return {k: t.detach().to("cpu", copy=True)
                for k, t in flatten(state).items()}

    def _save_async(self, state, step: int, tier: Path):
        self.wait()
        host_state = self._to_host(state)
        self._pending = threading.Thread(
            target=self._write, args=(host_state, step, tier), daemon=True)
        self._pending.start()

    def _save(self, state, step: int, tier: Path):
        self.wait()
        self._write(self._to_host(state), step, tier)

    def _write(self, host_state: dict, step: int, tier: Path):
        tmp = tier / f"step{step:08d}.tmp"
        final = tier / f"step{step:08d}.ckpt"
        # repro: allow(DB001): the wall-clock timestamp is checkpoint
        # metadata (operator forensics), never replayed math
        torch.save({"leaves": host_state, "step": step, "time": time.time()},
                   tmp)
        tmp.rename(final)
        self._gc(tier)

    def _gc(self, tier: Path):
        cks = sorted(tier.glob("step*.ckpt"))
        for old in cks[:-self.keep]:
            old.unlink(missing_ok=True)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ------------------------------------------------------------------
    def latest(self):
        """(path, step, tier) of the freshest checkpoint across tiers."""
        best = None
        for tier_name, tier in (("local", self.local_dir),
                                ("global", self.global_dir)):
            for p in tier.glob("step*.ckpt"):
                step = int(p.stem[4:])
                if best is None or step > best[1]:
                    best = (p, step, tier_name)
        return best

    def restore(self, state):
        """Load the freshest checkpoint into ``state``'s tensors, in place.
        Returns (state, step), or (None, -1) when there is none."""
        self.wait()
        found = self.latest()
        if found is None:
            return None, -1
        path, step, _ = found
        leaves = torch.load(path, weights_only=True)["leaves"]
        dest = flatten(state)
        if sorted(leaves) != sorted(dest):
            raise ValueError(f"{path} holds {sorted(set(leaves) ^ set(dest))} "
                             f"that the state does not, or the reverse")
        with torch.no_grad():
            for k, t in dest.items():
                if leaves[k].shape != t.shape or leaves[k].dtype != t.dtype:
                    raise ValueError(f"{path}: {k} is {leaves[k].dtype} "
                                     f"{tuple(leaves[k].shape)}, the state's "
                                     f"{t.dtype} {tuple(t.shape)}")
                t.copy_(leaves[k])
        return state, step
