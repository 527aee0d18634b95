"""Databelt State Key (paper Fig. 7): WorkflowID | StorageAddress | FunctionID.

Functions receive a key as input and emit a new key as output; the key is the
only state-location coupling between functions ("key-based isolation").
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class StateKey:
    workflow_id: str
    storage_address: str   # node id holding the (primary) copy
    function_id: str

    def encoded(self) -> str:
        # memoized + interned: keys are encoded on every storage op and
        # used as store-dict keys, where interning makes lookups pointer
        # comparisons.  The cached string lives outside the dataclass
        # fields, so eq/hash/replace semantics are untouched.
        enc = self.__dict__.get("_enc")
        if enc is None:
            enc = sys.intern(f"{self.workflow_id}::{self.storage_address}"
                             f"::{self.function_id}")
            object.__setattr__(self, "_enc", enc)
        return enc

    @staticmethod
    def decode(s: str) -> "StateKey":
        w, a, f = s.split("::")
        return StateKey(w, a, f)

    def moved(self, node_id: str) -> "StateKey":
        return replace(self, storage_address=node_id)
