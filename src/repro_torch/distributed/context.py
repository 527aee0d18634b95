"""Distribution context: logical-axis sharding rules.  Port of
``repro.distributed.context``.

Models name tensor axes logically (``"batch"``, ``"seq"``, ``"heads"``,
``"kv_heads"``, ``"embed"``, ``"ff"``, ``"experts"``, ``"vocab"``,
``"kv_seq"``...).  The active :class:`ShardingRules` maps logical axes to
mesh axes; outside any context the annotations are no-ops.

A spec is a plain tuple with one entry per tensor dim: a mesh-axis name, a
tuple of them, or None (replicated), entry for entry the reference's
``PartitionSpec``, whose canonical form ``pspec`` keeps (a tuple of one
axis is that axis, an empty tuple None).  ``placements`` turns one into
DTensor placements on a real ``DeviceMesh``.  A mesh is read through its ``mesh_dim_names`` and
``shape`` only, so a ``launch.mesh.AbstractMesh`` (names and sizes, no
devices) serves wherever no collective runs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def axis_sizes(mesh) -> dict:
    """{mesh-axis name: size} of a DeviceMesh or an AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def pspec(*entries) -> tuple:
    """A spec in ``PartitionSpec``'s canonical form."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else (None if e == () else e) for e in entries)


class ShardingRules:
    """Maps logical axis names to mesh axis names (or None)."""

    def __init__(self, mesh, rules: dict, moe_axis: str = "model"):
        self.mesh = mesh
        self.rules = dict(rules)
        self.moe_axis = moe_axis          # mesh axis carrying experts
        self.data_axes = rules.get("batch")

    def spec(self, logical: tuple) -> tuple:
        return pspec(*(self.rules.get(ax) if ax else None for ax in logical))

    def placements(self, logical: tuple) -> tuple:
        return placements(self.spec(logical), self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` where the
    mesh dim shards tensor dim d, ``Replicate()`` elsewhere.  A tensor dim
    sharded over several mesh dims is split in mesh-dim order, as the
    reference's ``("pod", "data")`` is (``pod`` major)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, s in enumerate(spec):
        for ax in ((s,) if isinstance(s, str) else (s or ())):
            out[mesh.mesh_dim_names.index(ax)] = Shard(d)
    return tuple(out)


def local_shard(t, spec: tuple, mesh):
    """This rank's block of the full tensor ``t`` under ``spec`` (the
    per-rank view a ``shard_map`` body gets by its in_spec)."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, s in enumerate(spec):
        axes = (s,) if isinstance(s, str) else (s or ())
        n, i = 1, 0
        for ax in axes:
            n, i = n * sizes[ax], i * sizes[ax] + coord[ax]
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
    return t


def current() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x, logical: tuple):
    """Lay ``x`` out as the logical axes say: ``redistribute`` a DTensor to
    the active rules' placements; a plain tensor, or no active rules, leaves
    ``x`` as it is (the port's models hold no DTensors)."""
    r = current()
    if r is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(r.spec(logical),
                                                    x.device_mesh))


def axis_size(mesh_axis: str) -> int:
    r = current()
    if r is None:
        return 1
    return axis_sizes(r.mesh).get(mesh_axis, 1)
