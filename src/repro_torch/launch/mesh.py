"""Mesh builders (functions — importing never touches devices).  Port of
``repro.launch.mesh``.

``make_mesh`` is ``init_device_mesh`` over the process group the caller
has initialised (``torch.distributed.init_process_group``; one card gives
a group of one).  ``make_production_mesh`` returns an ``AbstractMesh``,
the names and sizes of the reference's production mesh with no devices
behind them: what reads it (``distributed.layouts.choose_layout``,
``opt_pspecs``, a dry-run's layout) needs only the shape.  ``fake_mesh``
makes one real: this process as one rank (0 unless asked) of a fake
process group of the mesh's size (torch's in-process ``"fake"`` backend:
every collective is issued, none moves data), for the dry-run to trace that
rank's program.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Sequence

import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, read as a DeviceMesh's are."""
    mesh_dim_names: tuple
    shape: tuple

    def size(self, mesh_dim=None) -> int:
        if mesh_dim is not None:
            return self.shape[mesh_dim]
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device="cuda"):
    """A DeviceMesh of ``axis_shapes`` named ``axis_names`` over the
    current process group, whose size it must equal, on ``device``'s type
    (``"cpu"`` for gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(dev.type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 ranks.  Multi-pod: 2 pods = 512."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 2, model: int = 4, *, device="cuda"):
    """A small mesh over the process group: (data, model), or (1, world
    size) where the group has fewer ranks than that."""
    resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data * model > n:
        data, model = 1, n
    return make_mesh((data, model), ("data", "model"), device=device)


def _clear_dtensor_plans():
    """DTensor's sharding-propagation and redistribute-plan caches emptied.
    Their entries hold the mesh they were made on, which compares equal to
    another world's mesh of the same shape; its group names follow the
    rank (each names the group this rank is in), so a cached mesh of
    another world would name groups this one does not have.  torch has no
    public call for this: these two are its debug helper and the plan
    cache's own ``cache_clear``."""
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    _clear_sharding_prop_cache()
    _redistribute._gen_transform_infos.cache_clear()


@contextlib.contextmanager
def fake_mesh(mesh, rank: int = 0):
    """A DeviceMesh of ``mesh``'s names and sizes on which this process is
    ``rank`` (row-major over the mesh's dims) of a fake process group,
    under ``distributed.context.native_alltoall``; the group is destroyed
    on the way out, and DTensor's cached plans are emptied on the way in
    (``_clear_dtensor_plans``).  The mesh's
    device type is ``"cpu"`` (its tensors are the caller's: the dry-run's
    are on the meta device), so no card is needed.  Raises where the
    process already has a default process group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.context import native_alltoall
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_mesh needs a process without a default process group; "
            f"this one has a {dist.get_backend()} group of "
            f"{dist.get_world_size()} ranks")
    if not 0 <= rank < mesh.size():
        raise ValueError(f"rank {rank} is not one of the mesh's "
                         f"{mesh.size()}")
    _clear_dtensor_plans()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh.size())
    try:
        with native_alltoall():
            yield init_device_mesh("cpu", tuple(mesh.shape),
                                   mesh_dim_names=tuple(mesh.mesh_dim_names))
    finally:
        dist.destroy_process_group()
