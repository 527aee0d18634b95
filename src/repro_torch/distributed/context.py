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

The sharded model is the port's model with its parameters as DTensors
(``layouts.shard_params``) and its batch and cache too
(``layouts.distribute_tree``).  Under active rules ``constrain`` lays an
activation out as the reference's ``with_sharding_constraint`` does, by a
DTensor ``redistribute``; a plain tensor, or no active rules, leaves it
as it is, so the unsharded model runs exactly as before.  The tensors the
model makes itself (rope tables, positions, masks, scalars, zero caches)
stay plain: the model's entry points, the train step and the optimizers'
updates run under ``replicate_made_tensors``, which is torch's
``implicit_replication`` (a plain tensor taken as replicated on the
DTensor's mesh) where the model holds DTensors and nothing otherwise.
``local_placements`` is what a kernel wrapper's DTensor route checks
before it runs its kernel on the local shards (``local_map``); ``on_rows``
runs any function so on each rank's rows of an activation whose rows
stay cut (``rows_cut``), against weights gathered whole; ``cut_as`` cuts
a small weight as an activation is cut, so that a product runs on each
rank's block, and ``reduced`` sums its partial result.
``unflatten``/``flatten``, ``replicate_dim``, ``grad_like`` and
``native_alltoall`` keep a DTensor's layout where DTensor's own rules would
refuse a reshape, scatter a gradient onto strided rows, or gather a whole
dim for an all-to-all (the dry-run's production meshes need all four).
"""
from __future__ import annotations

import contextlib
import functools
import sys
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
    reference's ``("pod", "data")`` is (``pod`` major).  A mesh dim of size
    1 cuts nothing and is ``Replicate()`` (DTensor's view rules refuse some
    reshapes of a dim "sharded" over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, s in enumerate(spec):
        for ax in ((s,) if isinstance(s, str) else (s or ())):
            if sizes[ax] > 1:
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
    the active rules' placements; a plain tensor (the unsharded model's),
    or no active rules, leaves ``x`` as it is.  A dim of size 1 stays
    whole (a decode step's one row where the rules cut the sequence:
    ``long_500k``'s batch of 1), as the reference's partitioner pads it:
    DTensor would give one rank the row and the others none, and refuse
    to view the rows flat."""
    r = current()
    if r is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    place = tuple(Replicate() if p.is_shard() and x.shape[p.dim] == 1
                  else p for p in placements(r.spec(logical), mesh))
    return x.redistribute(mesh, place)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor: nothing is
    one until ``torch.distributed.tensor`` has been imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def redistribute(t, place):
    """``t`` at the placements ``place`` where it is a DTensor and they
    differ; else ``t`` itself.  Partial sums over several mesh dims that
    ``place`` reduces are reduced in one collective (``reduce_flat``)."""
    if place is None or not is_dtensor(t) or tuple(t.placements) == \
            tuple(place):
        return t
    t = reduce_flat(t, place)
    if tuple(t.placements) == tuple(place):
        return t
    return t.redistribute(t.device_mesh, tuple(place))


def summed(t):
    """The DTensor ``t`` whole on every rank, its partial sums reduced in
    one collective (``reduce_flat``); a plain ``t`` as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return redistribute(t, (Replicate(),) * t.device_mesh.ndim)


def _flat_mesh(mesh, dims: tuple):
    """The 1-D mesh of ``mesh``'s dims ``dims`` flattened (rank order as
    ``placements`` lays a tensor dim over them, the first major), made
    once a mesh (``DeviceMesh._flatten``) and kept on it.  It is taken out
    of the root mesh's register of flattened meshes, where DTensor (torch
    2.13) would find it and merge its own collectives over those dims from
    then on: what a step issues would then depend on what ran before it
    in the process.  Made under no dispatch mode."""
    from torch.utils._python_dispatch import _disable_current_modes
    made = mesh.__dict__.setdefault("_flat_meshes", {})
    if dims not in made:
        names = tuple(mesh.mesh_dim_names[m] for m in dims)
        # the mesh's own index arithmetic is no op of the step that
        # first reduces over it (an ``OpTrace`` would count it there)
        with _disable_current_modes():
            flat = mesh[names]._flatten()
        root = getattr(mesh, "_get_root_mesh", lambda: mesh)()
        getattr(root, "_flatten_mapping", {}).pop(flat.mesh_dim_names[0],
                                                  None)
        made[dims] = flat
    return made[dims]


def reduce_flat(t, place):
    """The DTensor ``t`` with its partial sums over the mesh dims of more
    than one rank that ``place`` does not keep ``Partial`` reduced in one
    all-reduce over those dims flattened into one (``DeviceMesh._flatten``:
    ``pod`` and ``data`` of ``multipod``, 32 ranks), where there are two or
    more of them; else ``t`` as it is.  DTensor reduces one mesh dim at a
    time, a reduce-scatter over ``data`` and an all-reduce of the shard
    over ``pod``: two collectives a gradient where the reference's
    partitioner issues one.  The local sum is moved onto the flattened
    mesh, reduced there and moved back replicated on those dims (no data
    moves either way); ``redistribute`` then cuts it locally where
    ``place`` shards it."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = t.device_mesh
    dims = [m for m, p in enumerate(t.placements)
            if p.is_partial() and mesh.size(m) > 1
            and not place[m].is_partial()]
    ops = {t.placements[m].reduce_op for m in dims}
    if len(dims) < 2 or len(ops) > 1:
        return t
    flat = _flat_mesh(mesh, tuple(dims))
    total = DTensor.from_local(t.to_local(), flat, (t.placements[dims[0]],),
                               run_check=False).redistribute(
        flat, (Replicate(),)).to_local()
    return DTensor.from_local(
        total, mesh, tuple(Replicate() if m in dims else p
                            for m, p in enumerate(t.placements)),
        run_check=False, shape=t.shape, stride=t.stride())


def unflatten(t, dim: int, sizes: tuple):
    """``t`` with ``dim`` split into ``sizes`` (a reshape).  A DTensor can
    only split a shard that holds whole rows of ``sizes[0]`` (the reference's
    XLA re-lays out instead): the mesh dims that shard ``dim`` over more
    ranks than divide ``sizes[0]`` are replicated first (an all-gather),
    the one redistribution DTensor needs where the reference's layout
    cannot be followed through the reshape.  So is a shard where
    ``sizes[0]`` is 1 (it would move to ``sizes[1]``: GQA with one kv
    head)."""
    shape = (*t.shape[:dim], *sizes, *t.shape[dim + 1:])
    if is_dtensor(t):
        n = 1
        for m in _sharding(t, dim):
            n *= t.device_mesh.size(m)
        if sizes[0] % n or sizes[0] == 1:
            t = replicate_dim(t, dim)
    return t.reshape(shape)


def flatten(t, dim: int):
    """``t`` with dims ``dim`` and ``dim + 1`` merged (a reshape).  Of a
    DTensor, the gradient is split back by ``unflatten``: the reshape's own
    backward cannot split a gradient shard that holds no whole rows of the
    first dim (more ranks than heads)."""
    dim %= t.dim()
    if not is_dtensor(t):
        return t.reshape(*t.shape[:dim], t.shape[dim] * t.shape[dim + 1],
                         *t.shape[dim + 2:])
    return _flatten_fn().apply(t, dim)


@functools.cache
def _flatten_fn():
    import torch

    class Flatten(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, dim):
            ctx.dim, ctx.sizes = dim, tuple(t.shape[dim:dim + 2])
            return t.flatten(dim, dim + 1)

        @staticmethod
        def backward(ctx, g):
            return unflatten(g, ctx.dim, ctx.sizes), None
    return Flatten


def grad_like(t):
    """``t``, whose gradient is laid out as ``t`` is where ``t`` is a
    DTensor.  DTensor otherwise may resolve a partial gradient by
    scattering it over the rows of the flattened (batch x sequence) dim, a
    strided shard whose sharding propagation takes minutes an op on a 3-D
    mesh.  Products whose output is replicated over ``model`` take their
    gradients here: RWKV's LoRA and receptance, the q/k/v projections
    where the heads do not split, the frontend projections."""
    if not is_dtensor(t):
        return t
    return _grad_like_fn().apply(t)


@functools.cache
def _grad_like_fn():
    import torch

    class GradLike(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            ctx.placements = t.placements
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return redistribute(g, ctx.placements)
    return GradLike


def _sharding(t, dim: int) -> list:
    """The mesh dims on which the DTensor ``t`` shards tensor dim ``dim``."""
    return [m for m, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim % t.dim()]


def replicate_dim(t, dim: int):
    """The DTensor ``t`` with tensor dim ``dim`` whole on every rank: the
    mesh dims that shard it are replicated (an all-gather each), the
    others keep their placements."""
    from torch.distributed.tensor import Replicate
    on = _sharding(t, dim)
    if not on:
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if m in on else p for m, p in enumerate(t.placements)))


def local_device(t):
    """The device of ``t``'s data: a DTensor's local shard's (a DTensor's
    own ``device`` can be its mesh's device type), a tensor's own."""
    return t.to_local().device if is_dtensor(t) else t.device


@contextlib.contextmanager
def replicate_made_tensors(t):
    """``implicit_replication`` where ``t`` (a parameter of the model) is a
    DTensor, else nothing.  Nested uses enter it once (torch's turns it off
    on any exit)."""
    if not is_dtensor(t) or getattr(_state, "replicating", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _state.replicating = True
    try:
        with implicit_replication():
            yield
    finally:
        _state.replicating = False


@contextlib.contextmanager
def native_alltoall():
    """DTensor's shard-to-shard ``redistribute`` as the all-to-all it is on
    every mesh.  On a mesh of device type ``"cpu"`` DTensor falls back to an
    all-gather of the whole dim and a local chunk (16 times the bytes on a
    16-rank axis, under another kind); gloo and the fake process group run
    the all-to-all itself (``_dtensor.shard_dim_alltoall``), as a card's
    mesh does.  The dry-run traces its sharded cells under this, and so
    does any run they are held against."""
    import torch
    from torch.distributed.tensor import _collective_utils, placement_types
    fallback = _collective_utils.shard_dim_alltoall

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    mods = [m for m in (_collective_utils, placement_types)
            if getattr(m, "shard_dim_alltoall", None) is fallback]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = fallback


def local_placements(kernel: str, inputs: dict, splits: dict) -> tuple:
    """The placements a kernel runs its DTensor ``inputs`` at on their
    local shards.

    ``inputs``: {name: DTensor}.  ``splits``: {name: {split axis: tensor
    dim}}, the axes along which the kernel's maths lets each input be cut
    (batch, heads, channels); an input without an axis holds all of it.
    Each mesh dim may shard one split axis: every input that has that axis
    is sharded on its dim there, every other one is replicated.  An input
    already sharded there keeps its shard; a replicated one is cut locally
    (``Replicate`` to ``Shard`` moves no data); on a mesh dim of size 1 every
    input is taken replicated.  A ``Partial``, a shard of a
    dim that is no split axis, or two inputs sharding different axes on
    one mesh dim raise, with the placements in the message: nothing here
    gathers.  Returns ({name: placements}, {name: grad placements}, the
    axis chosen on each mesh dim or None): an input replicated on a mesh
    dim that shards an axis it lacks takes a ``Partial`` gradient there
    (each shard's contribution is summed)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(iter(inputs.values())).device_mesh
    seen = {n: tuple(t.placements) for n, t in inputs.items()}

    def fail(why):
        raise ValueError(f"{kernel}: {why}; placements {seen}")

    axes = []
    for m in range(mesh.ndim):
        chosen = None
        for name, t in inputs.items():
            pl = t.placements[m]
            if isinstance(pl, Partial) or not (pl.is_shard() or
                                               pl.is_replicate()):
                fail(f"{name} is {pl} on mesh dim {m}")
            if pl.is_replicate():
                continue
            ax = {d: a for a, d in splits[name].items()}.get(pl.dim)
            if ax is None:
                fail(f"{name}'s dim {pl.dim} cannot be split")
            if mesh.size(m) == 1:
                continue            # a shard of one: nothing is cut
            if chosen not in (None, ax):
                fail(f"mesh dim {m} shards both {chosen} and {ax}")
            chosen = ax
        axes.append(chosen)
    place, grad = {}, {}
    for name in inputs:
        sp = splits[name]
        place[name] = tuple(Shard(sp[a]) if a in sp else Replicate()
                            for a in axes)
        grad[name] = tuple(Partial() if a is not None and a not in sp
                           else p for a, p in zip(axes, place[name]))
    return place, grad, axes


def run_local(kernel: str, fn, inputs: dict, splits: dict, out_splits):
    """``fn`` (taking the inputs in order, returning a tensor or a tuple)
    on the local shards of the DTensor ``inputs`` through ``local_map``,
    at ``local_placements``; ``out_splits`` gives each output's {axis:
    dim} (a dict, or a tuple of them)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    place, grad, axes = local_placements(kernel, inputs, splits)
    mesh = next(iter(inputs.values())).device_mesh
    outs = (out_splits,) if isinstance(out_splits, dict) else out_splits
    out_place = tuple(tuple(Shard(sp[a]) if a in sp else Replicate()
                            for a in axes) for sp in outs)
    run = local_map(fn, out_placements=out_place,
                    in_placements=tuple(place[n] for n in inputs),
                    in_grad_placements=tuple(grad[n] for n in inputs),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(*inputs.values())


# the rows of a (B, S, ...) activation: its batch and its sequence
ROWS = {"batch": 0, "seq": 1}


def rows_cut(t) -> bool:
    """Whether the DTensor ``t`` (B, S, ...) cuts its sequence over a mesh
    dim of more than one rank (the residual stream's ``act_seq``)."""
    return is_dtensor(t) and any(
        p.is_shard(1) and t.device_mesh.size(m) > 1
        for m, p in enumerate(t.placements))


def row_block(t) -> int:
    """The index of this rank's block of the DTensor ``t``'s sequence
    (dim 1), the mesh dims that cut it taken in mesh order, the first
    major (as ``placements`` lays a dim over several)."""
    j = 0
    for m in _sharding(t, 1):
        j = j * t.device_mesh.size(m) + t.device_mesh.get_local_rank(m)
    return j


def replicated(t):
    """The DTensor weight ``t`` whole on every rank (an all-gather of each
    mesh dim that shards it), through ``weight_at``; a plain ``t``, or one
    already whole, as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return weight_at(t, (Replicate(),) * t.device_mesh.ndim)


def cut_as(w, dim: int, t, t_dim: int):
    """The DTensor weight ``w`` cut on its dim ``dim`` over the mesh dims
    that cut the DTensor ``t``'s dim ``t_dim``, whole on the others
    (``weight_at``: a local cut where ``w`` is whole).  A product of ``t``
    that contracts, or makes, that dim then runs on each rank's block of
    it, as the reference's partitioner runs a small replicated weight
    against an activation cut over ``model``.  A plain ``w`` or ``t``
    leaves ``w`` as it is."""
    if not (is_dtensor(w) and is_dtensor(t)):
        return w
    from torch.distributed.tensor import Replicate, Shard
    on = _sharding(t, t_dim)
    return weight_at(w, tuple(Shard(dim % w.dim()) if m in on else
                              Replicate() for m in range(w.device_mesh.ndim)))


def reduced(t):
    """The DTensor ``t`` with its partial sums reduced (``redistribute``),
    its shards kept; a plain ``t`` as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return redistribute(t, tuple(Replicate() if p.is_partial() else p
                                 for p in t.placements))


def weight_at(w, place):
    """The DTensor weight ``w`` at the placements ``place`` (a gather, or a
    local cut), whose gradient comes back as its use leaves it: ``Partial``
    over the ranks that hold its partial sums, cut where its use cut it.
    A redistribution's own backward would reduce it to ``w``'s placements
    in every microbatch's backward; this one leaves that to the train step,
    which sums the microbatches' gradients where they lie and reduces the
    sum once (``train.steps``).  A plain ``w``, or one at ``place``, as it
    is."""
    if not is_dtensor(w) or tuple(w.placements) == tuple(place):
        return w
    return _weight_at_fn().apply(w, tuple(place))


@functools.cache
def _weight_at_fn():
    import torch

    class WeightAt(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, place):
            return w.redistribute(w.device_mesh, place)

        @staticmethod
        def backward(ctx, g):
            return g, None
    return WeightAt


def on_rows(name: str, fn, rows: tuple, whole: dict, n_out: int = 1):
    """``fn(*rows, *whole.values())`` on each rank's rows: the DTensors
    ``rows`` (B, S, ...) at their cuts of the batch and the sequence, each
    tensor of ``whole`` (a weight) gathered to every rank first
    (``replicated``).  Through ``run_local``, so a whole tensor's gradient
    comes back ``Partial`` over the ranks that cut the rows, and stays so
    (``weight_at``): the train step reduces it once a step.
    This is how the reference's partitioner runs a product whose rows stay
    cut as the residual stream's: each rank its rows against the whole
    weight, where DTensor's own product would gather the rows (it cannot
    flatten a batch and a sequence cut over two mesh dims into one dim of
    rows).  ``n_out`` outputs, each (B, S, ...) at the rows' cuts."""
    ins = {f"rows{i}": t for i, t in enumerate(rows)}
    ins.update({n: replicated(t) for n, t in whole.items()})
    splits = {n: ROWS if n.startswith("rows") else {} for n in ins}
    return run_local(name, fn, ins, splits,
                     ROWS if n_out == 1 else (ROWS,) * n_out)


def rows_product(x, w, name: str):
    """x (B, S, D) @ w: on a DTensor x, each rank's rows against the whole
    w (``on_rows``); else the product itself."""
    if not is_dtensor(x):
        return x @ w
    import torch
    return on_rows(name, torch.matmul, (x,), {"w": w})


def axis_size(mesh_axis: str) -> int:
    r = current()
    if r is None:
        return 1
    return axis_sizes(r.mesh).get(mesh_axis, 1)
