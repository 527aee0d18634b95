"""Op-trace introspection: flops, bytes, live memory, collectives, op census.

The port's twin of ``repro.roofline.hlo``.  The reference reads what XLA
compiled (the HLO text); eager PyTorch compiles nothing, so ``OpTrace``
watches the program run instead: a ``TorchDispatchMode`` that sees every
aten op of one call, on the meta device (shapes only, nothing allocated)
or on real tensors.

For each op it records the op's name, the bytes of its tensor operands and
results at their dtypes, its flops (``torch.utils.flop_counter``'s formula
registry; 0 where an op has none) and its transcendentals (the output
elements of ``exp``, ``log``, ``tanh``, ``sigmoid``, ``rsqrt``, ``erf``,
``sin``, ``cos`` and the like).  View ops move no data and allocations
(``empty``) write none: both count 0 bytes.  A hand-written kernel adds
itself as one op through ``record_kernel`` with the work its bound formula
counts (``roofline.analysis``); a route that splits a layer by hand notes
the local shapes it ran at through ``record_route`` (no op).

Live memory is counted by storage, so views count once: a storage is alive
from the op that makes it until it is freed, which a weak reference tells
(autograd's saved tensors and remat keep storages alive without a Python
tensor).  ``peak_bytes`` is the peak of the live bytes of the storages made
during the trace; storages the trace first sees as inputs (the arguments)
are outside it, and the bytes an op writes into them are kept in
``written_bytes``.  An op's own temporaries never reach the dispatcher; the
one that decides a train step's peak is counted while its op runs
(``_hidden_bytes``): ``_softmax_backward_data`` holds the product of its
gradient and output, and a contiguous copy of that product where the
gradient is not (the eager attention backward's): one or two times the
gradient's bytes (measured on an H100 at three shapes in f32 and bf16,
tests/test_torch_cuda.py; 2.147 GB a call at h2o-danube-1.8b's 2 x 2048
microbatch).

A size only known at run time has no value on the meta device: where a
boolean mask selects (``nonzero``, indexing and ``index_put`` by a mask, as
the MoE dispatch's kept slots), the trace counts every element of the mask
true, the size's upper bound (T*k for the dispatch), which is what the
reference's static-shape drop/fill dispatch computes under XLA.

``collective_stats(trace)`` maps the collectives the program issues,
``c10d`` ops, ``_c10d_functional`` ones and DTensor's own all-to-all
(``_dtensor.shard_dim_alltoall``, which a shard-to-shard ``redistribute``
issues), onto the reference's five kinds with the same dict as
``hlo.collective_stats``: send and recv are the two halves of a
``collective-permute`` (the count is the larger of the sends and the recvs;
sends carry the operand bytes, recvs the output bytes).  An op of those
namespaces that is neither one of them nor known to move no data (a wait,
a barrier) raises: no collective is dropped unseen.

Under a DTensor the trace counts what one rank runs: the mode steps aside
for an op on DTensors (``NotImplemented``), so DTensor's dispatch runs and
the mode sees the local ops it issues on this rank's shards, and the
collectives of any redistribution, at their local shapes.  What DTensor
runs to decide rather than to compute is not the rank's work and is not
counted, so a trace counts the same whether DTensor's caches are cold or
warm: its sharding propagation runs each op it has not cached on fake
tensors at the global shapes (an op under a ``FakeTensorMode``), and its
cost model and shard arithmetic work on small index tensors that it makes
itself (a factory op called from ``torch.distributed``, and every op whose
tensor operands all descend from one: "bookkeeping").
"""
from __future__ import annotations

import os
import sys
import time
from collections import Counter
from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (kind, index of the operand argument, index of the output
# argument); the in-place ops write their results into an argument
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_coalesced_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, None),
    "recv_": ("collective-permute", None, 0),
}
# _c10d_functional op -> kind: the operand is the first argument, the
# output what the op returns
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# _dtensor op -> kind: the operand is the first argument, the output what
# the op returns
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_dtensor")
# ops of those namespaces that move no data between ranks
_NOT_COLLECTIVE = {"barrier", "monitored_barrier_", "check_for_nan",
                   "wait_tensor", "_wrap_tensor_autograd",
                   "mesh_get_process_group"}
TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10",
    "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt",
    "sqrt_", "erf", "erf_", "erfc", "erfinv", "sin", "sin_", "cos", "cos_",
    "tan", "sinh", "cosh", "asin", "acos", "atan", "atan2", "_softmax",
    "_log_softmax", "gelu", "gelu_backward", "silu", "silu_backward",
    "logsigmoid", "softplus", "log_sigmoid_forward",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


# ops whose output size a boolean mask's count of true elements sets
_MASKED = {"nonzero", "index", "index_put", "index_put_", "_index_put_impl_"}


def _hidden_bytes(name: str, args: tuple) -> int:
    """Bytes an op holds in temporaries of its own while it runs (module
    docstring): softmax's backward holds grad * output, and its contiguous
    copy where the gradient is strided."""
    if name == "_softmax_backward_data":
        return tensor_bytes(args[0]) * (1 if args[0].is_contiguous() else 2)
    return 0


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mask_indices(m: torch.Tensor) -> list:
    """A boolean mask on the meta device as the int indices of its true
    elements, every element counted true: its upper bound."""
    return [torch.empty(m.numel(), dtype=torch.long, device="meta")] * m.dim()


def _bounded(name: str, args: tuple):
    """A data-dependent op's arguments on the meta device, each boolean
    mask replaced by ``_mask_indices``; ``nonzero``'s own result."""
    if name == "nonzero":
        return torch.empty((args[0].numel(), args[0].dim()), dtype=torch.long,
                           device="meta")
    indices = []
    for i in args[1]:
        if i is not None and i.dtype == torch.bool:
            indices += _mask_indices(i)
        else:
            indices.append(i)
    return (args[0], indices, *args[2:])


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dtensor_op(types) -> bool:
    """Whether an op's tensor types include DTensor (imported by then)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(issubclass(t, mod.DTensor) for t in types)


_TORCH = os.path.dirname(torch.__file__) + os.sep
_DISTRIBUTED = os.path.join(_TORCH, "distributed") + os.sep


def _made_by_distributed() -> bool:
    """Whether the op being dispatched was called from ``torch.distributed``
    code: the first frame below the dispatch that is not torch's own
    machinery decides."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_DISTRIBUTED):
            return True
        if not name.startswith(_TORCH):
            return False
        f = f.f_back
    return False


def _propagating() -> bool:
    """Whether the op runs under a ``FakeTensorMode``: DTensor's sharding
    propagation learning an output's global shape."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


@dataclass
class Op:
    name: str
    in_bytes: int
    out_bytes: int
    flops: int
    transcendentals: int
    shape: tuple = ()       # a hand-written kernel's first output's shape
    operands: tuple = ()    # a product's (``aten.mm``) operand shapes

    @property
    def bytes(self) -> int:
        return self.in_bytes + self.out_bytes


class OpTrace(TorchDispatchMode):
    """Records every aten op run under it (module docstring).

    ``ops``: the ``Op`` of each op in order; ``collectives``: ``(kind,
    operand bytes, output bytes, side, ranks)``, ``side``
    ``"send"``/``"recv"`` for point-to-point halves and None otherwise,
    ``ranks`` the size of the process group it runs over
    (``group_size``); ``peak_bytes``: the peak
    of the live storages made under the trace; ``written_bytes``: bytes
    written into storages made before it, by storage, at most each one's
    size; ``seconds``: the trace's wall time; ``route_shapes``: {name:
    the local shapes} a route that splits a layer by hand ran at
    (``record_route``)."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self.collectives: list[tuple] = []
        self.peak_bytes = 0
        self.written_bytes: dict = {}
        self.seconds = 0.0
        self.route_shapes: dict = {}
        self._made: dict = {}       # storage key -> (weak ref, bytes)
        self._outside: dict = {}    # storage key -> (weak ref, bytes)
        self._bookkeeping: dict = {}  # storage key -> weak ref
        self._live = 0              # bytes of self._made at the last sweep
        self._since = 0             # bytes made since the last sweep

    # ---- the trace ---------------------------------------------------------
    def __enter__(self):
        # repro: allow(DB001): the trace's own seconds, a measurement
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        # repro: allow(DB001): the trace's own seconds, a measurement
        self.seconds += time.perf_counter() - self._t0
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented       # its local ops come back here
        kwargs = kwargs or {}
        if _propagating():
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if all(self._is_bookkeeping(t) for t in ins) if ins else \
                _made_by_distributed():
            out = func(*args, **kwargs)
            for t in _tensors(out):
                key, st = self._key(t)
                self._bookkeeping[key] = StorageWeakRef(st)
            return out
        for t in ins:
            self._see_input(t)
        name = func.overloadpacket.__name__
        if name in _MASKED and args[0].device.type == "meta":
            bounded = _bounded(name, args)
            out = bounded if name == "nonzero" else func(*bounded, **kwargs)
        else:
            out = func(*args, **kwargs)
        ns = func.namespace
        if ns in _COLLECTIVE_NS and name not in _NOT_COLLECTIVE:
            self._collective(ns, name, args, out)
        outs = _tensors(out)
        for t in outs:
            self._see_output(t, func)
        hidden = _hidden_bytes(name, args)
        if hidden:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._live + hidden)
        if func.is_view or name in _NO_BYTES:
            in_b = out_b = 0
        else:
            in_b = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
            out_b = sum(tensor_bytes(t) for t in outs)
        formula = flop_registry.get(func.overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        trans = sum(t.numel() for t in outs) if name in TRANSCENDENTAL else 0
        operands = tuple(tuple(a.shape) for a in args[:2]) \
            if name == "mm" else ()
        self.ops.append(Op(f"{ns}.{name}", in_b, out_b, flops, trans,
                           operands=operands))
        return out

    def add_op(self, name: str, flops: int, nbytes: int, outputs,
               transcendentals: int = 0):
        """One op of ``nbytes`` bytes and ``flops`` flops (a hand-written
        kernel); ``outputs`` are its results, made under the trace (the
        op's ``shape`` is the first one's)."""
        outs = _tensors(outputs)
        out_b = sum(tensor_bytes(t) for t in outs)
        for t in outs:
            self._see_output(t, None)
        self.ops.append(Op(name, int(nbytes) - out_b, out_b, int(flops),
                           int(transcendentals),
                           tuple(outs[0].shape) if outs else ()))

    # ---- storages ----------------------------------------------------------
    @staticmethod
    def _key(t):
        s = t.untyped_storage()
        return s._cdata, s

    def _is_bookkeeping(self, t) -> bool:
        key, _ = self._key(t)
        ref = self._bookkeeping.get(key)
        if ref is not None and ref.expired():
            del self._bookkeeping[key]      # freed; the address was reused
            return False
        return ref is not None

    def _see_input(self, t):
        key, s = self._key(t)
        for table in (self._made, self._outside):
            if key in table and table[key][0].expired():
                del table[key]          # freed; the address was reused
        if key not in self._made and key not in self._outside:
            self._outside[key] = (StorageWeakRef(s), s.nbytes())

    def _see_output(self, t, func):
        key, s = self._key(t)
        if key in self._outside and not self._outside[key][0].expired():
            if func is not None and not func.is_view:
                cap = self._outside[key][1]
                self.written_bytes[key] = min(
                    cap, self.written_bytes.get(key, 0) + tensor_bytes(t))
            return
        if key in self._made and not self._made[key][0].expired():
            return
        self._outside.pop(key, None)
        nbytes = s.nbytes()
        self._made[key] = (StorageWeakRef(s), nbytes)
        self._since += nbytes
        # the live bytes are at most the last sweep's plus what was made
        # since: sweep for the frees only where that could pass the peak
        if self._live + self._since > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._live)

    def _sweep(self):
        dead = [k for k, (ref, _) in self._made.items() if ref.expired()]
        for k in dead:
            del self._made[k]
        self._live = sum(n for _, n in self._made.values())
        self._since = 0

    def made_bytes(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors (a DTensor's
        local shard) that were made under the trace (the outputs it
        created)."""
        mod = sys.modules.get("torch.distributed.tensor")
        keys = dict.fromkeys(
            self._key(t.to_local() if mod and isinstance(t, mod.DTensor)
                      else t)[0] for t in _tensors(tree))
        return sum(self._made[k][1] for k in keys if k in self._made)

    # ---- collectives -------------------------------------------------------
    def _collective(self, ns, name, args, out):
        known = {"c10d": _C10D, "_c10d_functional": _FUNCTIONAL,
                 "_dtensor": _DTENSOR}[ns]
        if name not in known:
            raise NotImplementedError(
                f"{ns}.{name}: a collective the trace cannot map onto "
                f"{COLLECTIVES}")
        if ns == "c10d":
            kind, i_in, i_out = _C10D[name]
            operand = sum(tensor_bytes(t) for t in _tensors(args[i_in])) \
                if i_in is not None else 0
            output = sum(tensor_bytes(t) for t in _tensors(args[i_out])) \
                if i_out is not None else 0
            side = None if kind != "collective-permute" else \
                ("send" if name == "send" else "recv")
        else:
            kind, side = known[name], None
            operand = sum(tensor_bytes(t) for t in _tensors(args[0]))
            output = sum(tensor_bytes(t) for t in _tensors(out))
        self.collectives.append((kind, operand, output, side,
                                 group_size(args)))

    # ---- totals ------------------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(op.flops for op in self.ops)

    @property
    def bytes_accessed(self) -> int:
        return sum(op.bytes for op in self.ops)

    @property
    def transcendentals(self) -> int:
        return sum(op.transcendentals for op in self.ops)


def group_size(args) -> int:
    """The number of ranks of the process group a collective's arguments
    name: a boxed ``ProcessGroup`` (the ``c10d`` ops), or a group's name
    (the functional and ``_dtensor`` ops); 0 where they name none."""
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject):     # a c10d op's group
            return c10d.ProcessGroup.unbox(a).size()
    return 0


def active_trace():
    """The innermost ``OpTrace`` being run under, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpTrace):
            return mode
    return None


def record_kernel(name: str, flops, nbytes, outputs,
                  transcendentals: int = 0):
    """A hand-written kernel's meta path adds itself to the active trace as
    one op doing its bound formula's work; returns ``outputs``."""
    trace = active_trace()
    if trace is not None:
        trace.add_op(name, flops, nbytes, outputs, transcendentals)
    return outputs


def record_route(name: str, shape):
    """A route that splits a layer by hand (the q-rows route, the k/v
    projections' columns) notes the local shape it ran at in the active
    trace's ``route_shapes``: no op, no work."""
    trace = active_trace()
    if trace is not None:
        trace.route_shapes.setdefault(name, set()).add(tuple(shape))


def collective_stats(trace: OpTrace) -> dict:
    """Per collective kind: count + operand bytes + output bytes."""
    stats = {k: {"count": 0, "operand_bytes": 0, "output_bytes": 0}
             for k in COLLECTIVES}
    sides = Counter()
    for kind, operand, output, side, _ in trace.collectives:
        st = stats[kind]
        if side is None:
            st["count"] += 1
        else:
            sides[side] += 1
        st["operand_bytes"] += operand
        st["output_bytes"] += output
    stats["collective-permute"]["count"] += max(sides["send"], sides["recv"])
    return stats


def total_collective_bytes(stats: dict) -> int:
    return sum(v["operand_bytes"] for v in stats.values())


def op_census(trace: OpTrace, top: int = 20) -> list:
    return Counter(op.name for op in trace.ops).most_common(top)
