"""Serverless workflow model: W = (F, E) with real torch function bodies.

Includes the paper's flood-disaster workflow (Ingest -> Detect -> Map ->
Alarm, Fig. 4): Detect runs a small DNN over drone video frames, Map runs a
CNN over EO-satellite SAR tiles — both as real torch compute on the device
the workflow is bound to (CUDA by default).

The four bodies are the reference's (``repro/serverless/workflow.py:
194-247``) as plain functions on tensors.  What differs, and why:

* the weights come in as an argument (``flood_weights``), drawn once per
  device; the reference draws them inside every call from
  ``PRNGKey(7)`` / ``PRNGKey(13)``, which torch cannot reproduce (the
  tests carry the reference's draws across with
  ``flood_weights_from_numpy``);
* XLA's ``"SAME"`` padding is uneven at stride 2 (low 0, high 1 at
  32 -> 16 and 16 -> 8), so ``_same_pad`` pads explicitly before an
  unpadded ``F.conv2d``: ``padding=1`` would pad (1, 1) and move the
  detections by up to 18.7;
* ``jnp.var`` divides by N: ``var(correction=0)``;
* ``jnp.percentile(., 20.0)`` interpolates linearly, as
  ``torch.quantile(., 0.2)`` does;
* the convolutions run in full f32 whatever the caller's cuDNN setting
  (``_f32_convolutions``): PyTorch lets cuDNN round f32 to TF32 by default,
  where XLA on the CPU computes in f32.
"""
from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.slo import FunctionDemand
from repro_torch.device import resolve_device

COMPUTE_S_PER_MB = 0.15      # calibrated to the paper's testbed (Table 2)


@dataclass
class ServerlessFunction:
    name: str
    compute: Optional[Callable] = None       # payload -> payload (torch)
    out_ratio: float = 1.0                   # output size = in * ratio
    demand: FunctionDemand = field(
        default_factory=lambda: FunctionDemand("fn"))
    compute_s_per_mb: float = COMPUTE_S_PER_MB

    def virtual_compute_time(self, in_bytes: float) -> float:
        return self.compute_s_per_mb * in_bytes / 1e6


@dataclass
class Workflow:
    workflow_id: str
    functions: List[ServerlessFunction]
    edges: List[Tuple[str, str]]
    sink_in_cloud: bool = True   # final function gravitates to the cloud
    # DAG semantics (``repro_torch.serverless.dag``).  Empty defaults keep a
    # linear chain on the engine's sequential path bit-identically:
    # ``conditions`` maps an edge to a ``payload -> bool`` predicate (the
    # destination is skipped when it returns False), ``sync`` names
    # explicit barrier functions that wait for ALL predecessors to
    # resolve but run when ANY of them is live, ``chunk`` gives a ranked
    # sibling the fraction of its predecessor's output it consumes.
    conditions: Dict[Tuple[str, str], Callable[[dict], bool]] = \
        field(default_factory=dict)
    sync: Tuple[str, ...] = ()
    chunk: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.sync = tuple(self.sync)
        self._validate_edges()

    def _validate_edges(self) -> None:
        """Every edge endpoint must name a declared function — an edge on
        an unknown name would otherwise surface as a bare ``KeyError``
        deep inside ``order()`` (or silently never fire for an unknown
        source).  Duplicate function names raise too: ``fn()`` and the
        edge maps would silently resolve to the first declaration while
        the engine executed both."""
        declared = [f.name for f in self.functions]
        names = set(declared)
        if len(names) != len(declared):
            dup = sorted({n for n in declared if declared.count(n) > 1})
            raise ValueError(
                f"workflow {self.workflow_id!r} declares duplicate "
                f"function name(s) {dup}; every function needs a unique "
                f"name (ranked siblings are suffixed '#k')")
        unknown = sorted({n for e in self.edges for n in e
                          if n not in names})
        if unknown:
            raise ValueError(
                f"workflow {self.workflow_id!r} has edges naming unknown "
                f"function(s) {unknown}; declared functions: "
                f"{sorted(names)}")
        if self.conditions:
            edges = set(self.edges)
            bad = sorted(e for e in self.conditions if e not in edges)
            if bad:
                raise ValueError(
                    f"workflow {self.workflow_id!r} has conditions on "
                    f"non-edges {bad}")
        bad_sync = sorted(n for n in self.sync if n not in names)
        if bad_sync:
            raise ValueError(
                f"workflow {self.workflow_id!r} marks unknown "
                f"function(s) {bad_sync} as sync barriers")
        bad_chunk = sorted(n for n in self.chunk if n not in names)
        if bad_chunk:
            raise ValueError(
                f"workflow {self.workflow_id!r} assigns chunk fractions "
                f"to unknown function(s) {bad_chunk}")

    def _edge_memo(self):
        """Memoized (predecessor lists, successor lists, fn-by-name).

        Guarded on the list lengths: the dataclass is mutable, so
        appending a function or edge rebuilds the memo (in-place element
        replacement is not detected; no caller does that).  The engine
        asks for the neighbors of every function once per instance — at
        100k instances the naive per-call edge scans were a measurable
        hot spot."""
        guard = (len(self.functions), len(self.edges))
        cached = self.__dict__.get("_edges_memo")
        if cached is not None and cached[0] == guard:
            return cached[1]
        preds: Dict[str, List[str]] = {f.name: [] for f in self.functions}
        succs: Dict[str, List[str]] = {f.name: [] for f in self.functions}
        for i, j in self.edges:
            preds.setdefault(j, []).append(i)
            succs.setdefault(i, []).append(j)
        # duplicate names raise in _validate_edges, so this is unambiguous
        byname: Dict[str, ServerlessFunction] = {f.name: f
                                                 for f in self.functions}
        memo = (preds, succs, byname)
        self.__dict__["_edges_memo"] = (guard, memo)
        return memo

    def fn(self, name: str) -> ServerlessFunction:
        f = self._edge_memo()[2].get(name)
        if f is not None:
            return f
        return next(f for f in self.functions if f.name == name)

    def order(self) -> List[str]:
        """Topological order of the workflow DAG.  Raises ``ValueError``
        naming the offending nodes when ``edges`` contain a cycle (a
        truncated order would silently drop every function downstream of
        the cycle) or reference an unknown function.

        Runs on the memoized successor lists with a deque frontier —
        the old form rescanned the full edge list once per frontier node
        (O(V*E)) and popped the frontier head from a list.  The
        successor lists preserve edge order, so the produced order is
        *identical* to the edge-rescan form on every workflow (pinned in
        ``tests/test_dag.py`` against the naive reference)."""
        self._validate_edges()
        _, succs, _ = self._edge_memo()
        names = [f.name for f in self.functions]
        indeg = {n: 0 for n in names}
        for _, j in self.edges:
            indeg[j] += 1
        out: List[str] = []
        frontier = deque(n for n in names if indeg[n] == 0)
        while frontier:
            n = frontier.popleft()
            out.append(n)
            for j in succs[n]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    frontier.append(j)
        if len(out) < len(names):
            stuck = sorted(n for n in names if n not in out)
            raise ValueError(
                f"workflow {self.workflow_id!r} edges contain a cycle "
                f"through {stuck}; these functions would never execute")
        return out

    @property
    def is_linear(self) -> bool:
        """True when the workflow is a simple path — every function has
        at most one predecessor and one successor, no conditional edges,
        no sync barriers.  Linear workflows take the engine's sequential
        chain path (bit-identical to the pre-DAG engine); anything else
        runs branches as concurrent child kernel processes via
        ``repro_torch.serverless.dag``."""
        if self.conditions or self.sync:
            return False
        preds, succs, _ = self._edge_memo()
        for f in self.functions:
            if len(preds[f.name]) > 1 or len(succs[f.name]) > 1:
                return False
        return True

    def predecessors(self, name: str) -> List[str]:
        """Upstream function names, in edge order.  Read-only."""
        return self._edge_memo()[0].get(name, [])

    def successors(self, name: str) -> List[str]:
        """Downstream function names, in edge order.  Read-only."""
        return self._edge_memo()[1].get(name, [])


# ---------------------------------------------------------------------------
# Flood-disaster detection workflow (paper §2.1) — real torch bodies
# ---------------------------------------------------------------------------
LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
_WEIGHTS: Dict[str, Dict[str, torch.Tensor]] = {}   # device -> flood_weights


def _hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's ``"SAME"`` does for a ``k``x``k`` window:
    the total pad of each spatial dim splits low = total // 2 and high =
    the rest, so at stride 2 over an even size the one extra row and
    column go to the high side."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad: last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _f32_convolutions(body):
    """Run ``body`` with cuDNN's convolutions in full f32, restoring the
    caller's setting after.  PyTorch's default lets cuDNN round f32 inputs to
    TF32 (``torch.backends.cudnn.conv.fp32_precision == "tf32"``); a TF32
    Laplacian moves ingest's ``sharp`` by about 1e-2, where neighbouring
    values near its 20th percentile lie about 1e-3 apart at 2441 frames, so
    the keep mask could leave the reference's."""
    @functools.wraps(body)
    def run(*args):
        conv = torch.backends.cudnn.conv
        before = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            return body(*args)
        finally:
            conv.fp32_precision = before
    return run


def flood_weights(device="cuda") -> Dict[str, torch.Tensor]:
    """The flood bodies' convolution weights, OIHW, on ``device``: detect's
    ``w1`` (3,3,1,8) and ``w2`` (3,3,8,4) from a CPU generator seeded 7, map's
    ``w`` (5,5,1,4) from one seeded 13, each drawn in the reference's HWIO
    shape and x 0.1 (``repro/serverless/workflow.py:210-212,232-233``, which
    draws from PRNGKeys 7 and 13).  Drawn on the CPU, so every device holds
    the same values, and once per device."""
    dev = resolve_device(device)
    key = str(dev)
    if key not in _WEIGHTS:
        g7 = torch.Generator().manual_seed(7)
        g13 = torch.Generator().manual_seed(13)
        hwio = {"w1": torch.randn((3, 3, 1, 8), generator=g7) * 0.1,
                "w2": torch.randn((3, 3, 8, 4), generator=g7) * 0.1,
                "w_map": torch.randn((5, 5, 1, 4), generator=g13) * 0.1}
        _WEIGHTS[key] = {n: _hwio_to_oihw(w).to(dev) for n, w in hwio.items()}
    return _WEIGHTS[key]


def flood_weights_from_numpy(w1, w2, w_map, device="cuda"
                             ) -> Dict[str, torch.Tensor]:
    """Carry the reference's HWIO draws (numpy) across, as ``flood_weights``
    lays them out (``params_from_jax``'s counterpart for the workflow)."""
    dev = resolve_device(device)
    return {n: _hwio_to_oihw(torch.from_numpy(np.array(w, np.float32)))
            .to(dev) for n, w in (("w1", w1), ("w2", w2), ("w_map", w_map))}


@_f32_convolutions
def ingest_fn(payload):
    """Filter blurry frames: variance-of-Laplacian threshold."""
    frames = payload["frames"]                    # (N, H, W)
    k = frames.new_tensor(LAPLACIAN)[None, None]
    # convolve2d(mode="same") is a true convolution; the Laplacian is
    # symmetric, so F.conv2d's cross-correlation with pad 1 is the same
    lap = F.conv2d(frames[:, None], k, padding=1)
    sharp = lap.reshape(lap.shape[0], -1).var(dim=1, correction=0)
    keep = sharp > torch.quantile(sharp, 0.2)
    return {"frames": frames * keep[:, None, None], "keep": keep}


@_f32_convolutions
def detect_fn(payload, weights):
    """Tiny person-detection DNN over the kept frames."""
    x = payload["frames"][:, None]                # NCHW, C = 1
    x = F.relu(F.conv2d(_same_pad(x, 3, 2), weights["w1"], stride=2))
    x = F.conv2d(_same_pad(x, 3, 2), weights["w2"], stride=2)
    score = torch.sigmoid(x.mean(dim=(1, 2, 3)))
    return {"detections": score}


@_f32_convolutions
def map_fn(payload, weights):
    """Flood-extent CNN over SAR data (U-net-ish single stage)."""
    w = weights["w_map"]
    sar = payload.get("sar")
    det = payload.get("detections")
    if sar is None:
        sar = torch.ones((8, 64, 64), dtype=torch.float32, device=w.device)
    x = F.conv2d(_same_pad(sar[:, None], 5, 1), w)
    flood = torch.sigmoid(x.mean(dim=1))
    return {"flood_map": flood, "detections": det}


def alarm_fn(payload):
    det = payload.get("detections")
    fm = payload.get("flood_map")
    # float() of a device tensor waits for it, as the reference's does
    score = (0.0 if det is None else float(det.mean())) + \
        (0.0 if fm is None else float(fm.mean()))
    return {"alarm": score > 0.5, "score": score}


def flood_workflow(workflow_id: str = "flood", *, device="cuda",
                   weights: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Workflow:
    """The flood DAG with its bodies bound to ``weights`` (default:
    ``flood_weights(device)``, resolved at the first real call, so that a
    virtual run touches no device)."""
    def weighted(body):
        def compute(payload):
            return body(payload, weights if weights is not None
                        else flood_weights(device))
        return compute

    mk = lambda name: FunctionDemand(name, cpu=1.0, mem=256e6, power=5.0,
                                     t_exc=2.0)
    fns = [
        ServerlessFunction("ingest", ingest_fn, out_ratio=0.9,
                           demand=mk("ingest")),
        ServerlessFunction("detect", weighted(detect_fn), out_ratio=0.5,
                           demand=mk("detect")),
        ServerlessFunction("map", weighted(map_fn), out_ratio=0.5,
                           demand=mk("map")),
        ServerlessFunction("alarm", alarm_fn, out_ratio=0.1,
                           demand=mk("alarm")),
    ]
    edges = [("ingest", "detect"), ("detect", "map"), ("map", "alarm")]
    return Workflow(workflow_id, fns, edges)


def chain_workflow(workflow_id: str, depth: int = 3,
                   compute_s_per_mb: float = 0.05) -> Workflow:
    """Depth-``depth`` linear chain (the fusion benchmark's workload,
    paper Table 4): lightweight functions passing state 1:1 down the
    chain, so fusion depth is the only variable."""
    fns = [ServerlessFunction(
        f"f{i}", None, out_ratio=1.0,
        demand=FunctionDemand(f"f{i}", cpu=0.25, mem=64e6, power=2.0,
                              t_exc=1.0),
        compute_s_per_mb=compute_s_per_mb) for i in range(depth)]
    edges = [(f"f{i}", f"f{i+1}") for i in range(depth - 1)]
    return Workflow(workflow_id, fns, edges)


def make_payload(size_bytes: float, with_sar: bool = True, *,
                 device="cuda") -> dict:
    """Synthetic drone video payload of roughly ``size_bytes``: the
    reference's numpy arrays, moved to ``device``."""
    dev = resolve_device(device)
    n = max(int(size_bytes / (32 * 32 * 4)), 4)
    n = min(n, 4096)
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(n, 32, 32)).astype(np.float32)
    payload = {"frames": torch.from_numpy(frames).to(dev)}
    if with_sar:
        sar = rng.normal(size=(8, 64, 64)).astype(np.float32)
        payload["sar"] = torch.from_numpy(sar).to(dev)
    return payload
