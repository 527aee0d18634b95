"""Workflow execution engine over the simulated 3D continuum.

Discrete-event: every workflow instance is a process generator scheduled
on a shared ``repro_torch.sim.SimKernel`` event loop.  Per-node CPU slots and
per-node KVS service queues are first-class ``SlotResource`` FIFOs in one
``ResourcePool``, so parallel workflow executions contend for cores and
storage exactly where the paper's evaluation does (§6.3, Tables 2/3,
Fig 13).  Function placement always uses the HyperDrive-style planner; the
state strategies (``repro_torch.core.strategy`` registry: databelt / random /
stateless / any registered policy) differ only in where produced state
lands — isolating the paper's contribution exactly as its evaluation does.

Every state touch goes through ONE surface: a per-instance
``StateSession`` (``repro_torch.continuum.session``) with exactly
``put``/``get``/``get_fused``, all kernel-yieldable generators.  The
engine's queueing ``mode`` — ``"event"`` (default: storage ops park on
the KVS FIFOs like CPU slots, so autoscale grows re-admit queued backlog)
vs ``"analytic"`` (committed-schedule accounting, the pre-event-driven
engine pinned bit-identically) — lives entirely in the session; the
instance process is mode-free.

Each instance runs as three composable phases per fusion group:
``_fetch_group`` (grouped state prefetch overlapping sandbox init, SLO
accounting), ``_execute_group`` (virtual or real torch compute), and
``_offload_group`` (strategy-planned state placement + writes).

Metrics per instance mirror the paper's Tables 2/3: total latency, state
read/write time, mean state distance (hops), local availability, SLO
violations, plus simulated CPU/RAM proxies.  ``run_parallel`` drives n
truly concurrent instances and reports fleet-level throughput, p50/p95/p99
latency, and per-node queue depth (``repro_torch.sim.ParallelReport``).
"""
from __future__ import annotations

import gc
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.continuum.network import ContinuumNetwork
from repro_torch.continuum.session import MODES, StateSession
from repro_torch.continuum.storage import TwoTierStorage
from repro_torch.core.fusion import plan_fusion_groups
from repro_torch.core.keys import StateKey
from repro_torch.core.planner import WorkflowSpec, plan_workflow, undo_plan
from repro_torch.core.slo import SLO
from repro_torch.core.strategy import make_strategy
from repro_torch.serverless.dag import DagSchedule, plan_dag_groups
from repro_torch.serverless.workflow import Workflow, make_payload
from repro_torch.sim.autoscale import AutoscalePolicy, Autoscaler
from repro_torch.sim.faults import FaultInjector, FaultPlan
from repro_torch.sim.kernel import SimKernel
from repro_torch.sim.metrics import FleetAggregate, ParallelReport
from repro_torch.sim.resources import ResourcePool, SlotResource
from repro_torch.sim.trace import SpanRecorder
from repro_torch.sim.workload import UniformStagger, iter_arrivals
from repro_torch.device import resolve_device

SANDBOX_INIT_S = 1.0   # Knative-class cold start per sandbox; fusion packs
                       # a whole group into one sandbox and its grouped
                       # state prefetch overlaps the init (paper §4.2)


@dataclass
class InstanceMetrics:
    latency: float = 0.0
    read_time: float = 0.0
    write_time: float = 0.0
    compute_time: float = 0.0
    reads: int = 0
    local_reads: int = 0
    global_reads: int = 0   # reads served by the global-tier fallback
    hops: List[int] = field(default_factory=list)
    slo_violations: int = 0
    handoffs: int = 0
    storage_ops: int = 0
    cpu_pct: float = 0.0
    ram_mb: float = 0.0

    @property
    def local_availability(self) -> float:
        return self.local_reads / max(self.reads, 1)

    @property
    def mean_hops(self) -> float:
        return sum(self.hops) / max(len(self.hops), 1)

    @property
    def global_fallback_rate(self) -> float:
        """Share of reads the global tier served (the churn signal)."""
        return self.global_reads / max(self.reads, 1)

    @property
    def slo_violation_rate(self) -> float:
        return self.slo_violations / max(self.handoffs, 1)


@dataclass
class _InstanceRun:
    """Per-instance execution state threaded through the phase methods."""
    wf: Workflow
    session: StateSession
    placement: Dict[str, str]
    metrics: InstanceMetrics
    keys: Dict[str, StateKey] = field(default_factory=dict)
    sizes: Dict[str, float] = field(default_factory=dict)
    payloads: Dict[str, object] = field(default_factory=dict)


class WorkflowEngine:
    def __init__(self, net: ContinuumNetwork, strategy="databelt",
                 slo: SLO = SLO(), fusion_depth: int = 1,
                 real_compute: bool = False, seed: int = 0,
                 mode: str = "event",
                 region_weight: float = 0.3, device="cuda"):
        """``strategy`` is a registered strategy name (``"databelt"`` /
        ``"random"`` / ``"stateless"`` / anything added via
        ``repro_torch.core.strategy.register_strategy``) or an already-built
        ``StateStrategy`` instance.  ``mode`` selects the
        ``StateSession`` queueing style: ``"event"`` (default) parks
        storage ops on the KVS FIFOs like CPU slots so autoscale capacity
        grows re-admit already-queued ops; ``"analytic"`` is the
        committed-schedule opt-out, pinned bit-identical to the
        pre-event-driven engine.  ``region_weight`` scales the planner's
        region-locality term; it only takes effect on multi-region
        topologies (several cloud nodes), so single-region runs are
        bit-identical to the pre-region engine.  ``device`` is where the
        real-compute payloads and bodies run (resolved, and CUDA required
        when asked for, only when ``real_compute`` is on: a virtual run
        touches no device)."""
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}; choose one "
                             f"of {MODES}")
        self.net = net
        self.slo = slo
        self.fusion_depth = max(fusion_depth, 1)
        self.real_compute = real_compute
        # differs from repro/serverless/engine.py:133: the real-compute device
        self.device = resolve_device(device) if real_compute else None
        self.mode = mode
        # region awareness activates only when the topology actually has
        # several cloud regions
        self.clouds = sorted(
            n.id for n in net.graph_at(0.0).nodes.values()
            if n.kind == "cloud")
        self.multi_region = len(self.clouds) > 1
        self.region_weight = region_weight if self.multi_region else 0.0
        # one resource pool per engine: CPU slots (one per core) + KVS
        # queues, shared with the storage layer so every strategy contends
        # on the same queues
        self._cpu_slot_cache: Dict[str, int] = {}
        # id(Workflow) -> (Workflow, WorkflowSpec); the strong ref keeps
        # the id stable for the cache's lifetime
        self._spec_cache: Dict[int, tuple] = {}
        self.resources = ResourcePool(cpu_capacity=self._cpu_slots)
        self.storage = TwoTierStorage(net.graph_at,
                                      resources=self.resources)
        self.placer = make_strategy(strategy, net.graph_at, net.available,
                                    slo, seed=seed)
        # report label: registry name, or the class name for prebuilt
        # instances of unregistered strategies
        self.strategy = self.placer.name or type(self.placer).__name__
        # planner load signal: mapping-like view over the CPU resources
        self.node_busy_until = self.resources.busy_view(ResourcePool.CPU)

    def _cpu_slots(self, node_id: str) -> int:
        # memoized: resolving the t=0 snapshot per admission both costs a
        # dict of work and evicts the network's last-answer snapshot memo
        slots = self._cpu_slot_cache.get(node_id)
        if slots is None:
            node = self.net.graph_at(0.0).nodes.get(node_id)
            slots = max(1, int(node.cpu)) if node is not None else 1
            self._cpu_slot_cache[node_id] = slots
        return slots

    # ------------------------------------------------------------------
    def place_functions(self, wf: Workflow, t: float,
                        entry: str = "drone0") -> Dict[str, str]:
        # plan directly on the shared snapshot: its SSSP caches stay warm
        # across every instance planned in the same quantum (the old
        # copy_shallow threw them away per plan).  Node resource
        # accounting is per-plan: the undo log restores the exact prior
        # values, so concurrent instances observe an unmutated graph.
        graph = self.net.graph_at(t)
        # one spec per Workflow object: every instance of the same
        # workflow shares it, so the spec's topo-order/predecessor memos
        # actually amortize (a fresh spec per plan re-derived them)
        cached = self._spec_cache.get(id(wf))
        if cached is not None and cached[0] is wf:
            spec = cached[1]
        else:
            spec = WorkflowSpec(
                functions=[f.name for f in wf.functions],
                edges=wf.edges,
                demands={f.name: f.demand for f in wf.functions},
                state_sizes={},
                sink_kind="cloud" if wf.sink_in_cloud else "",
            )
            self._spec_cache[id(wf)] = (wf, spec)
        undo: list = []
        try:
            plan = plan_workflow(graph, spec, self.slo, entry_node=entry,
                                 busy=self.node_busy_until, now=t,
                                 home_nodes=self.clouds
                                 if self.multi_region else None,
                                 region_weight=self.region_weight,
                                 undo_log=undo)
        finally:
            undo_plan(undo)
        return plan.placement

    # ------------------------------------------------------------------
    # instance phases: fetch -> execute -> offload, session-only
    # ------------------------------------------------------------------
    def _fetch_group(self, kernel: SimKernel, run: _InstanceRun, g):
        """Grouped state fetch for one fusion group: resolve the inputs of
        every function in the group through the session (one fused request
        per source node when the group is fused), account per-key SLO
        compliance on the pure network handoff, and overlap the fetch with
        the sandbox cold start."""
        wf, m, session = run.wf, run.metrics, run.session
        node = g.node_id
        need: List[StateKey] = []
        seen_fids = set()
        for fname in g.function_ids:
            preds = wf.predecessors(fname) or ["__input__"]
            for p in preds:
                k = run.keys.get(p)
                if k is not None and k.function_id not in seen_fids:
                    seen_fids.add(k.function_id)
                    need.append(k)
        # per-key SLO accounting uses the *network* handoff (path latency
        # + wire transfer, paper: "includes all data transfer"), and
        # skips the workflow ingress (not a function pair in E)
        for k in need:
            if k.function_id == "__input__":
                continue
            m.handoffs += 1
            if session.peek_network_latency(k, node) \
                    > self.slo.max_handoff_s:
                m.slo_violations += 1
        t_fetch = kernel.now
        # a fused read serves two shapes: a multi-function group (chain
        # fusion) and — when fusion is on — a fan-in whose single
        # function consumes several branch states sharing its runtime
        # (ONE get_fused over all branch states, paper §4.2 extended to
        # DAGs).  Chains never have multi-predecessor functions, so the
        # fan-in arm is unreachable on the pinned linear path.
        if len(g.function_ids) > 1 or \
                (self.fusion_depth > 1 and len(need) > 1):
            _, res = yield from session.get_fused(need, node)
            m.storage_ops += len({k.storage_address for k in need
                                  if k.storage_address != node} or {1})
            m.reads += len(need)
            m.local_reads += len(need) if res.local else 0
            m.global_reads += res.global_keys
            m.hops.extend([res.hops] * len(need))
            m.read_time += res.latency
            # one sandbox for the whole group; the grouped prefetch
            # overlaps with sandbox init — sleep whatever the fetch did
            # not already consume
            elapsed = kernel.now - t_fetch
            yield max(0.0, SANDBOX_INIT_S - elapsed, res.latency - elapsed)
        else:
            lat_sum, hops_list, nloc = 0.0, [], 0
            for k in need:
                _, r = yield from session.get(k, node)
                lat_sum += r.latency
                hops_list.append(r.hops)
                nloc += 1 if r.local else 0
                m.global_reads += 1 if r.from_global else 0
                m.storage_ops += 1
            m.reads += len(need)
            m.local_reads += nloc
            m.hops.extend(hops_list)
            m.read_time += lat_sum
            # one sandbox per function; sleep whatever the per-function
            # reads did not already consume
            elapsed = kernel.now - t_fetch
            yield max(0.0, SANDBOX_INIT_S * len(g.function_ids)
                      + lat_sum - elapsed)

    def _execute_group(self, kernel: SimKernel, run: _InstanceRun, g):
        """Execute the group's (possibly fused) functions: virtual compute
        time from input bytes, plus the real torch body when enabled."""
        wf, m = run.wf, run.metrics
        for fname in g.function_ids:
            fn = wf.fn(fname)
            preds = wf.predecessors(fname) or ["__input__"]
            in_bytes = sum(run.sizes.get(p, 0.0) for p in preds)
            if wf.chunk:
                # ranked sibling: consumes its 1/N chunk of the
                # predecessor's output (empty for every linear chain)
                in_bytes *= wf.chunk.get(fname, 1.0)
            ct = fn.virtual_compute_time(in_bytes)
            if self.real_compute and fn.compute is not None:
                merged = {}
                for p in preds:
                    pl = run.payloads.get(p)
                    if isinstance(pl, dict):
                        merged.update(pl)
                # repro: allow(DB001): real_compute=True folds the
                # body's actual wall time into simulated compute time —
                # a documented nondeterminism opt-in (off for every
                # golden-pinned figure)
                w0 = _time.perf_counter()   # repro: allow(DB001): see above
                run.payloads[fname] = fn.compute(merged) if merged else {}
                # differs from repro/serverless/engine.py:301-302: wait for
                # the body's device work, so that the clock reads it and not
                # only its launch
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                ct += _time.perf_counter() - w0  # repro: allow(DB001): see above
            m.compute_time += ct
            yield ct
            run.sizes[fname] = in_bytes * fn.out_ratio

    def _offload_group(self, kernel: SimKernel, run: _InstanceRun, g):
        """Strategy-planned state offload.  Fused groups persist only
        their OUTGOING states (consumed outside the group or terminal) in
        ONE merged request; intermediates stay in-process in the
        middleware (paper §4.2, Fig 15: storage cost constant in fusion
        depth)."""
        wf, m, session = run.wf, run.metrics, run.session
        node = g.node_id
        in_group = set(g.function_ids)
        outgoing = []
        for fname in g.function_ids:
            consumers = wf.successors(fname)
            if not consumers or any(c not in in_group for c in consumers):
                outgoing.append(fname)
        for fname in g.function_ids:
            nxt = wf.successors(fname)
            dst = run.placement.get(nxt[0]) if nxt else None
            if dst is not None:
                self.placer.plan_state_placement(fname, node, dst,
                                                 run.sizes[fname],
                                                 kernel.now)
            elif self.multi_region:
                # terminal state: propagate toward the nearest cloud
                # region (the key's fallback-serving shard)
                self.placer.plan_terminal_state(fname, node,
                                                run.sizes[fname],
                                                kernel.now)
            key = StateKey(wf.workflow_id, node, fname)
            run.keys[fname] = self.placer.offload_state(fname, node,
                                                        kernel.now, key)
        if len(g.function_ids) > 1:
            merged = sum(max(run.sizes[f], 1.0) for f in outgoing)
            t_w = kernel.now
            r = yield from session.put(run.keys[outgoing[-1]], merged,
                                       writer=node,
                                       global_sync=self.placer.global_sync)
            # register the remaining outgoing keys without re-charging
            for f in outgoing[:-1]:
                yield from session.put(run.keys[f],
                                       max(run.sizes[f], 1.0),
                                       writer=node, account=False)
            m.write_time += r.latency
            m.storage_ops += 1
            pending = r.latency - (kernel.now - t_w)
            if pending > 0:
                yield pending
        else:
            for fname in outgoing:
                t_w = kernel.now
                r = yield from session.put(
                    run.keys[fname], max(run.sizes[fname], 1.0),
                    writer=node, global_sync=self.placer.global_sync)
                m.write_time += r.latency
                m.storage_ops += 1
                pending = r.latency - (kernel.now - t_w)
                if pending > 0:
                    yield pending

    # ------------------------------------------------------------------
    # DAG execution: branches as concurrent child kernel processes
    # ------------------------------------------------------------------
    def _condition_payload(self, run: _InstanceRun, src: str) -> dict:
        """Payload a conditional edge's predicate sees when ``src``
        completes: the real function output when ``real_compute``
        produced one, over a deterministic synthetic base (workflow id,
        source name, produced bytes) so virtual-compute conditions stay
        replay-stable."""
        base = {"workflow_id": run.wf.workflow_id, "function": src,
                "out_bytes": run.sizes.get(src, 0.0)}
        pl = run.payloads.get(src)
        if isinstance(pl, dict):
            base.update(pl)
        return base

    def _dag_run(self, kernel: SimKernel, run: _InstanceRun, gg, rec,
                 root, lane: str):
        """Run a non-linear workflow: every fusion group is a child
        kernel process sharing the instance's storage, key/size maps and
        metrics; the last-resolving predecessor launches each successor
        group (dataflow — joins never poll) and a ``DagSchedule``
        settles conditional skips so a skipped branch releases its sync
        barrier deterministically.  The instance process itself parks on
        a capacity-0 join latch; the last finishing group opens it —
        the same drain/grow machinery the autoscaler already replays
        deterministically.

        Tracing: each group gets its own lane (``inst:<wid>/<gid>``) so
        branches render as parallel tracks under the shared root span,
        plus a ``barrier_wait`` span from a join's first-arrived edge to
        its launch.  Children use per-branch ``StateSession`` facades
        over the same storage, so concurrent storage-op spans nest under
        the right branch's phase span."""
        wf, m = run.wf, run.metrics
        sched = DagSchedule(gg, wf)
        latch = SlotResource(f"dag:{wf.workflow_id}", 1)
        latch.set_capacity(0, kernel.now)

        def eval_edge(u: str, v: str) -> bool:
            cond = wf.conditions.get((u, v))
            if cond is None:
                return True
            return bool(cond(self._condition_payload(run, u)))

        def launch(g, t_first):
            if rec is not None and t_first is not None \
                    and kernel.now > t_first \
                    and len(gg.preds[g.group_id]) > 1:
                rec.complete("barrier_wait", "phase",
                             f"{lane}/{g.group_id}", t_first, kernel.now,
                             parent=root, node=g.node_id,
                             group=g.group_id)
            kernel.spawn(group_proc(g),
                         label=f"{wf.workflow_id}:{g.group_id}")

        def settle(gid: str):
            spawns, skips = sched.resolve(gid, kernel.now, eval_edge)
            for sgid in skips:
                kernel.log(f"{wf.workflow_id}:skip:{sgid}")
                if rec is not None:
                    rec.instant("branch_skip", "phase", lane, group=sgid)
            for g, t_first in spawns:
                launch(g, t_first)
            if sched.remaining == 0:
                for proc, lbl, _w in latch.set_capacity(1, kernel.now):
                    kernel.wake(proc, lbl)

        def group_proc(g):
            # per-branch session facade: same storage/kernel/mode (ONE
            # continuous data path), private trace_parent so concurrent
            # branches attribute their storage spans correctly
            grun = _InstanceRun(
                wf=wf, session=StateSession(self.storage, kernel,
                                            mode=self.mode),
                placement=run.placement, metrics=m, keys=run.keys,
                sizes=run.sizes, payloads=run.payloads)
            glane = f"{lane}/{g.group_id}" if rec is not None else lane
            cpu = self.resources.cpu(g.node_id)
            t_acq = kernel.now
            yield ("acquire", cpu)
            if rec is not None and kernel.now > t_acq:
                rec.complete("cpu_wait", "phase", glane, t_acq,
                             kernel.now, parent=root, node=g.node_id)
            kernel.log(f"{wf.workflow_id}:start:{g.group_id}")
            sid = None
            if rec is not None:
                r0, h0 = m.reads, len(m.hops)
                g0, rt0 = m.global_reads, m.read_time
                sid = rec.begin("fetch", "phase", glane, parent=root,
                                node=g.node_id, group=g.group_id)
                grun.session.trace_parent = sid
            yield from self._fetch_group(kernel, grun, g)
            if rec is not None:
                rec.end(sid, reads=m.reads - r0,
                        hops=max(m.hops[h0:], default=0),
                        global_reads=m.global_reads - g0,
                        read_time_s=m.read_time - rt0)
                c0 = m.compute_time
                sid = rec.begin("execute", "phase", glane, parent=root,
                                node=g.node_id, group=g.group_id,
                                functions=len(g.function_ids))
                grun.session.trace_parent = sid
            yield from self._execute_group(kernel, grun, g)
            if rec is not None:
                rec.end(sid, compute_time_s=m.compute_time - c0)
                w0, s0 = m.write_time, m.storage_ops
                sid = rec.begin("offload", "phase", glane, parent=root,
                                node=g.node_id, group=g.group_id)
                grun.session.trace_parent = sid
            yield from self._offload_group(kernel, grun, g)
            if rec is not None:
                rec.end(sid, write_time_s=m.write_time - w0,
                        storage_ops=m.storage_ops - s0)
            kernel.log(f"{wf.workflow_id}:done:{g.group_id}")
            yield ("release", cpu)
            settle(g.group_id)

        for g in gg.entry_groups():
            launch(g, None)
        if sched.remaining:
            # park until the last group (or skip cascade) opens the latch
            yield ("acquire", latch)
            yield ("release", latch)

    # ------------------------------------------------------------------
    def _instance_proc(self, kernel: SimKernel, wf: Workflow,
                       input_bytes: float, entry: str,
                       m: InstanceMetrics):
        """One workflow instance as a discrete-event process: a fresh
        ``StateSession`` plus the fetch/execute/offload phases per fusion
        group, all yielding timed steps on the shared kernel."""
        t0 = kernel.now
        session = StateSession(self.storage, kernel, mode=self.mode)
        placement = self.place_functions(wf, kernel.now, entry)
        # linear workflows (every chain, the flood DAG's path) keep the
        # sequential pre-DAG path verbatim — same events, same sequence
        # numbers, bit-identical goldens.  Real DAGs run branches as
        # concurrent child processes joining at sync barriers.
        linear = wf.is_linear
        if linear:
            gg = None
            groups = plan_fusion_groups(wf.order(), placement,
                                        max_depth=self.fusion_depth)
        else:
            gg = plan_dag_groups(wf, placement,
                                 max_depth=self.fusion_depth)
            groups = gg.groups
        run = _InstanceRun(wf=wf, session=session, placement=placement,
                           metrics=m)

        # flight recorder: one root span per instance, phase child spans
        # (ingress / cpu_wait / fetch / execute / offload) covering its
        # whole wall time, storage-op spans nesting under the phases via
        # session.trace_parent.  Every hook is one ``is not None`` check
        # so the untraced hot path allocates nothing.
        rec = kernel.recorder
        root = sid = None
        lane = ""
        if rec is not None:
            lane = f"inst:{wf.workflow_id}"
            root = rec.begin(wf.workflow_id, "instance", lane,
                             strategy=self.strategy, entry=entry,
                             groups=len(groups))

        # the workflow input arrives at the entry node
        src_key = StateKey(wf.workflow_id, entry, "__input__")
        if rec is not None:
            sid = rec.begin("ingress", "phase", lane, parent=root,
                            node=entry)
            session.trace_parent = sid
        yield from session.put(src_key, input_bytes, writer=entry)
        if rec is not None:
            rec.end(sid, bytes=input_bytes)
        run.keys["__input__"] = src_key
        run.sizes["__input__"] = input_bytes
        if self.real_compute:
            # differs from repro/serverless/engine.py:542: on the device
            run.payloads["__input__"] = make_payload(input_bytes,
                                                     device=self.device)

        if not linear:
            yield from self._dag_run(kernel, run, gg, rec, root, lane)
            groups = ()   # the DAG scheduler ran them all

        for g in groups:
            # claim a CPU slot on the node (contention model) for the
            # whole fetch -> execute -> offload span
            cpu = self.resources.cpu(g.node_id)
            t_acq = kernel.now
            yield ("acquire", cpu)
            if rec is not None and kernel.now > t_acq:
                rec.complete("cpu_wait", "phase", lane, t_acq,
                             kernel.now, parent=root, node=g.node_id)
            kernel.log(f"{wf.workflow_id}:start:{g.group_id}")
            if rec is not None:
                r0, h0 = m.reads, len(m.hops)
                g0, rt0 = m.global_reads, m.read_time
                sid = rec.begin("fetch", "phase", lane, parent=root,
                                node=g.node_id, group=g.group_id)
                session.trace_parent = sid
            yield from self._fetch_group(kernel, run, g)
            if rec is not None:
                rec.end(sid, reads=m.reads - r0,
                        hops=max(m.hops[h0:], default=0),
                        global_reads=m.global_reads - g0,
                        read_time_s=m.read_time - rt0)
                c0 = m.compute_time
                sid = rec.begin("execute", "phase", lane, parent=root,
                                node=g.node_id, group=g.group_id,
                                functions=len(g.function_ids))
                session.trace_parent = sid
            yield from self._execute_group(kernel, run, g)
            if rec is not None:
                rec.end(sid, compute_time_s=m.compute_time - c0)
                w0, s0 = m.write_time, m.storage_ops
                sid = rec.begin("offload", "phase", lane, parent=root,
                                node=g.node_id, group=g.group_id)
                session.trace_parent = sid
            yield from self._offload_group(kernel, run, g)
            if rec is not None:
                rec.end(sid, write_time_s=m.write_time - w0,
                        storage_ops=m.storage_ops - s0)
                session.trace_parent = root
            kernel.log(f"{wf.workflow_id}:done:{g.group_id}")
            yield ("release", cpu)

        m.latency = kernel.now - t0
        # resource proxies (paper Table 2 reports flat ~16% CPU / ~1.4GB)
        m.cpu_pct = self.placer.cpu_pct_proxy
        m.ram_mb = self.placer.ram_mb_proxy
        if rec is not None:
            rec.end(root, latency_s=m.latency,
                    slo_violations=m.slo_violations, reads=m.reads,
                    local_reads=m.local_reads,
                    global_reads=m.global_reads)
            mr = rec.metrics
            mr.counter("instances").add(1)
            mr.counter("slo_violations").add(m.slo_violations)
            mr.histogram("instance.latency_s").observe(m.latency)
            mr.histogram("instance.read_time_s").observe(m.read_time)
            mr.histogram("instance.write_time_s").observe(m.write_time)

    # ------------------------------------------------------------------
    def run_instance(self, wf: Workflow, input_bytes: float, t0: float = 0.0,
                     entry: str = "drone0",
                     trace=None) -> InstanceMetrics:
        """Run ONE instance to completion on a private event loop (shared
        storage + resource queues, so sequential calls still observe each
        other's leftover backlog, as on a long-lived deployment).

        ``trace`` attaches a flight recorder: pass ``True`` for a fresh
        ``repro_torch.sim.trace.SpanRecorder`` or an existing recorder to
        accumulate several sequential instances into one stream (the
        recorder is re-bound to this instance's private kernel)."""
        kernel = SimKernel(start=t0)
        recorder = None
        if trace:
            recorder = trace if isinstance(trace, SpanRecorder) \
                else SpanRecorder()
            recorder.bind(kernel)
            kernel.recorder = recorder
            self.storage.recorder = recorder
        m = InstanceMetrics()
        kernel.spawn(self._instance_proc(kernel, wf, input_bytes, entry, m),
                     label=wf.workflow_id)
        try:
            kernel.run()
        finally:
            if recorder is not None:
                self.storage.recorder = None
        return m

    # ------------------------------------------------------------------
    def run_parallel(self, wf_maker, n: int, input_bytes: float,
                     t0: float = 0.0, stagger: float = 0.05,
                     entry: str = "drone0", workload=None,
                     record_trace: bool = False,
                     autoscale: Optional[AutoscalePolicy] = None,
                     faults: Optional[FaultPlan] = None,
                     collect: str = "full",
                     lazy_arrivals: bool = False,
                     trace=None,
                     race_detect: bool = False
                     ) -> ParallelReport:
        """n truly concurrent workflow instances on one shared event loop.

        ``workload`` is a ``repro_torch.sim.workload`` generator (default:
        ``UniformStagger(stagger)``).  Returns a ``ParallelReport`` with
        per-instance metrics (list-indexable for compatibility) plus
        throughput, p50/p95/p99 latency and per-node queue statistics.
        Use a fresh engine per call when comparing runs — resource queues
        accumulate over the engine's lifetime.

        ``autoscale`` attaches an SLO-aware capacity controller: a daemon
        process on the same kernel that grows/shrinks the per-node CPU and
        KVS pools from observed queue depth and the rolling p95 of
        completed instances (``repro_torch.sim.autoscale``).  The run stays
        deterministically replayable; the report carries the controller's
        actions in ``report.autoscale``.

        ``entry`` may be a node id (all instances enter there) or a
        callable ``instance_index -> node id`` — a multi-region sweep
        spreads instances over per-region entry points this way.  A
        region-aware workload generator (``repro_torch.sim.workload.
        RegionalDiurnal``) provides such a callable as ``entry_for``.

        ``faults`` attaches a churn schedule (``repro_torch.sim.faults``): node
        drains/restores and link losses replayed at exact simulated times
        on the same kernel — drains park new work without preempting
        anything in flight, and the topology routes around down nodes so
        reads exercise the global tier's cross-region fallback.  Requires
        the event-driven engine mode; the report carries the injector's
        actions in ``report.faults``.

        Scale knobs (both value-preserving opt-ins, defaults keep every
        seeded run bit-identical to the pre-scale engine):

        * ``collect="aggregate"`` folds each completing instance into a
          running ``FleetAggregate`` (count/sum stats + P² quantile
          sketches) instead of materializing per-instance metric lists —
          constant memory in ``n``, the difference between a 100k run
          fitting in RAM or not.  Event order is untouched; only the
          bookkeeping after each completion changes.
        * ``lazy_arrivals=True`` spawns instances from a single feeder
          process at their arrival times instead of pre-scheduling all n
          generators into the heap upfront — heap size and generator
          count then track the *in-flight* population, not ``n``.  The
          feeder's events take different sequence numbers than eager
          pre-scheduling, so same-timestamp ties can break differently:
          off by default, and the golden-pinned figures never enable it.

        ``trace`` attaches the flight recorder (``repro_torch.sim.trace``):
        pass ``True`` for a fresh ``SpanRecorder`` or an existing one;
        the report's ``trace_report`` then carries the frozen
        ``TraceReport`` (spans, instants, metric snapshot).  Recording
        never touches event order — a traced run's metrics are
        bit-identical to the untraced run (pinned in
        ``tests/test_trace.py``).

        ``race_detect=True`` attaches the happens-before race sanitizer
        (``repro_torch.sim.races``): shared-state accesses — storage buckets,
        the global tier, topology overrides, slot capacities, the
        autoscaler's latency window — are checked for same-timestamp
        conflicts no spawn/wake/acquire-release edge orders.  Detection
        is passive (never schedules events), so metrics and traces stay
        bit-identical; the findings land in ``report.races``.
        """
        if collect not in ("full", "aggregate"):
            raise ValueError(f"unknown collect mode {collect!r}; choose "
                             f"'full' or 'aggregate'")
        if faults is not None and self.mode != "event":
            raise ValueError(
                "fault injection needs mode='event' — analytic "
                "committed-schedule accounting cannot park requests on a "
                "drained node")
        kernel = SimKernel(start=t0, record_trace=record_trace,
                           race_detect=race_detect)
        if race_detect:
            self.net._race_kernel = kernel
        recorder = None
        if trace:
            recorder = trace if isinstance(trace, SpanRecorder) \
                else SpanRecorder()
            recorder.bind(kernel)
            kernel.recorder = recorder
            self.storage.recorder = recorder
        scaler = Autoscaler(kernel, self.resources, autoscale).start() \
            if autoscale is not None else None
        injector = FaultInjector(kernel, self.net, self.resources,
                                 faults).start() \
            if faults is not None else None
        agg = FleetAggregate() if collect == "aggregate" else None
        results: List[tuple] = []

        def wrap(i: int):
            def proc():
                wf = wf_maker(f"wf{i}")
                start = kernel.now
                m = InstanceMetrics()
                e = entry(i) if callable(entry) else entry
                yield from self._instance_proc(kernel, wf, input_bytes,
                                               e, m)
                if agg is not None:
                    agg.observe(m, start, kernel.now)
                else:
                    results.append((i, m, start, kernel.now))
                if scaler is not None:
                    scaler.observe_latency(m.latency)
            return proc()

        workload = workload or UniformStagger(stagger)
        if getattr(workload, "closed", False):
            idx = 0
            for c, count in enumerate(workload.per_client(n)):
                ids = list(range(idx, idx + count))
                idx += count

                def client(ids=ids):
                    for i in ids:
                        yield from wrap(i)
                        if workload.think_time > 0:
                            yield workload.think_time
                kernel.spawn(client(), label=f"client{c}")
        elif lazy_arrivals:
            def feeder():
                for i, at in enumerate(iter_arrivals(workload, n, t0)):
                    gap = at - kernel.now
                    if gap > 0:
                        yield gap
                    kernel.spawn(wrap(i), label=f"wf{i}")
            # non-daemon: the feeder itself keeps the run alive until the
            # last instance has been spawned
            kernel.spawn(feeder(), label="arrivals")
        else:
            for i, at in enumerate(workload.arrivals(n, t0)):
                kernel.spawn(wrap(i), label=f"wf{i}", at=at)

        # The event loop allocates millions of short-lived tuples and
        # generator frames that plain refcounting already reclaims; the
        # cyclic collector's periodic full-heap scans over that population
        # were >20% of a 10k-instance run's wall clock.  Pause it for the
        # loop (values are untouched — GC never affects event order) and
        # restore unconditionally; one collect afterwards picks up any
        # cycles the run did make.
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            kernel.run()
        finally:
            if gc_was_enabled:
                gc.enable()
                gc.collect()
            if recorder is not None:
                self.storage.recorder = None
            if race_detect:
                self.net._race_kernel = None
        common = dict(
            pool=self.resources,
            events_processed=kernel.events_processed,
            trace=kernel.trace,
            autoscale=scaler.report() if scaler is not None else None,
            faults=injector.report() if injector is not None else None,
            trace_report=recorder.report()
            if recorder is not None else None,
            races=list(kernel.races.reports)
            if kernel.races is not None else None)
        if agg is not None:
            return ParallelReport.build_aggregate(agg, **common)
        results.sort(key=lambda r: r[0])
        return ParallelReport.build(
            instances=[r[1] for r in results],
            start_times=[r[2] for r in results],
            end_times=[r[3] for r in results],
            **common)
