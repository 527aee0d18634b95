"""The declarative Scenario run-spec: one front door for every experiment.

The paper's headline claims (66% workflow-time cut, 50% throughput gain)
are properties of a *configuration* — topology, workload, state strategy,
autoscale policy, churn — yet every benchmark used to hand-wire
``ContinuumNetwork`` + ``WorkflowEngine`` + ``run_parallel`` with its own
ad-hoc kwargs.  Following HyperDrive's and Cosmos's scenario-grid
evaluations, a ``Scenario`` names the whole configuration declaratively::

    from repro_torch.scenario import NetworkSpec, Scenario, WorkloadSpec

    sc = Scenario(network=NetworkSpec(regions=2),
                  workload=WorkloadSpec(kind="regional_diurnal", rate=8.0),
                  strategy="databelt", n=48, input_bytes=2e6)
    report = sc.run()
    print(report.p95, report.row())

* ``Scenario.run() -> ScenarioReport`` builds the network, engine,
  workload, autoscaler and fault injector and drives the run — the
  construction is *exactly* the hand-wired path (golden tests pin the
  fig13/fig14/fig17 configurations bit-identical to it).
* ``to_dict()`` / ``Scenario.from_dict()`` round-trip through plain JSON
  types, so specs live in registries, CI smoke steps and artifact files.
* ``sweep(**axes)`` expands a grid (``sweep(strategy=[...], n=[...])``;
  nested fields via ``network__regions=[1, 2, 4]``) in deterministic
  order — the benchmark sweeps are one call.
* ``faults=FaultPlan(...)`` attaches scheduled churn
  (``repro_torch.sim.faults``); event mode only.

Workload kinds: ``stagger`` / ``poisson`` / ``closed_loop`` /
``regional_diurnal`` map onto the ``repro_torch.sim.workload`` generators and
drive the concurrent ``run_parallel`` path; ``sequential`` replays the
classic one-instance-at-a-time evaluation (``run_instance`` every
``spacing`` seconds — paper Table 2 / Figs 2, 10) on a shared engine.
"""
from __future__ import annotations

import itertools
from dataclasses import asdict, dataclass, field, replace
from typing import Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.continuum.network import ContinuumNetwork
from repro_torch.continuum.orbits import Constellation
from repro_torch.continuum.regions import (MultiConstellation, ShellSpec,
                                     multiregion_network)
from repro_torch.continuum.session import MODES
from repro_torch.core.slo import SLO
from repro_torch.core.strategy import StateStrategy
from repro_torch.serverless.dag import (branch_workflow, conditional_workflow,
                                  diamond_workflow, fanout_workflow)
from repro_torch.serverless.engine import WorkflowEngine
from repro_torch.serverless.workflow import (Workflow, chain_workflow,
                                       flood_workflow)
from repro_torch.sim.autoscale import AutoscalePolicy
from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.metrics import ParallelReport
from repro_torch.sim.workload import (ClosedLoop, OpenLoopPoisson,
                                RegionalDiurnal, UniformStagger)

WORKLOAD_KINDS = ("stagger", "poisson", "closed_loop", "regional_diurnal",
                  "sequential")


# ---------------------------------------------------------------------------
# network spec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NetworkSpec:
    """Declarative continuum topology.

    ``regions=None`` (default) is the paper's single-DC deployment: one
    Walker shell of ``planes`` x ``sats_per_plane`` satellites over the
    default cloud/edge/drone/EO/ground sites.  ``regions=N`` builds the
    multi-region continuum (``repro_torch.continuum.regions``): N cloud
    regions, layered default shells (or the explicit ``shells``), WAN
    backbone, region-sharded global tier."""
    planes: int = 8
    sats_per_plane: int = 8
    regions: Optional[int] = None
    shells: Optional[Tuple[ShellSpec, ...]] = None
    require_kinds: Optional[Tuple[str, ...]] = None

    def build(self) -> ContinuumNetwork:
        if self.regions is not None:
            return multiregion_network(self.regions, shells=self.shells,
                                       require_kinds=self.require_kinds)
        if self.shells is not None:
            return ContinuumNetwork(MultiConstellation(self.shells),
                                    require_kinds=self.require_kinds)
        return ContinuumNetwork(
            Constellation(self.planes, self.sats_per_plane),
            require_kinds=self.require_kinds)

    def to_dict(self) -> dict:
        return {
            "planes": self.planes, "sats_per_plane": self.sats_per_plane,
            "regions": self.regions,
            "shells": [asdict(s) for s in self.shells]
            if self.shells is not None else None,
            "require_kinds": list(self.require_kinds)
            if self.require_kinds is not None else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkSpec":
        shells = d.get("shells")
        kinds = d.get("require_kinds")
        return cls(
            planes=int(d.get("planes", 8)),
            sats_per_plane=int(d.get("sats_per_plane", 8)),
            regions=d.get("regions"),
            shells=tuple(ShellSpec(**s) for s in shells)
            if shells is not None else None,
            require_kinds=tuple(kinds) if kinds is not None else None,
        )


# ---------------------------------------------------------------------------
# workload spec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative arrival process + entry mapping.

    ``kind`` selects the generator: ``stagger`` (open loop, fixed gap),
    ``poisson`` (open loop, exponential gaps at ``rate`` rps),
    ``closed_loop`` (``clients`` clients, back-to-back + ``think_time``),
    ``regional_diurnal`` (per-region Poisson with follow-the-sun phase
    offsets; instances enter at the generating region via
    ``entry_template``), or ``sequential`` (one instance at a time,
    ``spacing`` seconds apart — the paper's Table 2 regime).  ``seed``
    defaults to the scenario seed; ``regions`` defaults to the network's
    region count."""
    kind: str = "stagger"
    stagger: float = 0.05
    rate: float = 10.0
    clients: int = 4
    think_time: float = 0.0
    regions: Optional[int] = None
    peak_to_trough: float = 3.0
    period_s: float = 240.0
    seed: Optional[int] = None
    entry: str = "drone0"
    entry_template: str = "drone{r}"
    spacing: float = 90.0

    def build(self, default_regions: Optional[int], default_seed: int):
        """Instantiate ``(workload, entry)`` for ``run_parallel``."""
        seed = self.seed if self.seed is not None else default_seed
        if self.kind == "stagger":
            return UniformStagger(self.stagger), self.entry
        if self.kind == "poisson":
            return OpenLoopPoisson(self.rate, seed), self.entry
        if self.kind == "closed_loop":
            return ClosedLoop(self.clients, self.think_time), self.entry
        if self.kind == "regional_diurnal":
            w = RegionalDiurnal(
                regions=self.regions or default_regions or 1,
                rate=self.rate, peak_to_trough=self.peak_to_trough,
                period_s=self.period_s, seed=seed,
                entry_template=self.entry_template)
            return w, w.entry_for
        raise ValueError(f"unknown workload kind {self.kind!r}; choose "
                         f"one of {WORKLOAD_KINDS}")

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# workflow registry
# ---------------------------------------------------------------------------
def workflow_maker(spec: str, *, device="cuda") -> Callable[[str], Workflow]:
    """Resolve a workflow spec string into a ``wid -> Workflow`` factory.
    ``"flood"`` is the paper's flood-disaster DAG; ``"chain:<depth>"`` is
    the linear fusion chain (Table 4).  The DAG shape axes
    (``repro_torch.serverless.dag``): ``"branch:<width>"`` (independent
    terminal branches), ``"diamond:<width>"`` (fork/join with a sync
    barrier), ``"fanout:<width>"`` (ranked fan-out — N chunked siblings
    into a sync join), ``"conditional"`` (exactly one of two branches
    runs per instance; the skipped one releases the join barrier).
    ``device`` binds the flood bodies (resolved at their first real call).
    """
    name, _, arg = spec.partition(":")
    if name == "flood":
        # differs from repro/scenario/spec.py:188: bodies bound to a device
        return lambda wid: flood_workflow(wid, device=device)
    if name == "chain":
        depth = int(arg) if arg else 3
        return lambda wid: chain_workflow(wid, depth)
    if name == "branch":
        width = int(arg) if arg else 2
        return lambda wid: branch_workflow(wid, width)
    if name == "diamond":
        width = int(arg) if arg else 2
        return lambda wid: diamond_workflow(wid, width)
    if name == "fanout":
        width = int(arg) if arg else 3
        return lambda wid: fanout_workflow(wid, width)
    if name == "conditional":
        return conditional_workflow
    raise ValueError(f"unknown workflow {spec!r}; known: 'flood', "
                     f"'chain:<depth>', 'branch:<width>', "
                     f"'diamond:<width>', 'fanout:<width>', "
                     f"'conditional'")


# ---------------------------------------------------------------------------
# the scenario itself
# ---------------------------------------------------------------------------
@dataclass
class Scenario:
    """One complete, serializable experiment configuration."""
    network: NetworkSpec = field(default_factory=NetworkSpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    strategy: Union[str, StateStrategy] = "databelt"
    n: int = 16
    input_bytes: float = 2e6
    workflow: str = "flood"
    fusion_depth: int = 1
    mode: str = "event"
    slo: SLO = field(default_factory=SLO)
    region_weight: float = 0.3
    autoscale: Optional[AutoscalePolicy] = None
    faults: Optional[FaultPlan] = None
    seed: int = 0
    real_compute: bool = False
    record_trace: bool = False
    # scale knobs (see ``WorkflowEngine.run_parallel``): ``collect``
    # switches per-instance metric lists for constant-memory running
    # aggregates; ``lazy_arrivals`` feeds instances into the kernel at
    # their arrival times instead of pre-scheduling all n upfront.
    # Defaults preserve bit-identical reports for every pinned figure.
    collect: str = "full"
    lazy_arrivals: bool = False
    # attach the happens-before race sanitizer (repro_torch.sim.races) to the
    # run: passive detection — reports land in ``rep.races``; metrics
    # and traces stay bit-identical to a detection-off run
    race_detect: bool = False

    # -- validation ------------------------------------------------------
    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown engine mode {self.mode!r}; choose "
                             f"one of {MODES}")
        if self.workload.kind not in WORKLOAD_KINDS:
            raise ValueError(
                f"unknown workload kind {self.workload.kind!r}; choose "
                f"one of {WORKLOAD_KINDS}")
        workflow_maker(self.workflow)   # raises on unknown specs
        if self.faults is not None and self.mode != "event":
            raise ValueError("faults need mode='event' — analytic "
                             "accounting cannot park on a drained node")
        if self.workload.kind == "sequential" and (
                self.autoscale is not None or self.faults is not None):
            raise ValueError(
                "sequential workloads run one private kernel per "
                "instance — autoscale/faults need a concurrent kind")
        if self.collect not in ("full", "aggregate"):
            raise ValueError(f"unknown collect mode {self.collect!r}; "
                             f"choose 'full' or 'aggregate'")
        if self.workload.kind == "sequential" and (
                self.collect != "full" or self.lazy_arrivals):
            raise ValueError(
                "collect='aggregate'/lazy_arrivals are run_parallel scale "
                "knobs — sequential workloads never hold a fleet in "
                "memory, so they have nothing to save")
        if self.workload.kind == "sequential" and self.race_detect:
            raise ValueError(
                "race_detect needs concurrent processes on one kernel — "
                "sequential workloads run one private kernel per "
                "instance, so there is nothing to race")

    # -- construction (exactly the hand-wired path) ----------------------
    def build_network(self) -> ContinuumNetwork:
        return self.network.build()

    def build_engine(self,
                     net: Optional[ContinuumNetwork] = None, *,
                     device="cuda") -> WorkflowEngine:
        """Build the engine the spec describes.  A prebuilt
        ``StateStrategy`` instance is a *template*: the scenario always
        re-instantiates its class against the freshly built network with
        the scenario's slo/seed (the standard factory signature) — a
        passed-through instance would stay bound to whatever topology it
        was built on and carry mutable state (RNG position, placement
        memos) across runs, breaking the same-spec ⇒ same-result
        contract.  ``device`` is the engine's real-compute device."""
        if net is None:
            net = self.build_network()
        strategy = self.strategy
        if isinstance(strategy, StateStrategy):
            strategy = type(strategy)(net.graph_at, net.available,
                                      self.slo, seed=self.seed)
        return WorkflowEngine(
            net, strategy=strategy, slo=self.slo,
            fusion_depth=self.fusion_depth,
            real_compute=self.real_compute, seed=self.seed,
            mode=self.mode, region_weight=self.region_weight,
            # differs from repro/scenario/spec.py:300: the device
            device=device)

    # -- execution -------------------------------------------------------
    def run(self, trace=None, *, device="cuda") -> "ScenarioReport":
        """Drive the run this spec describes.  ``trace`` attaches the
        flight recorder (``repro_torch.sim.trace``): pass ``True`` for a fresh
        ``SpanRecorder`` or an existing one; the report then carries a
        ``trace_report`` with per-instance phase spans, storage-tier
        attrs and autoscale/fault instants (``export_perfetto`` for the
        Perfetto UI).  A sequential workload accumulates all n instances
        into one recorder across their private kernels.  ``device`` is
        where ``real_compute`` runs the bodies (CUDA by default, raising
        where there is none); a virtual run touches no device."""
        self.validate()
        # differs from repro/scenario/spec.py:312-313: the device goes to both
        eng = self.build_engine(device=device)
        maker = workflow_maker(self.workflow, device=device)
        recorder = None
        if trace:
            from repro_torch.sim.trace import SpanRecorder
            recorder = trace if isinstance(trace, SpanRecorder) \
                else SpanRecorder()
        if self.workload.kind == "sequential":
            ms, starts, ends = [], [], []
            for i in range(self.n):
                t0 = i * self.workload.spacing
                m = eng.run_instance(maker(f"wf{i}"), self.input_bytes,
                                     t0=t0, entry=self.workload.entry,
                                     trace=recorder)
                ms.append(m)
                starts.append(t0)
                ends.append(t0 + m.latency)
            rep = ParallelReport.build(ms, starts, ends,
                                       pool=eng.resources,
                                       trace_report=recorder.report()
                                       if recorder is not None else None)
        else:
            workload, entry = self.workload.build(self.network.regions,
                                                  self.seed)
            rep = eng.run_parallel(
                maker, self.n, self.input_bytes, workload=workload,
                entry=entry, record_trace=self.record_trace,
                autoscale=self.autoscale, faults=self.faults,
                collect=self.collect, lazy_arrivals=self.lazy_arrivals,
                trace=recorder, race_detect=self.race_detect)
        return ScenarioReport(scenario=self, rep=rep)

    # differs from repro/scenario/spec.py:344: the device of real compute
    def verify_replay(self, *, device="cuda"):
        """Runtime replay sanitizer: run this spec twice with tracing on
        and diff the event traces.  Returns a
        ``repro_torch.analysis.replay.ReplayCheck`` whose ``divergence`` (if
        any) localizes the *first* event where the two runs disagree —
        time, label, payload digest — which is usually within a few
        events of the nondeterministic read itself.  ``device`` is where
        a ``real_compute`` spec runs its bodies; a virtual spec touches no
        device."""
        from repro_torch.analysis.replay import verify_scenario
        # differs from repro/scenario/spec.py:352: the device goes on
        return verify_scenario(self, device=device)

    # differs from repro/scenario/spec.py:354: the device of real compute
    def verify_races(self, *, device="cuda"):
        """Runtime race sanitizer: run this spec once with
        ``race_detect=True`` and return a
        ``repro_torch.analysis.races.RaceCheck``.  Each finding localizes a
        pair of conflicting same-timestamp accesses that no
        spawn/wake/acquire-release happens-before edge orders — the
        interleavings whose outcome rests on the event heap's ``seq``
        tie-break alone.  ``device`` is as for ``verify_replay``."""
        from repro_torch.analysis.races import verify_scenario_races
        # differs from repro/scenario/spec.py:363: the device goes on
        return verify_scenario_races(self, device=device)

    # -- serialization ---------------------------------------------------
    @property
    def strategy_name(self) -> str:
        if isinstance(self.strategy, str):
            return self.strategy
        return self.strategy.name or type(self.strategy).__name__

    def to_dict(self) -> dict:
        if not isinstance(self.strategy, str) and not self.strategy.name:
            raise ValueError(
                f"cannot serialize unregistered strategy instance "
                f"{type(self.strategy).__name__}; register it via "
                f"repro_torch.core.strategy.register_strategy")
        auto = None
        if self.autoscale is not None:
            auto = asdict(self.autoscale)
            auto["kinds"] = list(auto["kinds"])
        return {
            "network": self.network.to_dict(),
            "workload": self.workload.to_dict(),
            "strategy": self.strategy_name,
            "n": self.n,
            "input_bytes": self.input_bytes,
            "workflow": self.workflow,
            "fusion_depth": self.fusion_depth,
            "mode": self.mode,
            "slo": asdict(self.slo),
            "region_weight": self.region_weight,
            "autoscale": auto,
            "faults": self.faults.to_dict()
            if self.faults is not None else None,
            "seed": self.seed,
            "real_compute": self.real_compute,
            "record_trace": self.record_trace,
            "collect": self.collect,
            "lazy_arrivals": self.lazy_arrivals,
            "race_detect": self.race_detect,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        auto = d.get("autoscale")
        if auto is not None:
            auto = AutoscalePolicy(**{**auto,
                                      "kinds": tuple(auto["kinds"])})
        faults = d.get("faults")
        slo = d.get("slo")
        return cls(
            network=NetworkSpec.from_dict(d.get("network", {})),
            workload=WorkloadSpec.from_dict(d.get("workload", {})),
            strategy=d.get("strategy", "databelt"),
            n=int(d.get("n", 16)),
            input_bytes=float(d.get("input_bytes", 2e6)),
            workflow=d.get("workflow", "flood"),
            fusion_depth=int(d.get("fusion_depth", 1)),
            mode=d.get("mode", "event"),
            slo=SLO(**slo) if slo is not None else SLO(),
            region_weight=float(d.get("region_weight", 0.3)),
            autoscale=auto,
            faults=FaultPlan.from_dict(faults)
            if faults is not None else None,
            seed=int(d.get("seed", 0)),
            real_compute=bool(d.get("real_compute", False)),
            record_trace=bool(d.get("record_trace", False)),
            collect=d.get("collect", "full"),
            lazy_arrivals=bool(d.get("lazy_arrivals", False)),
            race_detect=bool(d.get("race_detect", False)),
        )

    # -- grid expansion --------------------------------------------------
    def replace(self, **kw) -> "Scenario":
        """``dataclasses.replace`` convenience (axes one at a time)."""
        return replace(self, **kw)

    def _with_axis(self, key: str, value) -> "Scenario":
        if "__" in key:
            head, sub = key.split("__", 1)
            nested = getattr(self, head)
            return replace(self, **{head: replace(nested, **{sub: value})})
        return replace(self, **{key: value})

    def sweep(self, **axes: Sequence) -> List["Scenario"]:
        """Cartesian grid over this scenario: each axis is
        ``field=[values...]``, nested spec fields via double underscore
        (``network__regions=[1, 2, 4]``, ``workload__rate=[...]``).
        Expansion order is deterministic: the *last* axis varies fastest
        (``itertools.product`` order over the given axes)."""
        keys = list(axes)
        out = []
        for combo in itertools.product(*(axes[k] for k in keys)):
            sc = self
            for k, v in zip(keys, combo):
                sc = sc._with_axis(k, v)
            out.append(sc)
        return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
@dataclass
class ScenarioReport:
    """A ``ParallelReport`` plus the scenario that produced it, with the
    derived row the benchmarks emit."""
    scenario: Scenario
    rep: ParallelReport

    # -- passthrough -----------------------------------------------------
    @property
    def instances(self):
        return self.rep.instances

    @property
    def latencies(self) -> List[float]:
        return self.rep.latencies

    @property
    def throughput_rps(self) -> float:
        return self.rep.throughput_rps

    @property
    def p50(self) -> float:
        return self.rep.p50

    @property
    def p95(self) -> float:
        return self.rep.p95

    @property
    def p99(self) -> float:
        return self.rep.p99

    @property
    def mean_latency(self) -> float:
        return self.rep.mean_latency

    @property
    def trace(self):
        return self.rep.trace

    @property
    def trace_report(self):
        """Flight-recorder ``TraceReport`` when ``run(trace=...)`` was
        traced, else ``None``."""
        return self.rep.trace_report

    @property
    def autoscale(self):
        return self.rep.autoscale

    @property
    def faults(self):
        return self.rep.faults

    @property
    def system(self) -> str:
        return self.scenario.strategy_name

    def max_kvs_depth(self, node: str) -> int:
        return self.rep.max_kvs_depth(node)

    def mean_of(self, fn: Callable) -> float:
        """Average ``fn(instance_metrics)`` over the fleet."""
        ms = self.rep.instances
        return sum(fn(m) for m in ms) / len(ms) if ms else 0.0

    # -- the standard benchmark row --------------------------------------
    def row(self, **extra) -> dict:
        r = {
            "system": self.system,
            "throughput_rps": round(self.throughput_rps, 4),
            "p50_s": round(self.p50, 3),
            "p95_s": round(self.p95, 3),
            "p99_s": round(self.p99, 3),
            "mean_latency_s": round(self.mean_latency, 3),
            "global_fallback_rate": round(self.rep.global_fallback_rate, 4),
            "events": self.rep.events_processed,
        }
        r.update(extra)
        return r
