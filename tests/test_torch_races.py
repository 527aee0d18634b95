"""databelt-race in the port against the reference: the twins of
tests/test_races.py.

Static half: every DB010-DB013 fixture goes through both analyzers (the
port's and the reference's, full battery) and their findings must be
identical before the twin's own assertions run.  Runtime half: the port's
happens-before sanitizer on the planted lost update, its locked twin and
the ordering edges, with the lost update's race reports equal field by
field to the reference's; the fig20-style DAG+churn+autoscale scenario
race-clean through ``Scenario.verify_races()``, and the ``--race-smoke``
spec giving the reference's event count and report.  The scenarios are
virtual: they touch no device.
"""
import dataclasses
import textwrap

import pytest

pytest.importorskip("torch")

import repro.analysis as ja  # noqa: E402
import repro.scenario as jsc  # noqa: E402
import repro.sim.kernel as jkernel  # noqa: E402
import repro_torch.scenario as tsc  # noqa: E402
from repro_torch.analysis import analyze_source, default_config  # noqa: E402
from repro_torch.analysis.races import RaceCheck  # noqa: E402
from repro_torch.scenario import Scenario, WorkloadSpec  # noqa: E402
from repro_torch.sim.kernel import KNOWN_EFFECT_OPS, SimKernel  # noqa: E402
from repro_torch.sim.races import RaceAccess, RaceReport  # noqa: E402
from repro_torch.sim.resources import SlotResource  # noqa: E402


def key(f):
    return (f.code, f.line, f.col, f.message, f.hint, f.suppressed,
            f.allowlisted)


def active_for(src, code):
    src = textwrap.dedent(src)
    out = analyze_source(src, module=None, config=default_config())
    want = ja.analyze_source(src, module=None, config=ja.default_config())
    assert [key(f) for f in out] == [key(f) for f in want]
    return [f for f in out if f.code == code
            and not f.suppressed and not f.allowlisted]


# ---------------------------------------------------------------------------
# DB010 — unmediated shared-attribute conflict across spawned processes
# ---------------------------------------------------------------------------
def test_db010_flags_unmediated_shared_write():
    fs = active_for("""
        def writer(state):
            while True:
                state.count = 1
                yield 1.0

        def reader(state):
            while True:
                v = state.count
                yield 1.0

        def drive(kernel, state):
            kernel.spawn(writer(state))
            kernel.spawn(reader(state))
    """, "DB010")
    assert len(fs) == 1
    assert fs[0].line == 4                      # flagged at the write
    assert "writer" in fs[0].message and "reader" in fs[0].message
    assert "acquire/release" in fs[0].message


def test_db010_clean_when_lock_mediates():
    # both generators acquire the same passed-in resource — the
    # acquire→release edge orders the accesses, whatever the formals
    # are named on each side
    assert active_for("""
        def writer(state, res):
            while True:
                yield ("acquire", res)
                state.count = 1
                yield ("release", res)
                yield 1.0

        def reader(state, guard):
            while True:
                yield ("acquire", guard)
                v = state.count
                yield ("release", guard)
                yield 1.0

        def drive(kernel, state, lock):
            kernel.spawn(writer(state, lock))
            kernel.spawn(reader(state, lock))
    """, "DB010") == []


def test_db010_clean_when_writer_bumps_version():
    assert active_for("""
        def writer(state):
            while True:
                state.count = 1
                state._version += 1
                yield 1.0

        def reader(state):
            while True:
                v = state.count
                yield 1.0

        def drive(kernel, state):
            kernel.spawn(writer(state))
            kernel.spawn(reader(state))
    """, "DB010") == []


def test_db010_clean_on_disjoint_state():
    # two spawn sites but different actuals: nothing is shared
    assert active_for("""
        def writer(state):
            while True:
                state.count = 1
                yield 1.0

        def drive(kernel, a, b):
            kernel.spawn(writer(a))
            kernel.spawn(writer(b))
    """, "DB010") == []


# ---------------------------------------------------------------------------
# DB011 — read-modify-write spanning a yield (lost update)
# ---------------------------------------------------------------------------
def test_db011_flags_yield_spanning_rmw():
    fs = active_for("""
        def bump(kernel, counter):
            while True:
                v = counter.value
                yield 0.5
                counter.value = v + 1

        def drive(kernel, counter):
            kernel.spawn(bump(kernel, counter))
            kernel.spawn(bump(kernel, counter))
    """, "DB011")
    assert len(fs) == 1
    assert fs[0].line == 6                      # the write-back
    assert "lost" in fs[0].message


def test_db011_clean_when_resource_held_across():
    assert active_for("""
        def bump(kernel, counter, lock):
            while True:
                yield ("acquire", lock)
                v = counter.value
                yield 0.5
                counter.value = v + 1
                yield ("release", lock)

        def drive(kernel, counter, lock):
            kernel.spawn(bump(kernel, counter, lock))
    """, "DB011") == []


def test_db011_ignores_non_kernel_generators():
    # a plain data generator (never spawned, no protocol yields) is not
    # a kernel process — interleaving points don't apply to it
    assert active_for("""
        def chunks(stream):
            buf = stream.pending
            yield buf
            stream.pending = buf + 1
    """, "DB011") == []


# ---------------------------------------------------------------------------
# DB012 — daemon mutating version-guarded state under live readers
# ---------------------------------------------------------------------------
def test_db012_flags_daemon_topology_mutation():
    fs = active_for("""
        def failures(kernel, net):
            while True:
                net.set_node_down("cloud0", True)
                yield 5.0

        def worker(kernel, net):
            while True:
                g = net.graph_at(kernel.now)
                yield 1.0

        def drive(kernel, net):
            kernel.spawn(worker(kernel, net))
            kernel.spawn(failures(kernel, net), daemon=True)
    """, "DB012")
    assert len(fs) == 1
    assert "set_node_down" in fs[0].message
    assert "daemon" in fs[0].message


def test_db012_flags_daemon_guarded_container_mutation():
    fs = active_for("""
        def pruner(kernel, graph):
            while True:
                graph.adj.clear()
                yield 5.0

        def worker(kernel, graph):
            while True:
                yield 1.0

        def drive(kernel, graph):
            kernel.spawn(worker(kernel, graph))
            kernel.spawn(pruner(kernel, graph), daemon=True)
    """, "DB012")
    assert len(fs) == 1
    assert ".adj" in fs[0].message


def test_db012_clean_when_mutator_is_regular_process():
    # same mutation from a non-daemon process: the spawn edge + its own
    # event ordering mediate, and DB006 still covers the version bump
    assert active_for("""
        def failures(kernel, net):
            while True:
                net.set_node_down("cloud0", True)
                yield 5.0

        def worker(kernel, net):
            while True:
                yield 1.0

        def drive(kernel, net):
            kernel.spawn(worker(kernel, net))
            kernel.spawn(failures(kernel, net))
    """, "DB012") == []


def test_db012_clean_without_non_daemon_readers():
    assert active_for("""
        def failures(kernel, net):
            while True:
                net.set_node_down("cloud0", True)
                yield 5.0

        def drive(kernel, net):
            kernel.spawn(failures(kernel, net), daemon=True)
    """, "DB012") == []


# ---------------------------------------------------------------------------
# DB013 — one mutable container spawned into several processes
# ---------------------------------------------------------------------------
def test_db013_flags_shared_container():
    fs = active_for("""
        def drive(kernel, worker):
            shared = []
            kernel.spawn(worker(shared))
            kernel.spawn(worker(shared))
    """, "DB013")
    assert len(fs) == 1
    assert "`shared`" in fs[0].message
    assert "2 spawn sites" in fs[0].message


def test_db013_clean_when_copied_at_spawn_site():
    assert active_for("""
        def drive(kernel, worker):
            shared = []
            kernel.spawn(worker(list(shared)))
            kernel.spawn(worker(list(shared)))
    """, "DB013") == []


def test_db013_clean_on_single_site_loop():
    # one spawn site in a loop is one *code* location: sharing there is
    # usually a deliberate fan-in accumulator, so only distinct call
    # sites count
    assert active_for("""
        def drive(kernel, worker):
            sink = []
            for i in range(4):
                kernel.spawn(worker(sink))
    """, "DB013") == []


# ---------------------------------------------------------------------------
# satellite pin: DB005's op inventory == the kernel's runtime protocol
# ---------------------------------------------------------------------------
def test_known_effect_ops_single_source():
    """``AnalysisConfig.known_ops`` must equal
    ``repro_torch.sim.kernel.KNOWN_EFFECT_OPS`` — the lint does not import
    the sim, so the literal is pinned here instead (and to the
    reference's)."""
    assert default_config().known_ops == KNOWN_EFFECT_OPS
    assert KNOWN_EFFECT_OPS == ("acquire", "release")
    assert KNOWN_EFFECT_OPS == jkernel.KNOWN_EFFECT_OPS


# ---------------------------------------------------------------------------
# runtime sanitizer — planted lost update, locked twin, HB edges
# ---------------------------------------------------------------------------
class Counter:
    def __init__(self):
        self.value = 0


def _bump(kernel, counter):
    kernel.note_access(counter, "value", "r")
    v = counter.value
    yield 0.0
    kernel.note_access(counter, "value", "w")
    counter.value = v + 1


def test_runtime_catches_and_localizes_lost_update():
    k = SimKernel(race_detect=True)
    c = Counter()
    k.spawn(_bump(k, c), label="a")
    k.spawn(_bump(k, c), label="b")
    k.run()
    assert c.value == 1                     # the update really was lost
    reports = k.races.reports
    assert len(reports) == 2                # r-vs-w, then w-vs-w
    first = reports[0]
    assert first.obj == "Counter" and first.obj_field == "value"
    # localized to the first conflicting event pair, with both labels:
    # b's read at event 2 conflicts with a's write-back at event 3
    assert (first.first.label, first.first.mode,
            first.first.event_index) == ("b", "r", 2)
    assert (first.second.label, first.second.mode,
            first.second.event_index) == ("a", "w", 3)
    assert "unordered by happens-before" in first.describe()
    assert "event 2" in first.describe()


def _lost_update_reports(kernel_cls):
    k = kernel_cls(race_detect=True)
    c = Counter()
    k.spawn(_bump(k, c), label="a")
    k.spawn(_bump(k, c), label="b")
    k.run()
    return [dataclasses.asdict(r) for r in k.races.reports], \
        k.events_processed


def test_lost_update_reports_match_reference():
    """The same program on the port's kernel and on the reference's: the
    race reports are equal field by field."""
    got = _lost_update_reports(SimKernel)
    want = _lost_update_reports(jkernel.SimKernel)
    assert got == want
    assert len(got[0]) == 2


def _bump_locked(kernel, counter, lock):
    yield ("acquire", lock)
    kernel.note_access(counter, "value", "r")
    v = counter.value
    yield 0.0
    kernel.note_access(counter, "value", "w")
    counter.value = v + 1
    yield ("release", lock)


def test_runtime_clean_under_acquire_release():
    k = SimKernel(race_detect=True)
    c = Counter()
    lock = SlotResource("lock", capacity=1)
    k.spawn(_bump_locked(k, c, lock), label="a")
    k.spawn(_bump_locked(k, c, lock), label="b")
    k.run()
    assert c.value == 2                     # no lost update
    assert k.races.ok and k.races.reports == []


def test_runtime_spawn_edge_orders_parent_child():
    # parent writes, then spawns a child that reads at the same
    # timestamp: the spawn edge orders the pair — no race
    obj = Counter()

    def child(kernel):
        kernel.note_access(obj, "value", "r")
        yield 0.0

    def parent(kernel):
        kernel.note_access(obj, "value", "w")
        obj.value = 7
        kernel.spawn(child(kernel), label="child")
        yield 0.0

    k = SimKernel(race_detect=True)
    k.spawn(parent(k), label="parent")
    k.run()
    assert k.races.ok


def test_runtime_time_order_is_not_a_race():
    # same conflicting pair, but one simulated second apart: the clock
    # orders them, so nothing is reported
    obj = Counter()

    def writer(kernel):
        kernel.note_access(obj, "value", "w")
        yield 0.0

    def reader(kernel):
        yield 1.0
        kernel.note_access(obj, "value", "r")

    k = SimKernel(race_detect=True)
    k.spawn(writer(k), label="w")
    k.spawn(reader(k), label="r")
    k.run()
    assert k.races.ok


# ---------------------------------------------------------------------------
# scenario-level gate — the fig20-style DAG+churn+autoscale pin
# ---------------------------------------------------------------------------
def _dag_churn_scenario(pkg=tsc, **kw):
    base = dict(
        network=pkg.NetworkSpec(regions=2),
        workload=pkg.WorkloadSpec(kind="regional_diurnal", rate=8.0,
                                  peak_to_trough=2.0, seed=11),
        strategy="databelt", n=12, input_bytes=2e6,
        workflow="diamond:3",
        autoscale=pkg.AutoscalePolicy(interval_s=0.5, p95_slo_s=2.0),
        faults=pkg.FaultPlan.poisson(rate=0.1, outage_s=6.0,
                                     targets=("cloud0", "cloud1"),
                                     horizon_s=14.0, seed=7))
    base.update(kw)
    return pkg.Scenario(**base)


def test_scenario_dag_autoscale_faults_race_clean():
    check = _dag_churn_scenario().verify_races()
    assert check.ok
    assert check.events_processed > 0
    assert "race-clean" in check.describe()
    assert str(check.events_processed) in check.describe()


def test_race_detection_is_passive():
    # identical spec with detection on vs off: bit-identical event trace
    # and metrics — the sanitizer never schedules events
    on = _dag_churn_scenario(record_trace=True, race_detect=True).run()
    off = _dag_churn_scenario(record_trace=True, race_detect=False).run()
    assert on.rep.trace == off.rep.trace
    assert on.rep.p95 == off.rep.p95
    assert on.rep.races == [] and off.rep.races is None
    assert on.rep.race_clean and not off.rep.race_clean


def test_scenario_race_detect_roundtrip():
    sc = _dag_churn_scenario(race_detect=True)
    assert Scenario.from_dict(sc.to_dict()).race_detect is True
    assert Scenario.from_dict(
        _dag_churn_scenario().to_dict()).race_detect is False


def test_sequential_workload_rejects_race_detect():
    sc = Scenario(workload=WorkloadSpec(kind="sequential"),
                  race_detect=True)
    with pytest.raises(ValueError, match="nothing to race"):
        sc.validate()


def test_race_check_describe_lists_findings():
    acc = lambda i, lbl, m: RaceAccess(event_index=i, time=0.0,
                                       label=lbl, mode=m)
    check = RaceCheck(
        scenario=None,
        races=[RaceReport(obj="Counter", obj_field="value",
                          first=acc(2, "b", "r"), second=acc(3, "a", "w"))],
        events_processed=9)
    assert not check.ok
    desc = check.describe()
    assert "1 race(s) detected over 9 events" in desc
    assert "Counter.value" in desc and "'b'" in desc and "'a'" in desc


# ---------------------------------------------------------------------------
# parity with the reference: the --race-smoke spec and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [12, 24])   # the fixture's and --race-smoke's
def test_verify_races_matches_reference(n):
    """The --race-smoke spec (n = 24) and the fixture's (n = 12) through
    both packages' ``verify_races()``: the same event count, the same
    report."""
    got = _dag_churn_scenario(tsc, n=n).verify_races()
    want = _dag_churn_scenario(jsc, n=n).verify_races()
    assert isinstance(got, RaceCheck) and got.ok
    assert got.events_processed == want.events_processed > 0
    assert got.describe() == want.describe()


def test_race_smoke_cli_matches_reference(capsys):
    from repro.analysis.__main__ import main as jmain
    from repro_torch.analysis.__main__ import main as tmain
    assert tmain(["--race-smoke"]) == 0
    got = capsys.readouterr().out
    assert jmain(["--race-smoke"]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("race-clean")


# ---------------------------------------------------------------------------
# the device: real compute runs the bodies where ``device`` says
# ---------------------------------------------------------------------------
def test_verify_races_runs_real_compute_on_the_given_device(monkeypatch):
    """A concurrent flood spec with real compute, race-checked on the CPU:
    race-clean, and every body ran for every mission, on CPU tensors.
    The sanitizer is passive, so the missions are the same as a plain
    run's."""
    from repro_torch.serverless import workflow as twf
    calls = []

    def counted(name, body):
        def run(payload, *args):
            out = body(payload, *args)
            calls.append(name)
            if name == "ingest":
                assert out["frames"].device.type == "cpu"
            return out
        return run
    for name in ("ingest", "detect", "map", "alarm"):
        monkeypatch.setattr(twf, f"{name}_fn",
                            counted(name, getattr(twf, f"{name}_fn")))
    sc = Scenario(workload=WorkloadSpec(kind="stagger", stagger=0.05),
                  n=3, input_bytes=2e5, real_compute=True)
    check = sc.verify_races(device="cpu")
    assert check.ok, check.describe()
    assert check.events_processed > 0
    assert sorted(calls) == sorted(["ingest", "detect", "map", "alarm"] * 3)
