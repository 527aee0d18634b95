"""The port's runtime replay sanitizer against the reference: the twins of
tests/test_replay_verify.py (SimKernel trace hashing and
``Scenario.verify_replay()`` divergence localization), the --replay-smoke
spec's trace digest and event count equal to the reference's, and real
compute replayed on the device it is given.  Virtual specs touch no
device.
"""
import itertools

import pytest

pytest.importorskip("torch")

import repro.analysis.replay as jreplay  # noqa: E402
import repro.scenario as jsc  # noqa: E402
import repro_torch.scenario as tsc  # noqa: E402
from repro_torch.analysis.replay import (ReplayCheck,  # noqa: E402
                                         digest_entries, diff_traces,
                                         verify_scenario)
from repro_torch.core.strategy import (StateStrategy,  # noqa: E402
                                       register_strategy,
                                       unregister_strategy)
from repro_torch.scenario import (FaultPlan, NetworkSpec,  # noqa: E402
                                  Scenario, WorkloadSpec)
from repro_torch.serverless import engine as teng  # noqa: E402
from repro_torch.sim.kernel import SimKernel  # noqa: E402
from repro_torch.sim.resources import SlotResource  # noqa: E402


def _drive(kernel):
    res = SlotResource("slots", capacity=1)

    def worker(i):
        yield 0.1 * i
        yield ("acquire", res)
        yield 0.5
        yield ("release", res)

    for i in range(4):
        kernel.spawn(worker(i), label=f"w{i}")
    kernel.log("setup-done")
    kernel.run()
    return kernel


# ---------------------------------------------------------------------------
# trace hashing
# ---------------------------------------------------------------------------
def test_trace_hash_deterministic_across_runs():
    a = _drive(SimKernel(record_trace=True))
    b = _drive(SimKernel(record_trace=True))
    assert a.trace == b.trace
    assert a.trace_hash() == b.trace_hash()


def test_hash_mode_matches_recorded_trace():
    full = _drive(SimKernel(record_trace=True))
    streaming = _drive(SimKernel(record_trace="hash"))
    assert streaming.trace is None          # O(1) memory: no list kept
    assert streaming.trace_hash() == full.trace_hash()
    # and both agree with the sanitizer's own encoder
    assert digest_entries(full.trace) == full.trace_hash()


def test_tracing_off_returns_none():
    k = _drive(SimKernel())
    assert k.trace is None
    assert k.trace_hash() is None


def test_tracing_does_not_change_event_order():
    traced = _drive(SimKernel(record_trace=True))
    plain = _drive(SimKernel())
    assert plain.events_processed == traced.events_processed
    assert plain.now == traced.now


# ---------------------------------------------------------------------------
# diff_traces
# ---------------------------------------------------------------------------
def test_diff_traces_identical_is_none():
    t = [(0.0, 1, "schedule:a"), (0.5, 2, "fire:a")]
    assert diff_traces(t, list(t)) is None


def test_diff_traces_localizes_first_divergence():
    a = [(0.0, 1, "schedule:a"), (0.5, 2, "fire:a"), (0.9, 3, "fire:b")]
    b = [(0.0, 1, "schedule:a"), (0.6, 2, "fire:a"), (0.9, 3, "fire:b")]
    d = diff_traces(a, b)
    assert d.index == 1
    assert (d.time_a, d.time_b) == (0.5, 0.6)
    assert d.label_a == d.label_b == "fire:a"
    assert d.digest_a != d.digest_b
    assert d.prefix_digest == digest_entries(a[:1])
    assert "index 1" in d.describe()


def test_diff_traces_length_mismatch():
    a = [(0.0, 1, "schedule:a")]
    b = [(0.0, 1, "schedule:a"), (0.5, 2, "fire:a")]
    d = diff_traces(a, b)
    assert d.index == 1
    assert d.label_a is None and d.label_b == "fire:a"
    assert "<trace ended>" in d.describe()


# ---------------------------------------------------------------------------
# Scenario.verify_replay
# ---------------------------------------------------------------------------
def test_verify_replay_ok_on_deterministic_spec():
    sc = Scenario(n=8, input_bytes=1e6, seed=3)
    check = sc.verify_replay()
    assert isinstance(check, ReplayCheck)
    assert check.ok and check.divergence is None
    assert check.events_a == check.events_b > 0
    assert check.metrics_match
    assert "replay OK" in check.describe()
    assert not sc.record_trace                # original spec untouched


def test_verify_replay_ok_under_churn():
    # the moving-parts config: 2 regions, diurnal arrivals, poisson drains
    sc = Scenario(
        network=NetworkSpec(regions=2),
        workload=WorkloadSpec(kind="regional_diurnal", rate=8.0,
                              peak_to_trough=2.0, seed=11),
        strategy="databelt", n=16, input_bytes=2e6,
        faults=FaultPlan.poisson(rate=0.1, outage_s=6.0,
                                 targets=("cloud0", "cloud1"),
                                 horizon_s=14.0, seed=7))
    check = sc.verify_replay()
    assert check.ok, check.describe()


_LEAK = itertools.count()


class _LeakyClock(StateStrategy):
    """Deliberately nondeterministic: placement depends on a process-
    global counter, so a second run of the same spec sees a different
    counter phase — exactly the leak the sanitizer exists to localize."""

    def offload_state(self, function_id, host, t, key):
        nodes = sorted(self.graph_fn(t).nodes)
        return key.moved(nodes[next(_LEAK) % len(nodes)])


def test_verify_replay_localizes_injected_nondeterminism():
    register_strategy("test-leaky-clock")(_LeakyClock)
    try:
        sc = Scenario(strategy="test-leaky-clock", n=8, input_bytes=2e6,
                      workflow="chain:3", seed=5)
        check = sc.verify_replay()
        assert not check.ok
        assert check.divergence is not None
        d = check.divergence
        assert d.index >= 0
        assert d.label_a is not None
        assert "DIVERGED" in check.describe()
        assert "first divergent event" in check.describe()
    finally:
        unregister_strategy("test-leaky-clock")


def test_verify_scenario_equals_method():
    sc = Scenario(n=4, input_bytes=1e6, seed=9)
    assert verify_scenario(sc).trace_digest == \
        sc.verify_replay().trace_digest


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def _replay_smoke_scenario(pkg):
    """The --replay-smoke spec of both packages' CLI."""
    return pkg.Scenario(
        network=pkg.NetworkSpec(regions=2),
        workload=pkg.WorkloadSpec(kind="regional_diurnal", rate=8.0,
                                  peak_to_trough=2.0, seed=11),
        strategy="databelt", n=24, input_bytes=2e6,
        faults=pkg.FaultPlan.poisson(rate=0.1, outage_s=6.0,
                                     targets=("cloud0", "cloud1"),
                                     horizon_s=14.0, seed=7))


def test_replay_smoke_digest_matches_reference():
    """The port's simulator replays the --replay-smoke spec event for event
    as the reference's does: the same trace digest over the same number of
    events (the labels carry no module path or object id)."""
    got = _replay_smoke_scenario(tsc).verify_replay()
    want = _replay_smoke_scenario(jsc).verify_replay()
    assert got.ok and want.ok
    assert got.trace_digest == want.trace_digest
    assert got.events_a == want.events_a > 1000
    assert got.describe() == want.describe()


def test_replay_smoke_cli_matches_reference(capsys):
    from repro.analysis.__main__ import main as jmain
    from repro_torch.analysis.__main__ import main as tmain
    assert tmain(["--replay-smoke"]) == 0
    got = capsys.readouterr().out
    assert jmain(["--replay-smoke"]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("replay OK")


@pytest.mark.parametrize("a,b", [
    ([(0.0, 1, "schedule:a"), (0.5, 2, "fire:a"), (0.9, 3, "fire:b")],
     [(0.0, 1, "schedule:a"), (0.6, 2, "fire:a"), (0.9, 3, "fire:b")]),
    ([(0.0, 1, "schedule:a")], [(0.0, 1, "schedule:a"), (0.5, 2, "fire:a")]),
    ([(0.0, 1, "schedule:a"), (0.5, 2, "fire:a")], [(0.0, 1, "schedule:a")]),
])
def test_diff_traces_matches_reference(a, b):
    got, want = diff_traces(a, b), jreplay.diff_traces(a, b)
    assert vars(got) == vars(want)
    assert got.describe() == want.describe()
    assert digest_entries(a) == jreplay.digest_entries(a)


# ---------------------------------------------------------------------------
# real compute: the device goes to Scenario.run
# ---------------------------------------------------------------------------
class StepClock:
    def __init__(self, step=0.125):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def test_verify_replay_real_compute_with_a_stepped_clock(monkeypatch):
    """Real compute on the CPU replays bit-identically once the engine's
    wall clock steps by a fixed amount: the device reaches the bodies, and
    the only nondeterminism real compute brings is the clock."""
    sc = Scenario(n=2, input_bytes=2e5, real_compute=True)
    monkeypatch.setattr(teng, "_time", StepClock())
    check = sc.verify_replay(device="cpu")
    assert check.ok, check.describe()
    assert check.events_a > 0
    assert not sc.record_trace


def test_verify_replay_real_compute_folds_in_wall_time(monkeypatch):
    """With a clock whose steps grow (a wall clock never repeats a body's
    time), the second run's compute times differ and the sanitizer
    localizes the first event whose time moved."""
    ticks = itertools.count(1)
    monkeypatch.setattr(teng, "_time", type("Clock", (), {
        "perf_counter": staticmethod(lambda: next(ticks) ** 2 * 1e-6)})())
    check = verify_scenario(Scenario(n=2, input_bytes=2e5,
                                     real_compute=True), device="cpu")
    assert not check.ok
    d = check.divergence
    assert d is not None and d.label_a == d.label_b
    assert d.time_a != d.time_b
    assert "first divergent event" in check.describe()
