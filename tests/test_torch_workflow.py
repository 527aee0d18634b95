"""The port's workflow path (repro_torch.serverless, repro_torch.scenario,
repro_torch.launch.flood) against the JAX reference, on the CPU.

The four flood bodies take the same numpy payload, and the port is handed the
reference's own weight draws (PRNGKeys 7 and 13; torch cannot reproduce
jax.random).  The keep mask must match exactly; frames, detections and the
flood map within 1e-5 (the convolutions sum in another order); the alarm
score within 1e-4: the reference takes an f32 mean over the 8x64x64 flood
map on the CPU that sits 2.3e-5 from the f64 value, where torch's is within
1e-8 of it.

The copied engine runs virtual compute bit-identically to the reference's
over a grid of strategies, modes, fusion depths, call styles, DAG shapes,
autoscale, faults and a multi-region network; with real compute both engines
get a clock that steps by a fixed amount, so that their metrics are
identical too.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import repro.scenario as jsc  # noqa: E402
import repro.serverless.engine as jeng  # noqa: E402
import repro.serverless.workflow as jwf  # noqa: E402
import repro.sim.trace as jtrace  # noqa: E402
import repro_torch.scenario as tsc  # noqa: E402
import repro_torch.serverless.engine as teng  # noqa: E402
import repro_torch.serverless.workflow as twf  # noqa: E402
import repro_torch.sim.trace as ttrace  # noqa: E402
from repro_torch.launch import flood  # noqa: E402

TOL = 1e-5
SCORE_TOL = 1e-4
SIZES = (0.5e6, 2e6)          # 122 and 488 frames


def jax_weights():
    """The reference's draws (repro/serverless/workflow.py:210-212,232)."""
    key = jax.random.PRNGKey(7)
    w1 = jax.random.normal(key, (3, 3, 1, 8), jnp.float32) * 0.1
    w2 = jax.random.normal(key, (3, 3, 8, 4), jnp.float32) * 0.1
    w_map = jax.random.normal(jax.random.PRNGKey(13), (5, 5, 1, 4),
                              jnp.float32) * 0.1
    return tuple(np.asarray(w) for w in (w1, w2, w_map))


@pytest.fixture(scope="module")
def weights():
    return twf.flood_weights_from_numpy(*jax_weights(), device="cpu")


def to_torch(payload):
    return {k: torch.from_numpy(np.array(v)) for k, v in payload.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("size", SIZES)
def test_ingest_matches_jax(size):
    payload = jwf.make_payload(size)
    j = jwf.ingest_fn(payload)
    t = twf.ingest_fn(to_torch(payload))
    assert t["keep"].dtype == torch.bool
    np.testing.assert_array_equal(t["keep"].numpy(), np.asarray(j["keep"]))
    assert 0 < int(t["keep"].sum()) < len(t["keep"])
    close(t["frames"], j["frames"])


@pytest.mark.parametrize("size", SIZES)
def test_detect_matches_jax(size, weights):
    inp = jwf.ingest_fn(jwf.make_payload(size))
    j = jwf.detect_fn(inp)
    t = twf.detect_fn(to_torch(inp), weights)
    assert t["detections"].shape == (len(inp["frames"]),)
    close(t["detections"], j["detections"])


@pytest.mark.parametrize("with_sar", [False, True])
def test_map_matches_jax(with_sar, weights):
    """Without "sar" (as the engine runs it: ingest drops the tiles) the body
    falls back to ones; with it, it convolves the tiles."""
    inp = jwf.detect_fn(jwf.ingest_fn(jwf.make_payload(2e6)))
    if with_sar:
        inp["sar"] = jwf.make_payload(2e6)["sar"]
    j = jwf.map_fn(inp)
    t = twf.map_fn(to_torch(inp), weights)
    assert t["flood_map"].shape == (8, 64, 64)
    close(t["flood_map"], j["flood_map"])
    close(t["detections"], j["detections"])


def test_alarm_matches_jax(weights):
    inp = jwf.map_fn(jwf.detect_fn(jwf.ingest_fn(jwf.make_payload(2e6))))
    j = jwf.alarm_fn(inp)
    t = twf.alarm_fn(to_torch(inp))
    assert isinstance(t["score"], float) and isinstance(t["alarm"], bool)
    assert t["alarm"] == j["alarm"]
    assert abs(t["score"] - j["score"]) <= SCORE_TOL
    assert twf.alarm_fn({}) == jwf.alarm_fn({})


def test_stride_two_same_padding_is_uneven(weights):
    """XLA's "SAME" at stride 2 over 32 pads (low 0, high 1): padding=1 pads
    (1, 1) and gives another result; the port's explicit pad gives the
    reference's."""
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 1)).astype(np.float32)
    w1 = jax_weights()[0]
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w1, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    even = F.conv2d(xt, weights["w1"], stride=2, padding=1)
    uneven = F.conv2d(twf._same_pad(xt, 3, 2), weights["w1"], stride=2)
    assert even.shape == uneven.shape == (4, 8, 16, 16)
    close(uneven.permute(0, 2, 3, 1), want)
    assert np.abs(even.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_flood_weights_once_per_device():
    a = twf.flood_weights("cpu")
    assert twf.flood_weights("cpu") is a
    assert [tuple(a[n].shape) for n in ("w1", "w2", "w_map")] == \
        [(8, 1, 3, 3), (4, 8, 3, 3), (4, 1, 5, 5)]


@pytest.mark.parametrize("caller", ["tf32", "ieee"])
def test_bodies_convolve_in_f32_and_restore_the_caller_setting(
        monkeypatch, caller):
    """Each convolving body runs its convolutions with cuDNN in full f32,
    whatever the caller set, and leaves the caller's setting as it was."""
    conv = torch.backends.cudnn.conv
    seen, real = [], twf.F.conv2d

    def conv2d(*args, **kw):
        seen.append(conv.fp32_precision)
        return real(*args, **kw)
    monkeypatch.setattr(twf.F, "conv2d", conv2d)
    before = conv.fp32_precision
    conv.fp32_precision = caller
    try:
        w = twf.flood_weights("cpu")
        out = twf.ingest_fn(twf.make_payload(2e4))
        out = twf.map_fn(twf.detect_fn(out, w), w)
        assert conv.fp32_precision == caller
    finally:
        conv.fp32_precision = before
    assert seen == ["ieee"] * 4 and out["flood_map"].shape == (8, 64, 64)


def test_make_payload_matches_reference():
    """Both payloads are numpy arrays on the host, equal bit for bit."""
    for size, sar in ((1e3, True), (2e6, False), (50e6, True)):
        j = jwf.make_payload(size, sar)
        t = twf.make_payload(size, sar)
        assert sorted(t) == sorted(j)
        for k in j:
            assert isinstance(t[k], np.ndarray) and t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_ingest_moves_frames_inside_the_engine_clock(monkeypatch):
    """The engine hands ingest the host payload; the frames first become a
    tensor on the workflow's device inside ingest's body, between the two
    clock readings of its compute span, as the reference's ingest moves its
    numpy input to the device inside its body."""
    events = []

    class Clock:
        t = 0.0

        def perf_counter(self):
            events.append("clock")
            self.t += 0.125
            return self.t

    real_ingest = twf.ingest_fn

    def ingest(payload, device=None):
        events.append(("in", type(payload["frames"]).__name__,
                       type(payload.get("sar")).__name__))
        out = real_ingest(payload, device)
        events.append(("out", type(out["frames"]).__name__,
                       out["frames"].device.type))
        return out

    monkeypatch.setattr(teng, "_time", Clock())
    monkeypatch.setattr(twf, "ingest_fn", ingest)
    eng = tsc.Scenario(strategy="databelt", real_compute=True).build_engine(
        device="cpu")
    eng.run_instance(twf.flood_workflow("c1", device="cpu",
                                        weights=twf.flood_weights("cpu")),
                     0.5e6)
    i = events.index(("in", "ndarray", "ndarray"))
    assert events[i - 1] == "clock"
    assert events[i + 1] == ("out", "Tensor", "cpu")
    assert events[i + 2] == "clock"


# ---------------------------------------------------------------------------
# the engine, virtual compute: bit-identical to the reference
# ---------------------------------------------------------------------------
def _case(**kw):
    base = dict(strategy="databelt", mode="event", depth=1, call="parallel",
                workflow="flood", regions=None, autoscale=False, faults=False)
    return {**base, **kw}


CASES = [_case(strategy=s, mode=m, depth=d, call=c)
         for s in ("databelt", "random", "stateless")
         for m in ("event", "analytic") for d in (1, 2)
         for c in ("instance", "parallel")]
CASES += [_case(workflow=w, depth=2) for w in
          ("branch:2", "diamond:2", "fanout:3", "conditional")]
CASES += [_case(strategy="stateless", autoscale=True),
          _case(faults=True), _case(regions=2, strategy="stateless")]


def _scenario(pkg, case):
    kw = {}
    if case["autoscale"]:
        kw["autoscale"] = pkg.AutoscalePolicy(interval_s=0.5, queue_high=2.0,
                                              p95_slo_s=10.0, max_capacity=64)
        kw["workload"] = pkg.WorkloadSpec(kind="closed_loop", clients=6)
    if case["faults"]:
        kw["faults"] = pkg.FaultPlan.poisson(
            rate=0.4, outage_s=4.0, targets=("cloud0",), horizon_s=10.0,
            seed=5)
    if case["regions"]:
        kw["workload"] = pkg.WorkloadSpec(kind="regional_diurnal", rate=8.0)
    return pkg.Scenario(network=pkg.NetworkSpec(regions=case["regions"]),
                        strategy=case["strategy"], mode=case["mode"],
                        fusion_depth=case["depth"], workflow=case["workflow"],
                        n=12, input_bytes=2e6, **kw)


def _drive(pkg, trace_mod, case):
    """Run one case on one package's engine; returns comparable data."""
    sc = _scenario(pkg, case)
    eng = sc.build_engine()
    maker = pkg.workflow_maker(sc.workflow)
    if case["call"] == "instance":
        rec = trace_mod.SpanRecorder()
        ms = [eng.run_instance(maker(f"wf{i}"), 2e6 * (1 + i), t0=30.0 * i,
                               trace=rec) for i in range(3)]
        return {"metrics": [dataclasses.asdict(m) for m in ms],
                "events": rec.report().to_events()}
    workload, entry = sc.workload.build(sc.network.regions, sc.seed)
    rep = eng.run_parallel(maker, sc.n, sc.input_bytes, workload=workload,
                           entry=entry, record_trace=True,
                           autoscale=sc.autoscale, faults=sc.faults,
                           trace=True)
    out = {"metrics": [dataclasses.asdict(m) for m in rep.instances],
           "latencies": rep.latencies, "throughput": rep.throughput_rps,
           "p95": rep.p95, "trace": rep.trace,
           "events": rep.trace_report.to_events(),
           "kvs_queues": rep.kvs_queues}
    if rep.autoscale is not None:
        out["autoscale"] = [(a.t, a.resource, a.new_capacity)
                            for a in rep.autoscale.actions]
    if rep.faults is not None:
        f = rep.faults
        out["faults"] = ([dataclasses.astuple(e) for e in f.applied],
                         [dataclasses.astuple(e) for e in f.skipped],
                         f.restores)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(v) for k, v in c.items() if v not in (None, False)))
def test_engine_bit_identical_to_reference(case):
    want = _drive(jsc, jtrace, case)
    got = _drive(tsc, ttrace, case)
    assert want["metrics"] and want["events"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the Scenario front door
# ---------------------------------------------------------------------------
def _specs(pkg):
    return [
        pkg.Scenario(),
        pkg.Scenario(workload=pkg.WorkloadSpec(kind="sequential",
                                               spacing=120.0),
                     n=3, input_bytes=50e6, real_compute=True),
        pkg.Scenario(
            network=pkg.NetworkSpec(regions=2),
            workload=pkg.WorkloadSpec(kind="regional_diurnal", rate=8.0,
                                      seed=11),
            strategy="stateless", n=8, workflow="diamond:3",
            autoscale=pkg.AutoscalePolicy(p95_slo_s=12.0),
            faults=pkg.FaultPlan.poisson(rate=0.2, outage_s=4.0,
                                         targets=("cloud0",),
                                         horizon_s=10.0, seed=5),
            record_trace=True, collect="aggregate", lazy_arrivals=True),
    ]


@pytest.mark.parametrize("i", range(3))
def test_scenario_dict_round_trip_matches_reference(i):
    ref, port = _specs(jsc)[i], _specs(tsc)[i]
    d = json.loads(json.dumps(port.to_dict()))
    assert d == ref.to_dict()
    assert tsc.Scenario.from_dict(d).to_dict() == d
    assert tsc.Scenario.from_dict(ref.to_dict()) == port


def test_scenario_sweep_runs_like_reference():
    axes = dict(strategy=["databelt", "stateless"], n=[4, 8])
    for j, t in zip(jsc.Scenario().sweep(**axes),
                    tsc.Scenario().sweep(**axes)):
        assert t.to_dict() == j.to_dict()
        assert t.run().row() == j.run().row()


# ---------------------------------------------------------------------------
# real compute: the engine's clock stubbed to a fixed step
# ---------------------------------------------------------------------------
class StepClock:
    def __init__(self, step=0.125):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def _capture(wf, log):
    """Record each body's output as the engine produces it."""
    for fn in wf.functions:
        def compute(payload, body=fn.compute, name=fn.name):
            out = body(payload)
            log.setdefault(wf.workflow_id, {})[name] = out
            return out
        fn.compute = compute
    return wf


def test_real_compute_matches_reference(monkeypatch):
    """The CPU twin of tests/test_engine.py::test_real_jax_compute."""
    monkeypatch.setattr(jeng, "_time", StepClock())
    monkeypatch.setattr(teng, "_time", StepClock())
    w = twf.flood_weights_from_numpy(*jax_weights(), device="cpu")
    jlog, tlog = {}, {}
    results = []
    for pkg, maker, log in (
            (jsc, lambda wid: jwf.flood_workflow(wid), jlog),
            (tsc, lambda wid: twf.flood_workflow(wid, device="cpu",
                                                 weights=w), tlog)):
        sc = pkg.Scenario(strategy="databelt", fusion_depth=2, n=2,
                          input_bytes=0.5e6, real_compute=True)
        kw = {} if pkg is jsc else {"device": "cpu"}
        eng = sc.build_engine(**kw)
        ms = [eng.run_instance(_capture(maker(f"seq{i}"), log), 0.5e6,
                               t0=60.0 * i) for i in range(2)]
        rep = eng.run_parallel(lambda wid: _capture(maker(wid), log), 3,
                               0.5e6, t0=200.0)
        results.append([dataclasses.asdict(m) for m in
                        ms + list(rep.instances)])
    assert results[0] == results[1]
    assert results[0][0]["compute_time"] > 0
    assert sorted(tlog) == sorted(jlog) and len(jlog) == 5
    for wid, j in jlog.items():
        t = tlog[wid]
        np.testing.assert_array_equal(t["ingest"]["keep"].numpy(),
                                      np.asarray(j["ingest"]["keep"]))
        close(t["ingest"]["frames"], j["ingest"]["frames"])
        close(t["detect"]["detections"], j["detect"]["detections"])
        close(t["map"]["flood_map"], j["map"]["flood_map"])
        assert t["alarm"]["alarm"] == j["alarm"]["alarm"]
        assert abs(t["alarm"]["score"] - j["alarm"]["score"]) <= SCORE_TOL


def test_virtual_run_touches_no_device():
    """A virtual run on the default (CUDA) device never resolves it."""
    rep = tsc.Scenario(n=2).run()
    assert rep.rep.n_instances == 2
    assert teng.WorkflowEngine(tsc.NetworkSpec().build()).device is None


def test_launch_flood_on_cpu(capsys):
    m = flood.main(["--device", "cpu", "--size-mb", "2"])
    assert m.latency > 0 and m.compute_time > 0
    out = capsys.readouterr().out
    assert "function placement" in out and "on cpu" in out
