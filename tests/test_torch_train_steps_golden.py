"""The timed train steps past the first against the JAX reference's own
outputs.

``tests/golden/train_steps.npz`` holds, for each cell of
``repro_torch.launch.golden.TRAIN_STEPS`` (the cells of ``TRAIN``, the same
weights, dtypes and shapes), three steps of the config's optimizer at lr
1e-4 from one optimizer state carried from step to step, on the cell's
batches 0, 1 and 2: each step's loss, aux and grad norm, each parameter's
clipped grad (its norm and 256 sampled values) and update (AdamW's f32
master) at the same indices as ``train.npz`` (past step 1 every second of
them); the loss on batch 3 after the last step; and the optimizer's state
after it at every second index (AdamW's m and v; Adafactor's factored
moments at the sampled rows and columns, its unfactored ones at the
indices) with its count.  Its first step is ``train.npz``'s, bit for bit,
but rwkv6-7b's, whose records are of the reference's exact sequential wkv.
``tests/reference_golden.py`` writes it, one cell a process:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py \\
        --cells whisper-small@steps

Every record is held on the card by ``chip_smoke.py`` ``[golden]``.  Here:

* each cell's batches, cut, index sets, parameter sizes, XLA flags and
  wkv form against the file's, the file's keys and its size, each cell
  against the train loop ``chip_smoke.py`` times (and the weights and
  batches each timed path reads there), and each first step against
  ``train.npz``'s;
* a small record (whisper-small at 1 + 1 layers, 4 x 256) run again
  through the reference and held to the file to 1e-5, and the port on the
  CPU held to it over its three steps;
* two faults that the comparison of step 1 cannot see and that of steps 2
  and 3 fails: an Adafactor whose carried moments are dropped between
  steps, and an AdamW whose bias correction stays at count 1;
* the rules of the comparison past the first step, each with a case that
  must fail, and the file's format read back as written.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import golden  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REGENERATION_TOL = 1e-5
MAX_BYTES = 6 << 20
SMALL = golden.REGENERATED_STEPS


@pytest.fixture(scope="module")
def stored():
    return golden.load(golden.TRAIN_STEPS_GOLDEN)


@pytest.fixture(scope="module")
def one_step():
    return golden.load(golden.TRAIN_GOLDEN)


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    """Beside the other xdist workers, each on every core, eight intra-op
    threads a worker oversubscribe the box."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture(scope="module")
def small(stored):
    """The small cell's config, batches and its record in the file."""
    cfg = golden.cell_config(SMALL, "float32")
    n = int(stored[f"{SMALL}/steps"])
    return {"cfg": cfg, "file": stored,
            "batches": [golden.train_batch(SMALL, cfg, s, stored)
                        for s in range(n + 1)],
            "want": golden.stored_train_steps(stored, SMALL, "float32")}


@pytest.fixture(scope="module")
def regenerated():
    """The small cell's record written again through the reference (one
    run for the module)."""
    import reference_golden
    return reference_golden.reference_train_steps(SMALL, "float32")


@pytest.fixture(scope="module")
def port_steps(small):
    """The port's three steps of the small cell on the CPU (one run for
    the module)."""
    m = golden.train_model(SMALL, "float32", "cpu")
    return golden.train_steps_record(m, small["cfg"], small["batches"],
                                     "cpu")


def _shapes(name):
    """(names, sizes) of a train cell's parameters (on the meta device)."""
    m = init_params(golden.cell_config(name, "float32"), None, device="meta")
    return zip(*[(n, p.numel()) for n, p in m.named_parameters()])


@pytest.mark.parametrize("name", list(golden.TRAIN_STEPS))
def test_steps_inputs_match_the_file(stored, name):
    """The batches drawn here (0 .. S), the cut, the XLA flags, each
    parameter's size and index set are the file's, and the cell is its
    ``TRAIN`` cell's (paligemma-3b's in f32 only, rwkv6-7b's of the exact
    wkv); a synthetic cell's tokens, which the card takes from the file,
    are ``SyntheticTokens``' here; the batches all differ."""
    cfg = golden.cell_config(name, "float32")
    n = int(stored[f"{name}/steps"])
    batches = [golden.train_batch(name, cfg, s) for s in range(n + 1)]
    names, numels = _shapes(name)
    golden.check_train_inputs(stored, name, batches, names, numels)
    one = golden.cell(golden.train_name(name))
    assert golden.cell(name) == dataclasses.replace(
        one, dtypes=golden.cell(name).dtypes,
        seq_exact=golden.cell(name).seq_exact)
    assert golden.cell(name).seq_exact == (name == "rwkv6-7b@steps")
    assert set(golden.cell(name).dtypes) <= set(one.dtypes)
    assert len({b["tokens"].tobytes() for b in batches}) == n + 1
    assert golden.cell(name).synthetic == (f"{name}/tokens" in stored)
    for s, b in enumerate(batches):
        there = golden.train_batch(name, cfg, s, stored)
        assert all(np.array_equal(b[k], there[k]) for k in b)
    for dtype in golden.cell(name).dtypes:
        assert [str(x) for x in stored[f"{name}/{dtype}/names"]] == \
            list(names)


def test_steps_file_is_small_and_complete(stored):
    """Under 6 MiB; every cell of ``TRAIN`` in each of its dtypes at
    ``STEPS`` steps, ``min(K, size)`` samples a parameter at step 1 and
    every ``THIN``-th of them at each later step and in each state moment,
    the optimizer's count after the last step."""
    assert golden.TRAIN_STEPS_GOLDEN.stat().st_size <= MAX_BYTES
    assert {k.split("/")[0] for k in stored if k != "meta"} == \
        set(golden.TRAIN_STEPS) == {golden.steps_name(n)
                                    for n in golden.TRAIN}
    for name, dtype in golden.runs(golden.TRAIN_STEPS):
        r = golden.stored_train_steps(stored, name, dtype)
        n = int(stored[f"{name}/steps"])
        assert n == golden.STEPS == len(r["steps"]) == r["count"]
        sizes = [golden.sample_sizes(r["names"], r["numels"], k)
                 for k in range(n + 1)]
        assert sizes[0] == [min(golden.K, k) for k in r["numels"]]
        assert sizes[1] == [k if p in golden.UNTHINNED else (k + 1) // 2
                            for k, p in zip(sizes[0], r["names"])]
        assert "embed" in r["names"]
        adamw = golden.cell_config(name, dtype).optimizer == "adamw"
        assert set(r["state"]) == ({"m", "v"} if adamw else
                                   {"vr", "vc", "v"})
        for k, xs in r["state"].items():
            assert [len(x) for x in xs if x is not None] == \
                [s for s, x in zip(sizes[n], xs) if x is not None]
        for s, size in zip(r["steps"], sizes):
            assert [len(g) for g in s["grad"]] == [len(u) for u in
                                                   s["update"]] == size
            assert all(np.isfinite(v) for v in s["scalars"].values())
            assert all(np.isfinite(g).all() for g in s["grad"])
    meta = json.loads(str(stored["meta"]))
    assert (meta["k"], meta["lr"]) == (golden.K, golden.LR)


@pytest.mark.parametrize("name,dtype", golden.runs(golden.TRAIN_STEPS))
def test_first_step_is_train_npz(stored, one_step, name, dtype):
    """Each record's first step is ``train.npz``'s, bit for bit as stored
    (its scalars, grad norms, grad and update samples), and its second
    step's loss is the loss after ``train.npz``'s step (there a forward
    pass of its own jit).  A record of the exact wkv (rwkv6-7b's) is of
    the reference's other form: its first step's grads and scalars differ
    from ``train.npz``'s chunked ones, within the limits of the ``TRAIN``
    cell, which were set from that distance."""
    got = golden.stored_train_steps(stored, name, dtype)["steps"]
    want = golden.stored_train(one_step, golden.train_name(name), dtype)
    assert got[0]["names"] == want["names"]
    if golden.cell(name).seq_exact:
        tol = golden.train_tolerance(golden.train_name(name), dtype)
        errs = golden.leaf_errors(got[0], want)
        assert 0 < max(errs) <= tol["grad"], max(errs)
        assert max(golden.rel(got[0]["scalars"][k], want["scalars"][k])
                   for k in golden.STEP_SCALARS) <= tol["scalars"]
        return
    for k in golden.STEP_SCALARS:
        assert got[0]["scalars"][k] == want["scalars"][k], k
    assert np.array_equal(got[0]["grad_norms"], want["grad_norms"])
    for part in ("grad", "update"):
        assert all(np.array_equal(a, b) for a, b in
                   zip(got[0][part], want[part])), part
    assert golden.rel(got[1]["scalars"]["loss"],
                      want["scalars"]["loss_after"]) <= 1e-6


def test_steps_cells_are_chip_smokes_loops(chip_smoke, stored):
    """``chip_smoke.py``'s timed train paths hold their record's steps:
    h2o-danube-1.8b's loop has a step past the held ones, whose loss is the
    loss after them; every other path runs a warm-up, a timed step and the
    steps after it on the record's batches."""
    assert chip_smoke.TRAIN_STEPS >= golden.STEPS + 1
    for arch in ("h2o-danube-1.8b", *chip_smoke.RECURRENT,
                 *chip_smoke.TRAIN_MOE_DEPTH):
        name = chip_smoke.steps_record_name(arch)
        assert name == golden.steps_name(chip_smoke.train_record_name(arch))
        assert name in golden.TRAIN_STEPS and golden.cell(name).arch == arch
        assert int(stored[f"{name}/steps"]) == golden.STEPS


def test_timed_paths_resolve_their_records(chip_smoke, stored):
    """Every timed train path of ``chip_smoke.py`` finds in the committed
    files what it reads there: the checksums of its weights in each dtype
    it holds (the f32 record's and, but for the MoEs, whose timed models
    are not their records', the timed model's; paligemma-3b's bf16 ones
    in ``train.npz``, its steps record being f32 alone) and, where the
    timed model is its record's, the config and the record's batches."""
    from repro_torch.configs.base import get_config
    for arch in ("h2o-danube-1.8b", *chip_smoke.RECURRENT,
                 *chip_smoke.TRAIN_MOE_DEPTH):
        name = chip_smoke.steps_record_name(arch)
        cfg = get_config(arch)
        if arch in chip_smoke.RECURRENT:
            cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_len)
        elif chip_smoke.TRAIN_MOE_DEPTH.get(arch):
            cfg = dataclasses.replace(
                cfg, n_layers=chip_smoke.TRAIN_MOE_DEPTH[arch])
        names = list(_shapes(name))[0]
        for dtype in ["float32"] + ([] if cfg.moe else [cfg.param_dtype]):
            w = chip_smoke.record_weights(stored, name, dtype)
            assert w["names"] == list(names) and \
                len(w["sums"]) == len(names), (name, dtype)
        if cfg.moe:
            continue
        assert golden.cell_config(name, cfg.param_dtype) == cfg, name
        batches = chip_smoke.record_batches(torch, "cpu", name, cfg, stored)
        assert len(batches) == golden.STEPS + 1


def test_steps_file_is_the_references(small, regenerated):
    """The reference, run again on this machine over three steps, gives the
    file's record of the small cell."""
    got, want = regenerated, small["want"]
    assert got["names"] == want["names"] and got["count"] == want["count"]
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-9)
    golden.check_train_inputs(small["file"], SMALL, got["batches"],
                              got["names"], got["numels"])
    assert golden.rel(got["loss_after"],
                      want["steps"][-1]["scalars"]["loss_after"]) <= \
        REGENERATION_TOL
    for g, w in zip(got["steps"], want["steps"]):
        for k in golden.STEP_SCALARS:
            assert golden.rel(g["scalars"][k], w["scalars"][k]) <= \
                REGENERATION_TOL, k
        assert golden.rel(g["grad_norms"], w["grad_norms"]) <= \
            REGENERATION_TOL
        for part in ("grad", "update"):
            errs = [golden.rel(a, b) for a, b in zip(g[part], w[part])]
            assert max(errs) <= REGENERATION_TOL, (part, max(errs))
    for k in ("m", "v"):
        errs = [golden.rel(a, b) for a, b in zip(got["state"][k],
                                                 want["state"][k])]
        assert max(errs) <= REGENERATION_TOL, (k, max(errs))


def test_port_matches_reference_steps(small, regenerated, port_steps):
    """whisper-small at 1 + 1 layers, 4 x 256, f32, three AdamW steps: each
    step's scalars, grads and update, m and v after the last, its count,
    against the file's record and against the reference's run here."""
    got = port_steps
    lim = golden.train_tolerance(SMALL, "float32")
    here = golden.with_losses_after(regenerated, regenerated["loss_after"])
    assert golden.compare_train_steps(got, here, lim, True, "float32")["ok"]
    e = golden.compare_train_steps(got, small["want"], lim, True, "float32")
    assert e["ok"], e
    assert [s["leaves"] for s in e["steps"]] == [25] * golden.STEPS
    assert all(s["update"]["indices_cleared"] > 0 for s in e["steps"])
    assert e["state"]["count"] == golden.STEPS


def _bias_stuck_at_one(opt):
    """AdamW whose count is 0 before each update: its bias corrections stay
    those of count 1."""
    def update(grads, st, params, lr):
        st["count"].zero_()
        return opt.update(grads, st, params, lr)
    return dataclasses.replace(opt, update=update)


def _moments_dropped(opt):
    """Adafactor whose factored moments are not carried from a step to the
    next (each update starts from fresh zeros; the count carries on)."""
    def update(grads, st, params, lr):
        st["vs"] = opt.init(params)["vs"]
        return opt.update(grads, st, params, lr)
    return dataclasses.replace(opt, update=update)


@pytest.mark.parametrize("arch,fault", [
    ("h2o-danube-1.8b", _bias_stuck_at_one),
    ("qwen3-moe-235b-a22b", _moments_dropped)])
def test_injected_fault_shows_only_past_step_one(monkeypatch, arch, fault):
    """A fault in what the optimizer carries from a step to the next, on the
    arch's smoke config in f32 against the port's own three-step record:
    AdamW's bias correction stuck at count 1 (at count 1 it is right) and
    Adafactor's moments dropped between steps (its beta is 0 at step 1, so
    that step cannot tell).  Each passes the one-step comparison of step 1
    and fails step 2 and the state after step 3."""
    from repro_torch import optim
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import SyntheticTokens
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    adamw = cfg.optimizer == "adamw"
    assert adamw == (fault is _bias_stuck_at_one)
    data = SyntheticTokens(cfg, 2, 32, seed=0)
    batches = [data.batch_for_step(s) for s in range(golden.STEPS + 1)]

    def record():
        m = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return golden.train_steps_record(m, cfg, batches, "cpu")
    want = record()
    real = optim.make_optimizer
    monkeypatch.setattr(optim, "make_optimizer", lambda *a, **kw:
                        fault(real(*a, **kw)))
    got = record()
    lim = golden.train_tolerance(SMALL, "float32")
    assert golden.compare_train(got["steps"][0], want["steps"][0], lim,
                                adamw, "float32")["ok"]
    e = golden.compare_train_steps(got, want, lim, adamw, "float32")
    assert e["steps"][0]["ok"] and not e["steps"][1]["ok"]
    assert e["steps"][1]["update"]["worst"] > 0.1
    assert not e["state"]["ok"]
    assert e["state"]["count"] == (1 if adamw else golden.STEPS)


# ---------------------------------------------------------------------------
# the rules, on made-up records
# ---------------------------------------------------------------------------
def _adamw(base0: np.ndarray, grads: list) -> tuple:
    """AdamW at ``golden.LR`` in f64 on flat samples: ([the base after each
    step], m, v after the last)."""
    b1, b2, eps = golden.ADAMW_B1, golden.ADAMW_B2, golden.ADAMW_EPS
    b, m, v, out = base0, 0.0, 0.0, []
    for k, g in enumerate(grads, 1):
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        b = b - golden.LR * ((m / (1 - b1 ** k)) / (
            np.sqrt(v / (1 - b2 ** k)) + eps) + golden.WEIGHT_DECAY * b)
        out.append(b.astype(np.float32).astype(np.float64))
    return out, m, v


def _thin(rec: dict) -> dict:
    """A made-up record as a sampler keeps it: steps past the first and
    the state ``golden.thinned``."""
    names = rec["names"]
    for k, s in enumerate(rec["steps"]):
        for part in ("grad", "update", "base"):
            if part in s:
                s[part] = [golden.thinned(x, k, n)
                           for x, n in zip(s[part], names)]
    rec["state"] = {k: [None if x is None else
                        golden.thinned(x, golden.STEPS, n)
                        for x, n in zip(xs, names)]
                    for k, xs in rec["state"].items()}
    return rec


def _steps_record(n=2, size=64, steps=3, seed=0, tiny=()):
    """A made-up three-step AdamW record: grads of RMS about 1 (``tiny``:
    (parameter, index) where every step's grad is AdamW's eps), each step's
    update AdamW's own from them, m and v after the last."""
    rng = np.random.default_rng(seed)
    base0 = np.concatenate([rng.standard_normal(size) * 0.02
                            for _ in range(n)]).astype(np.float32)
    grads = [[rng.standard_normal(size) for _ in range(n)]
             for _ in range(steps)]
    for i, j in tiny:
        for g in grads:
            g[i][j] = golden.ADAMW_EPS
    bases, m, v = _adamw(base0.astype(np.float64),
                         [np.concatenate(g) for g in grads])
    bases = [base0.astype(np.float64)] + bases
    cuts = np.cumsum([size] * n)[:-1]
    out = []
    for k in range(steps):
        out.append({"names": [f"p{i}" for i in range(n)],
                    "numels": [size] * n,
                    "scalars": {"loss": 5.0 - k, "aux": 0.0,
                                "grad_norm": 0.9, "loss_after": 4.0 - k},
                    "grad_norms": np.array([np.linalg.norm(g)
                                            for g in grads[k]]),
                    "grad": [g.astype(np.float32).astype(np.float64)
                             for g in grads[k]],
                    "update": np.split(bases[k + 1] - bases[k], cuts),
                    "base": np.split(bases[k], cuts)})
    return _thin({"names": out[0]["names"], "numels": out[0]["numels"],
                  "steps": out, "count": steps,
                  "state": {"m": np.split(m, cuts), "v": np.split(v, cuts)}})


def _copy(r):
    import copy
    return copy.deepcopy(r)


LIM = {"scalars": 1e-3, "grad": 1e-3, "update": 1e-3, "state": 1e-3}


@pytest.mark.parametrize("case", [
    "equal", "update_within", "update_off", "update_below_eps_within",
    "update_below_eps_past_bound", "update_one_ulp", "update_three_ulps",
    "grad_off", "loss_off", "state_off", "count_off", "adafactor_update"])
def test_compare_train_steps_rules(case):
    """Past step 1: each leaf's update in relative norm (off by more than
    the limit fails), AdamW's where the reference's sqrt(v_hat) exceeds
    ``CLEAR_EPS`` eps and within 2 lr (1 + wd |p|) below it, each index
    past one f32 spacing of its new weight (an update one spacing off at
    every index of a weight near 4.5 passes, three fail); the grads and
    scalars as step 1 holds them; the state's samples in relative norm and
    the count exactly."""
    want = _steps_record()
    got = _copy(want)
    adamw, ok = True, True
    s2 = got["steps"][1]
    if case == "update_within":
        s2["update"][1] = s2["update"][1] * (1 + 5e-4)
    elif case == "update_off":
        s2["update"][1] = s2["update"][1] * (1 + 2e-3)
        ok = False
    elif case.startswith("update_below_eps"):
        # p0's sample 3 past step 1 tiny at every step: sqrt(v_hat) below
        # 10 eps
        want = _steps_record(tiny=[(0, 3 * golden.THIN)])
        got = _copy(want)
        s2 = got["steps"][1]
        p = abs(s2["base"][0][3])
        bound = 2 * golden.LR * (1 + golden.WEIGHT_DECAY * p)
        s2["update"][0][3] += 0.9 * bound if case.endswith("within") else \
            1.1 * bound
        ok = case.endswith("within")
    elif case in ("update_one_ulp", "update_three_ulps"):
        s2["base"][1] = np.full_like(s2["base"][1], 4.5)
        ulp = np.spacing(np.float32(4.5)).astype(np.float64)
        s2["update"][1] = s2["update"][1] + ulp * (
            1 if case == "update_one_ulp" else 3)
        ok = case == "update_one_ulp"
        assert golden.rel(s2["update"][1], want["steps"][1]["update"][1]) \
            > LIM["update"]
    elif case == "grad_off":
        s2["grad"][0] = s2["grad"][0] * (1 + 2e-3)
        ok = False
    elif case == "loss_off":
        got["steps"][2]["scalars"]["loss"] *= 1 + 2e-3
        ok = False
    elif case == "state_off":
        got["state"]["v"][1] = got["state"]["v"][1] * (1 + 2e-3)
        ok = False
    elif case == "count_off":
        got["count"] = 1
        ok = False
    elif case == "adafactor_update":
        adamw = False
        s2["update"][0] = s2["update"][0] * (1 + 5e-4)
        assert golden.compare_train_steps(got, want, LIM, adamw,
                                          "float32")["ok"]
        s2["update"][0] = s2["update"][0] * (1 + 2e-3)
        ok = False
    e = golden.compare_train_steps(got, want, LIM, adamw, "float32")
    assert e["ok"] == ok, e
    if case.startswith("update_below_eps"):
        assert e["steps"][1]["update"]["indices_bounded"] == 1
    if case in ("state_off", "count_off"):
        assert all(s["ok"] for s in e["steps"]) and not e["state"]["ok"]


def test_step_limits_hold_each_later_step_at_its_own():
    """A tuple of limits holds step 2 at its first and step 3 at its
    second: grads 3e-3 off pass at step 3 (limit 5e-3) and fail at step 2
    (limit 1e-3)."""
    want = _steps_record()
    later = dict(LIM, grad=(1e-3, 5e-3))
    assert golden.step_limits(later, 2)["grad"] == 5e-3
    for k, ok in ((2, True), (1, False)):
        got = _copy(want)
        got["steps"][k]["grad"] = [g * (1 + 3e-3)
                                   for g in got["steps"][k]["grad"]]
        e = golden.compare_train_steps(got, want, LIM, True, "float32",
                                       later=later)
        assert e["ok"] == ok and e["steps"][k]["ok"] == ok, e


def test_compare_train_steps_widens_to_the_references_own_rounding():
    """Beside its f32 record a narrower record's later update and state are
    held to twice the reference's own distance from f32 where that exceeds
    the limit; a record of another number of steps is refused."""
    f32 = _steps_record()
    want = _copy(f32)
    want["steps"][1]["update"][1] = f32["steps"][1]["update"][1] * 1.05
    want["state"]["m"][0] = f32["state"]["m"][0] * 1.05
    got = _copy(want)
    got["steps"][1]["update"][1] = want["steps"][1]["update"][1] * 1.08
    got["state"]["m"][0] = want["state"]["m"][0] * 1.08
    lim = dict(LIM, update=0.02, state=0.02)
    e = golden.compare_train_steps(got, want, lim, True, "bfloat16", f32)
    assert e["ok"], e
    assert e["steps"][1]["update"]["worst_limit"] == pytest.approx(0.1,
                                                                   rel=1e-3)
    assert e["state"]["worst_limit"] == pytest.approx(0.1, rel=1e-3)
    got["state"]["m"][0] = want["state"]["m"][0] * 1.12
    assert not golden.compare_train_steps(got, want, lim, True, "bfloat16",
                                          f32)["ok"]
    got["steps"] = got["steps"][:2]
    with pytest.raises(ValueError, match="steps"):
        golden.compare_train_steps(got, want, lim, True, "bfloat16", f32)


def _file_record(dtype, scale=1.0):
    """A made-up record of the small cell as ``reference_train_steps``
    gives it: three steps of grads (``scale`` times the same draws,
    bf16-rounded in bf16) and updates, m and v after the last, each
    ``_thin``-ned."""
    rng = np.random.default_rng(1)
    names, numels = map(list, _shapes(SMALL))
    sizes = [min(golden.K, k) for k in numels]
    cuts = np.cumsum(sizes)[:-1]

    def draws(s=1.0, positive=False):
        x = rng.standard_normal(sum(sizes)) * s
        x = torch.from_numpy(np.abs(x) if positive else x).to(
            getattr(torch, dtype)).double().numpy()
        return np.split(x, cuts)
    steps = [{"scalars": {"loss": 1.0, "aux": 0.0, "grad_norm": 1.0},
              "grad": [g * scale for g in draws()],
              "update": draws(1e-4)} for _ in range(3)]
    for s in steps:
        s["grad_norms"] = np.array([np.linalg.norm(g) for g in s["grad"]])
    cfg = golden.cell_config(SMALL, "float32")
    return _thin({
        "names": names, "sums": np.zeros((len(names), 2)), "numels": numels,
        "steps": steps, "loss_after": 0.5,
        "batches": [golden.train_batch(SMALL, cfg, s) for s in range(4)],
        "state": {"m": draws(1e-3), "v": draws(1e-6, True)}, "count": 3})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_files_encoding_is_lossless(dtype):
    """``pack_train_steps`` then ``stored_train_steps`` gives back every
    sample as the f32 the file stores (each step's own number of them),
    the scalars, each step's loss after it, the state and the count; an
    Adafactor record its factored leaves' ``vr`` and ``vc`` and the others'
    ``v``."""
    rec = _file_record(dtype)
    arrays = golden.pack_train_steps({(SMALL, dtype): rec}, {})
    back = golden.stored_train_steps(arrays, SMALL, dtype)
    assert back["count"] == 3 and back["names"] == rec["names"]
    for k, s in enumerate(rec["steps"]):
        for part in ("grad", "update"):
            assert all(np.array_equal(a, b.astype(np.float32)) for a, b in
                       zip(back["steps"][k][part], s[part])), (k, part)
        assert back["steps"][k]["scalars"]["loss_after"] == (
            0.5 if k == 2 else 1.0)
    for k in ("m", "v"):
        assert all(np.array_equal(a, b.astype(np.float32)) for a, b in
                   zip(back["state"][k], rec["state"][k]))
    fac = [i % 2 == 0 for i in range(len(rec["names"]))]
    rec["state"] = {"vr": [x if f else None for x, f in
                           zip(rec["state"]["m"], fac)],
                    "vc": [x if f else None for x, f in
                           zip(rec["state"]["v"], fac)],
                    "v": [None if f else x for x, f in
                          zip(rec["state"]["v"], fac)]}
    arrays = golden.pack_train_steps({(SMALL, dtype): rec}, {})
    back = golden.stored_train_steps(arrays, SMALL, dtype)
    assert 0 < sum(fac) < len(fac)
    for k, xs in rec["state"].items():
        assert all((a is None) == (b is None) and (
            a is None or np.array_equal(a, b.astype(np.float32)))
            for a, b in zip(back["state"][k], xs)), k


def test_judge_train_steps_holds_each_steps_drift():
    """A bf16 record held beside the file's f32 one: within its limits and
    at the reference's own drift it passes; one step whose grads lie three
    times as far from the f32 record as the reference's own (and within
    the grad limit) fails on that step's drift alone."""
    arrays = golden.pack_train_steps({
        (SMALL, "float32"): _file_record("float32"),
        (SMALL, "bfloat16"): _file_record("bfloat16", scale=1.01)}, {})
    got = golden.stored_train_steps(arrays, SMALL, "bfloat16")
    for s in got["steps"]:      # the port's weights before each step
        s["base"] = [np.full_like(u, 0.02) for u in s["update"]]
    r = golden.judge_train_steps(SMALL, "bfloat16", got, arrays)
    assert r["errors"]["ok"], r
    assert [d["ratio"] for d in r["drift"]] == [1.0] * golden.STEPS
    s3 = got["steps"][2]
    s3["grad"] = [g * 1.02 for g in s3["grad"]]
    s3["grad_norms"] = s3["grad_norms"] * 1.02
    r = golden.judge_train_steps(SMALL, "bfloat16", got, arrays)
    assert all(s["ok"] for s in r["errors"]["steps"]) and \
        r["errors"]["state"]["ok"] and not r["errors"]["ok"]
    assert r["drift"][2]["ratio"] > golden.DRIFT_RATIO


def test_unheld_records_hold_step_one_and_the_count(monkeypatch):
    """An ``UNHELD`` record's steps past the first and its state are read
    and not held: far off there it passes (held, it fails); off at step 1,
    or in its count, it fails."""
    arrays = golden.pack_train_steps(
        {(SMALL, "float32"): _file_record("float32")}, {})
    want = golden.stored_train_steps(arrays, SMALL, "float32")
    got = _copy(want)
    for s in got["steps"]:      # the port's weights before each step
        s["base"] = [np.full_like(u, 0.02) for u in s["update"]]
    got["steps"][1]["grad"] = [g * 2 for g in got["steps"][1]["grad"]]
    got["state"]["v"] = [x * 3 for x in got["state"]["v"]]

    def ok():
        return golden.judge_train_steps(SMALL, "float32", got,
                                        arrays)["errors"]["ok"]
    assert not ok()
    monkeypatch.setitem(golden.UNHELD, (SMALL, "float32"), "a test")
    assert ok()
    assert golden.judge_train_steps(SMALL, "float32", got,
                                    arrays)["unheld"] == "a test"
    got["count"] = 2
    assert not ok()
    got["count"] = 3
    got["steps"][0]["grad"] = [g * 1.01 for g in got["steps"][0]["grad"]]
    assert not ok()


def test_adafactor_state_indices():
    """A sampled index's moments: the row (all dims but the last) and the
    column (all but the second to last) of its leaf, the layer's index in
    front where the leaf is stacked; a leaf of one dim keeps ``v``."""
    ix = golden.state_indices((3, 4, 5), np.array([0, 7, 59]), 2)
    assert [a.tolist() for a in ix["vr"]] == [[2, 2, 2], [0, 0, 2], [0, 1, 3]]
    assert [a.tolist() for a in ix["vc"]] == [[2, 2, 2], [0, 0, 2], [0, 2, 4]]
    ix = golden.state_indices((6,), np.array([1, 5]), 4)      # stacked norm
    assert [a.tolist() for a in ix["vr"]] == [[4, 4]]
    assert [a.tolist() for a in ix["vc"]] == [[1, 5]]
    assert [a.tolist() for a in golden.state_indices((6,), np.array([2]),
                                                     None)["v"]] == [[2]]


def test_later_steps_take_the_cells_own_limits():
    """A ``TRAIN_STEPS`` cell's step 1 is held at its ``TRAIN`` cell's
    limits; its later steps and state at its own ``TOL_CELL`` entry where
    there is one (never under its dtype's ``TOL``, and under 1, the
    distance of a zero grad, where the record is held past step 1), else
    at step 1's."""
    for name, dtype in golden.runs(golden.TRAIN_STEPS):
        first = golden.train_tolerance(golden.train_name(name), dtype)
        later = golden.train_tolerance(name, dtype)
        assert set(first) == set(later) == set(golden.TRAIN_MEASURES)
        for k in range(1, golden.STEPS):
            lim = golden.step_limits(later, k)
            assert all(v >= golden.TOL[dtype] for v in lim.values())
            if (name, dtype) not in golden.UNHELD:
                assert max(lim.values()) < 1, (name, dtype, lim)
        if (name, dtype) not in golden.TOL_CELL:
            assert later == first
    assert golden.step_limits(golden.train_tolerance(
        "rwkv6-7b@steps", "float32"), 1)["grad"] > \
        golden.train_tolerance("rwkv6-7b@train", "float32")["grad"]
    assert set(golden.UNHELD) <= set(golden.runs(golden.TRAIN_STEPS))
