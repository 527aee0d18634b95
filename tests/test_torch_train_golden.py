"""The timed train steps, and the MoE serving paths at their timed shape,
against the JAX reference's own outputs.

``tests/golden/train.npz`` holds what the reference computes for each cell
of ``repro_torch.launch.golden.TRAIN``: the train steps ``chip_smoke.py``
times, at the shape and depth it times them (h2o-danube-1.8b 24 layers at
4 x 2048; recurrentgemma-2b and rwkv6-7b at one superblock, whisper-small
and paligemma-3b at full depth, each at 4 x 1024; f32 and bf16; the MoEs,
f32, at their timed depth with their experts cut, 16 and 8 of 128), on the
port's own weights (a seeded ``BlockDraws``) and each cell's two batches:
one step of the config's optimizer at lr 1e-4 (its loss, aux and grad
norm), each parameter's clipped grad (its norm and 256 sampled values)
and update (new - old, AdamW's f32 master) at the same indices, and the
loss on batch 1 after the update.  ``tests/golden/timed_moe.npz`` holds
the MoE serving paths at 4 x 1024, their timed depth and their experts
cut, as ``tests/golden/timed.npz`` holds the others.
``tests/reference_golden.py`` writes both, one cell a process:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py \\
        --cells whisper-small@train

Every record is held on the card by ``chip_smoke.py`` ``[golden]``.  Here:

* each cell's batches, cut, index sets and parameter sizes against the
  file's, the file's keys, sizes and its size, and each cell against the
  step or serving path ``chip_smoke.py`` times;
* whisper-small's train record in f32, the port on the CPU at f32's 2e-4:
  the step, its update and the loss after it;
* a small train record (whisper-small at 1 + 1 layers, 4 x 256) run again
  through the reference and held to the file to 1e-5;
* the comparison's rules (the scalars, each leaf's grad norm and samples,
  AdamW's sign rule and its index threshold, Adafactor's update in norm,
  ``drift``), each with a case that must fail.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import golden  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ON_CPU = "whisper-small@train"
REGENERATION_TOL = 1e-5
MAX_BYTES = 4 << 20


@pytest.fixture(scope="module")
def stored():
    return golden.load(golden.TRAIN_GOLDEN)


@pytest.fixture(scope="module")
def moe_stored():
    return golden.load(golden.MOE_GOLDEN)


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


def _shapes(name):
    """(names, sizes) of a train cell's parameters (on the meta device)."""
    m = init_params(golden.cell_config(name, "float32"), None, device="meta")
    return zip(*[(n, p.numel()) for n, p in m.named_parameters()])


@pytest.mark.parametrize("name", list(golden.TRAIN))
def test_train_inputs_match_the_file(stored, name):
    """The batches drawn here, the cut, each parameter's size and index set
    are the file's (a synthetic cell's tokens, which the card takes from
    the file, are ``SyntheticTokens``' here); the two batches differ."""
    cfg = golden.cell_config(name, "float32")
    batches = [golden.train_batch(name, cfg, s) for s in (0, 1)]
    names, numels = _shapes(name)
    golden.check_train_inputs(stored, name, batches, names, numels)
    assert not np.array_equal(batches[0]["tokens"], batches[1]["tokens"])
    assert golden.cell(name).synthetic == (f"{name}/tokens" in stored)
    for s, b in enumerate(batches):
        there = golden.train_batch(name, cfg, s, stored)
        assert all(np.array_equal(b[k], there[k]) for k in b)
    for dtype in golden.cell(name).dtypes:
        assert [str(n) for n in stored[f"{name}/{dtype}/names"]] == \
            list(names)


def test_train_file_is_small_and_complete(stored):
    """Under 4 MB; every cell in each of its dtypes, an f32 twin beside each
    bf16 record, ``min(K, size)`` samples a parameter, every cut named."""
    assert golden.TRAIN_GOLDEN.stat().st_size <= MAX_BYTES
    for name, dtype in golden.runs(golden.TRAIN):
        r = golden.stored_train(stored, name, dtype)
        assert (name, "float32") in golden.runs(golden.TRAIN)
        assert [len(g) for g in r["grad"]] == [len(u) for u in r["update"]] \
            == [min(golden.K, n) for n in r["numels"]]
        assert len(r["grad_norms"]) == len(r["names"])
        assert all(np.isfinite(v) for v in r["scalars"].values())
        assert (r["scalars"]["aux"] > 0) == \
            (golden.cell_config(name, dtype).moe is not None)
        assert json.loads(str(stored[f"{name}/cut"])) == \
            golden.cell(name).cut
    assert {k.split("/")[0] for k in stored if k != "meta"} == \
        set(golden.TRAIN)
    meta = json.loads(str(stored["meta"]))
    assert (meta["k"], meta["lr"]) == (golden.K, golden.LR)


def test_train_cells_are_chip_smokes_steps(chip_smoke):
    """Each train step ``chip_smoke.py`` times has a cell at its shape and
    config (the MoEs: the experts cut), the rate its steps take."""
    assert golden.LR == chip_smoke.LR_TRAIN
    timed = {"h2o-danube-1.8b": (chip_smoke.TRAIN_B, chip_smoke.TRAIN_S, 0)}
    for arch in chip_smoke.RECURRENT:
        timed[arch] = (chip_smoke.REC_TRAIN_B, chip_smoke.REC_TRAIN_S,
                       get_config(arch).pattern_len)
    for arch, depth in chip_smoke.TRAIN_MOE_DEPTH.items():
        timed[arch] = (chip_smoke.TRAIN_MOE_B, chip_smoke.TRAIN_MOE_S, depth)
    for arch, (b, s, depth) in timed.items():
        name = chip_smoke.train_record_name(arch)
        c = golden.cell(name)
        assert (c.batch, c.seq) == (b, s)
        cfg = get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if cfg.moe is not None:
            assert c.dtypes == ("float32",) and \
                c.cut["n_experts"] < cfg.moe.n_experts
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=c.cut["n_experts"]))
        else:
            assert c.dtypes == golden.F32_BF16
        assert golden.cell_config(name, "bfloat16") == cfg
    assert len(timed) + 1 == len(golden.TRAIN)


@pytest.mark.parametrize("name", list(golden.MOE_TIMED))
def test_moe_timed_cells_match_the_file(moe_stored, chip_smoke, name):
    """The MoE serving cells: chip_smoke.py's timed path at its depth and
    shape, the experts cut; inputs, directions, cut and every position of
    the f32 record as the file has them."""
    c = golden.cell(name)
    cfg = golden.cell_config(name, "float32")
    golden.check_inputs(moe_stored, name, golden.inputs(name, cfg))
    golden.check_directions(moe_stored, cfg.vocab_size)
    assert (c.batch, c.seq, c.dtypes) == (chip_smoke.B, chip_smoke.S,
                                          ("float32",))
    assert golden.cell_config(name, "bfloat16") == dataclasses.replace(
        chip_smoke.path_config(c.arch), moe=cfg.moe)
    assert cfg.moe.n_experts == c.cut["n_experts"] < get_config(
        c.arch).moe.n_experts
    r = golden.stored(moe_stored, name, "float32")
    assert r["prefill"]["sketch"].shape == (c.batch * c.seq,
                                            golden.N_DIRECTIONS)
    assert r["decode"]["sketch"].shape == (golden.DECODE_STEPS * c.batch,
                                           golden.N_DIRECTIONS)
    assert "engine" not in r
    assert golden.MOE_GOLDEN.stat().st_size <= MAX_BYTES


def test_port_matches_reference_train_step(stored):
    """whisper-small at 12 + 12 layers, 1024 frames and 256 tokens a row,
    4 rows, f32: the step's loss and grad norm, every parameter's grad and
    update, the loss after the update."""
    r = golden.run_train_cell(ON_CPU, "float32", "cpu", stored)
    e = r["errors"]
    assert e["ok"], f"{ON_CPU} float32 at {r['tol']}: {e}"
    assert e["leaves"] == 256 and e["update"]["indices_cleared"] > 0


def test_train_file_is_the_references(stored):
    """The reference, run again on this machine, gives the file's record."""
    import reference_golden
    name = golden.REGENERATED_TRAIN
    got = reference_golden.reference_train(name, "float32")
    want = golden.stored_train(stored, name, "float32")
    assert got["names"] == want["names"]
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-9)
    golden.check_train_inputs(stored, name, got["batches"], got["names"],
                              got["numels"])
    for k in golden.SCALARS:
        assert golden.rel(got["scalars"][k], want["scalars"][k]) <= \
            REGENERATION_TOL, k
    assert golden.rel(got["grad_norms"], want["grad_norms"]) <= \
        REGENERATION_TOL
    for part in ("grad", "update"):
        errs = [golden.rel(a, b) for a, b in zip(got[part], want[part])]
        assert max(errs) <= REGENERATION_TOL, (part, max(errs))


# ---------------------------------------------------------------------------
# the rules, on made-up records
# ---------------------------------------------------------------------------
def _record(n=2, size=64, scale=1.0):
    """A made-up record of ``n`` parameters of ``size`` elements, grads of
    RMS about ``scale``, every index sampled, AdamW's first step taken from
    its grads."""
    rng = np.random.default_rng(0)
    grad = [rng.standard_normal(size) * scale for _ in range(n)]
    base = [rng.standard_normal(size) for _ in range(n)]
    update = [-golden.LR * (g / (np.abs(g) + golden.ADAMW_EPS) +
                            golden.WEIGHT_DECAY * p)
              for g, p in zip(grad, base)]
    return {"names": [f"p{i}" for i in range(n)], "numels": [size] * n,
            "scalars": {"loss": 5.0, "aux": 0.0, "grad_norm": 3.0,
                        "loss_after": 4.9},
            "grad_norms": np.array([np.linalg.norm(g) for g in grad]),
            "grad": grad, "update": update, "base": base}


def _copy(r):
    return {k: ([a.copy() for a in v] if isinstance(v, list) and k not in
                ("names", "numels") else
                (dict(v) if isinstance(v, dict) else
                 (v.copy() if isinstance(v, np.ndarray) else v)))
            for k, v in r.items()}


LIM = {"scalars": 1e-3, "grad": 1e-3, "update": 1e-3}


@pytest.mark.parametrize("case", [
    "equal", "loss_off", "aux_appears", "grad_within", "grad_off",
    "grad_norm_off", "flip_where_clear", "flip_below_threshold",
    "step_past_bound", "eps_floor", "adafactor_update"])
def test_compare_train_rules(case):
    """Each measure held to its limit: a scalar, a leaf's grad samples or
    norm past it fails; AdamW's update is held in relative norm where the
    reference's |g| clears the grad limit times the leaf's RMS (and ten
    eps), a flipped sign there fails, below it a step of either sign within
    2 lr (1 + wd |p|) passes and one past it fails; Adafactor's update is
    held in relative norm everywhere."""
    want = _record(scale=1e-6 if case == "eps_floor" else 1.0)
    got = _copy(want)
    adamw, ok = True, True
    if case == "loss_off":
        got["scalars"]["loss_after"] *= 1 + 2e-3
        ok = False
    elif case == "aux_appears":
        got["scalars"]["aux"] = 1e-6
        ok = False
    elif case == "grad_within":
        got["grad"][1] *= 1 + 5e-4
        got["grad_norms"][1] *= 1 + 5e-4
    elif case == "grad_off":
        got["grad"][1][3] += 3e-3 * np.linalg.norm(want["grad"][1])
        ok = False
    elif case == "grad_norm_off":
        got["grad_norms"][0] *= 1 + 2e-3
        ok = False
    elif case in ("flip_where_clear", "flip_below_threshold",
                  "step_past_bound", "eps_floor"):
        g = want["grad"][0]
        rms = want["grad_norms"][0] / np.sqrt(want["numels"][0])
        small = {"flip_below_threshold": 0.5e-3 * rms,
                 "step_past_bound": 0.5e-3 * rms,
                 "eps_floor": 5 * golden.ADAMW_EPS}.get(case, 2e-3 * rms)
        g[5] = small
        want["grad_norms"][0] = np.linalg.norm(g)
        p = want["base"][0][5]
        want["update"][0][5] = -golden.LR * (1 + golden.WEIGHT_DECAY * p)
        got = _copy(want)
        got["update"][0][5] = golden.LR * (1 - golden.WEIGHT_DECAY * p)
        if case == "step_past_bound":
            got["update"][0][5] += 2 * golden.LR * (
                1 + golden.WEIGHT_DECAY * abs(p))
        ok = case not in ("flip_where_clear", "step_past_bound")
    elif case == "adafactor_update":
        adamw = False
        got["update"][0] *= 1 + 5e-4
        assert golden.compare_train(got, want, LIM, adamw, "float32")["ok"]
        got["update"][0] *= 1 + 2e-3
        ok = False
    e = golden.compare_train(got, want, LIM, adamw, "float32")
    assert e["ok"] == ok, e
    assert e["leaves"] == 2 and e["indices"] == 128
    if adamw:
        u = e["update"]
        assert u["indices_cleared"] + u["indices_bounded"] == 128
        if case in ("flip_below_threshold", "step_past_bound"):
            assert u["indices_bounded"] == 1
        if case == "eps_floor":     # index 5 among the grads below 10 eps
            assert u["indices_bounded"] == int(np.sum(np.abs(np.concatenate(
                want["grad"])) <= golden.CLEAR_EPS * golden.ADAMW_EPS))


@pytest.mark.parametrize("off,ok", [(0.08, True), (0.12, False)])
def test_compare_train_widens_to_the_references_own_rounding(off, ok):
    """Beside its f32 record, a narrower record's leaf is held to twice the
    reference's own distance from f32 where that exceeds the limit (leaf 1:
    0.05 from f32, so 0.1), and "clear" to twice the reference's own sign
    flips; leaf 0, the reference's own within the limit, keeps it."""
    f32 = _record()
    want = _copy(f32)
    want["grad"][1] = f32["grad"][1] * (1 + 0.05)
    want["grad_norms"][1] *= 1 + 0.05
    got = _copy(want)
    got["grad"][1] = want["grad"][1] * (1 + off)
    got["grad_norms"][1] *= 1 + off
    lim = dict(LIM, grad=0.02)
    e = golden.compare_train(got, want, lim, True, "bfloat16", f32)
    assert e["ok"] == ok, e
    assert e["grad"]["worst_limit"] == pytest.approx(0.1)
    assert e["grad"]["limits_widened"] == 1
    got["grad"][0] = want["grad"][0] * (1 + 0.03)          # past 0.02
    assert not golden.compare_train(got, want, lim, True, "bfloat16",
                                    f32)["ok"]
    g = want["grad"][0]
    want["grad"][0] = np.where(np.arange(len(g)) == 7, -g, g)   # own flip
    clear = golden.compare_train(want, want, lim, True, "bfloat16", f32)[
        "update"]["clear"]
    rms = want["grad_norms"][0] / np.sqrt(want["numels"][0])
    assert clear == pytest.approx(max(lim["grad"], 2 * abs(g[7]) / rms))


def test_compare_train_refuses_other_parameters():
    want = _record()
    got = _copy(want)
    got["names"] = ["p1", "p0"]
    with pytest.raises(ValueError, match="parameters"):
        golden.compare_train(got, want, LIM, True, "float32")


def test_train_drift_and_limits():
    """``train_drift``: each record's grads' distance from the f32 record,
    root mean square over the parameters, and their ratio, which
    ``judge_train`` holds within ``DRIFT_RATIO`` either way; a train
    cell's limits are its dtype's ``TOL`` unless ``TOL_CELL`` sets one."""
    f32 = _record()
    want, got = _copy(f32), _copy(f32)
    for i in range(2):
        want["grad"][i] = f32["grad"][i] * (1 + 0.01)
        got["grad"][i] = f32["grad"][i] * (1 + 0.02)
    d = golden.train_drift(got, want, f32)
    assert d["reference_vs_f32"] == pytest.approx(0.01)
    assert d["ratio"] == pytest.approx(2.0) and d["ratio"] > \
        golden.DRIFT_RATIO
    got["grad"] = [g * (1 + 0.012) / (1 + 0.02) for g in got["grad"]]
    assert golden.train_drift(got, want, f32)["ratio"] == pytest.approx(1.2)
    assert golden.train_tolerance("whisper-small@train", "float32") == \
        dict.fromkeys(golden.TRAIN_MEASURES, golden.TOL["float32"])
    for name, dtype in golden.runs(golden.TRAIN):
        tol = golden.train_tolerance(name, dtype)
        assert set(tol) == set(golden.TRAIN_MEASURES)
        assert all(v >= golden.TOL[dtype] for v in tol.values())


def test_train_batches():
    """A numpy train batch: labels are the tokens rolled by one (paligemma:
    -1 over its patches), as ``models.io.make_batch`` makes them; a
    synthetic cell's are ``SyntheticTokens``'."""
    from repro_torch.data import SyntheticTokens
    for name in ("paligemma-3b@train", "whisper-small@train",
                 "rwkv6-7b@train"):
        c = golden.cell(name)
        cfg = golden.cell_config(name, "float32")
        b = golden.train_batch(name, cfg, 1)
        if c.synthetic:
            want = SyntheticTokens(cfg, c.batch, c.seq,
                                   seed=golden.SEED).batch_for_step(1)
            assert all(np.array_equal(b[k], want[k]) for k in want)
            continue
        P = cfg.n_prefix_tokens
        assert np.array_equal(b["labels"][:, P:], np.roll(b["tokens"], -1,
                                                          axis=1))
        assert (b["labels"][:, :P] == -1).all()
        assert b["tokens"].shape[0] == c.batch and \
            0 <= b["tokens"].min() and b["tokens"].max() < cfg.vocab_size


def test_train_step_reduces_bf16_products_in_f32():
    """The train step, forward and backward, runs with cuBLAS's
    reduced-precision bf16 reductions off (C19: on, the card's bf16 grads
    of whisper-small lay four times the reference's own bf16 distance
    from f32), and gives the caller's setting back."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.train import steps as tsteps

    matmul = torch.backends.cuda.matmul
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-1.8b"),
                              param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw()
    state = tsteps.init_train_state(None, cfg, opt, params=model)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(cfg, 2, 16, seed=0).batch_for_step(0).items()}
    seen = []
    loss_fn = tsteps.loss_fn

    def watched(*a, **kw):
        seen.append(("forward", matmul.allow_bf16_reduced_precision_reduction))
        total, metrics = loss_fn(*a, **kw)
        total.register_hook(lambda g: seen.append(
            ("backward", matmul.allow_bf16_reduced_precision_reduction)))
        return total, metrics
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        tsteps.loss_fn = watched
        tsteps.build_train_step(cfg, opt, lambda s: 1e-4)(state, batch)
        assert matmul.allow_bf16_reduced_precision_reduction
    finally:
        tsteps.loss_fn = loss_fn
        matmul.allow_bf16_reduced_precision_reduction = before
    assert seen == [("forward", False), ("backward", False)]
