"""The timed serving paths against the JAX reference's own outputs.

``tests/golden/timed.npz`` holds what the reference computes for each cell
of ``repro_torch.launch.golden.TIMED``: the serving paths ``chip_smoke.py``
times, at the shape it times them (full width, full depth, batch 4, 1024
positions; f32 and bf16; gemma3-1b also with the int8 KV cache; and
rwkv6-7b cut to 2 layers beside its full depth), a prefill with the
logits of every position of every row, 8 teacher-forced decode steps, and
in f32 the serving engine's rows (4 requests of 3-8 prompt tokens, 8 new
tokens each, every ``_decode`` call), on the port's own weights (a seeded
``BlockDraws``).  ``tests/reference_golden.py`` writes it, one cell a
process:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py \\
        --cells rwkv6-7b@4x1024

Every record is held on the card by ``chip_smoke.py`` ``[golden]``.  Here:

* each cell's inputs, directions, options and depth against the file's,
  and the file's keys, shapes and size;
* whisper-small's timed cell in f32 (prefill, decode, engine) and
  gemma3-1b's f32 engine record, the port on the CPU at the cell's
  limits (``golden.tolerance``: f32 2e-4);
* whisper-small's bf16 record run again through the reference and held to
  the file to 1e-5: the file is the reference's, up to XLA's summation
  order;
* the rules of the limits (each measure its own), of ``drift`` and of the
  engine comparison, on made-up records.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import golden  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ON_CPU = "whisper-small@4x1024"
ENGINE_ON_CPU = "gemma3-1b@4x1024"
REGENERATED = ("whisper-small@4x1024", "bfloat16")
REGENERATION_TOL = 1e-5
MAX_BYTES = 4 << 20


@pytest.fixture(scope="module")
def stored():
    return golden.load(golden.TIMED_GOLDEN)


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    """Beside the other xdist workers, each on every core, eight intra-op
    threads a worker oversubscribe the box."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


def _rows(name):
    c = golden.cell(name)
    cfg = golden.cell_config(name, "float32")
    n = golden.inputs(name, cfg)["tokens"].shape[1]
    return c.batch * (n + (cfg.n_prefix_tokens if cfg.frontend == "vision"
                           else 0))


@pytest.mark.parametrize("name", list(golden.TIMED))
def test_inputs_match_the_file(stored, name):
    """The inputs drawn here (tokens, decode tokens, frames, patches, the
    engine's prompts), the directions, the options and the cut are the
    file's: full depth, but for a cell cut in depth beside its full-depth
    cell, the cut named in the cell's name."""
    c = golden.cell(name)
    cfg = golden.cell_config(name, "float32")
    golden.check_inputs(stored, name, golden.inputs(name, cfg))
    golden.check_directions(stored, cfg.vocab_size)
    full = get_config(c.arch).n_layers
    if c.cut:
        assert set(c.cut) == {"n_layers"} and cfg.n_layers < full
        base = golden.timed_name(c.arch, **c.options)
        assert name == f"{base}@{cfg.n_layers}L"
        assert name in golden.cut_cells(base)
    else:
        assert cfg.n_layers == full


def _engine_rows(prompts):
    """An engine record's rows where no request ends early: every request
    admitted at the first step, slot i feeding its prompt beside the i
    slots before it, then each step every slot."""
    return sum((i + 1) * len(p) for i, p in enumerate(prompts)) + \
        len(prompts) * golden.ENGINE["max_new"]


def test_file_is_small_and_complete(stored):
    """Under 4 MB; every record at every position and decode step of every
    row, an f32 twin beside each bf16 record, an engine record in f32 for
    each arch."""
    assert golden.TIMED_GOLDEN.stat().st_size <= MAX_BYTES
    engines = 0
    for name, dtype in golden.runs(golden.TIMED):
        c = golden.cell(name)
        r = golden.stored(stored, name, dtype)
        assert r["prefill"]["sketch"].shape == (_rows(name),
                                                golden.N_DIRECTIONS)
        assert r["decode"]["sketch"].shape == (golden.DECODE_STEPS * c.batch,
                                               golden.N_DIRECTIONS)
        assert stored[f"{name}/decode"].shape == (golden.DECODE_STEPS, c.batch)
        assert (name, "float32") in golden.runs(golden.TIMED)
        want_engine = c.engine and dtype == "float32"
        assert ("engine" in r) == want_engine
        if want_engine:
            engines += 1
            rows = r["engine"]["rows"]
            prompts = golden.inputs(name, golden.cell_config(
                name, dtype))["prompts"]
            assert rows.shape == (_engine_rows(prompts), len(golden.ROW))
            assert rows[:, 0].max() + 1 == \
                sum(map(len, prompts)) + golden.ENGINE["max_new"]
            assert sorted(set(rows[:, 2])) == list(range(
                golden.ENGINE["requests"]))
    assert engines == 6
    assert {k.split("/")[0] for k in stored if k != "meta"} == set(golden.TIMED)


def test_timed_cells_are_chip_smokes_paths():
    """Each non-MoE serving path ``chip_smoke.py`` times has a cell at its
    config and shape, and its int8 cache path one too."""
    sys.path.insert(0, str(ROOT))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    archs = [a for a in chip_smoke.PATHS if a not in chip_smoke.MOE]
    full = {n for n, c in golden.TIMED.items() if not c.cut}
    assert {golden.timed_name(a) for a in archs} | {
        golden.timed_name("gemma3-1b", kv_quant=True)} == full
    for name in golden.TIMED:
        c = golden.cell(name)
        assert (c.batch, c.seq) == (chip_smoke.B, chip_smoke.S)
        assert golden.cell_config(name, "bfloat16") == dataclasses.replace(
            chip_smoke.path_config(c.arch), **c.options, **c.cut)


def test_port_matches_reference_at_the_timed_shape(stored):
    """whisper-small at 4 x 1024 frames, 12 + 12 layers, f32: the prefill,
    the decode steps and the engine's streams."""
    r = golden.run_cell(ON_CPU, "float32", "cpu", stored)
    e = r["errors"]
    assert e["ok"], f"{ON_CPU} float32 at {r['tol']}: {e}"
    assert e["prefill"]["argmax_checked"] > 0
    assert e["engine"]["steps_checked"] > 0


def test_engine_matches_reference(stored):
    """gemma3-1b's serving engine at full width and depth, f32: each
    request's stream up to its first near-tie."""
    name = ENGINE_ON_CPU
    cfg = golden.cell_config(name, "float32")
    inp = golden.inputs(name, cfg)
    golden.check_inputs(stored, name, inp)
    want = golden.stored(stored, name, "float32")
    m = golden.model(cfg)
    golden.check_weights(m, name, "float32", want)
    got = golden.run_engine(m, cfg, inp["prompts"], "cpu")
    e = golden.compare_engine(got, want["engine"],
                              golden.tolerance(name, "float32")["engine"])
    assert e["ok"], f"{name} engine: {e}"
    assert e["steps_checked"] > 0 and e["argmax_checked"] > 0


def test_file_is_the_references(stored):
    """The reference, run again on this machine, gives the file's record."""
    import reference_golden
    name, dtype = REGENERATED
    got = reference_golden.reference_run(name, dtype)
    want = golden.stored(stored, name, dtype)
    assert got["names"] == want["names"]
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-9)
    np.testing.assert_array_equal(got["inputs"]["tokens"],
                                  stored[f"{name}/tokens"])
    e = golden.compare(got, want, REGENERATION_TOL)
    assert e["ok"], f"{name} {dtype}: the reference now gives {e}"


def _stream(gaps, argmax):
    """A made-up engine record of one request: one row a step."""
    n = len(gaps)
    rows = np.array([(i, 0, 0, 7, 5 + i) for i in range(n)], np.int32)
    return {"rows": rows, "gap": np.asarray(gaps, float),
            "size": np.ones(n), "argmax": np.asarray(argmax),
            "lse": np.zeros(n), "sketch": np.ones((n, golden.N_DIRECTIONS))}


@pytest.mark.parametrize("case", ["stops_at_near_tie", "flip_when_clear",
                                  "rows_differ", "stream_short",
                                  "unchecked_argmax_holds_agreeing_rows"])
def test_compare_engine_rules(case):
    """A request is compared up to its first step whose reference gap is
    within 2 tol sizes, that step's argmax left out; a flip before it, a
    row that differs or a stream cut short fails."""
    tol = 1e-2
    want = _stream([0.5, 0.5, 0.01, 0.5], [3, 4, 5, 6])
    if case == "stops_at_near_tie":
        e = golden.compare_engine(_stream([0.5, 0.5, 0.01, 0.5],
                                          [3, 4, 9, 9]), want, tol)
        assert e["ok"] and e["steps_checked"] == 3 and \
            e["argmax_checked"] == 2 and e["steps"] == 4
    elif case == "flip_when_clear":
        e = golden.compare_engine(_stream([0.5] * 4, [3, 9, 5, 6]), want, tol)
        assert not e["ok"] and e["argmax_differs"] == 1
    elif case == "rows_differ":
        got = _stream([0.5] * 4, [3, 4, 5, 6])
        got["rows"][1, 4] += 1
        e = golden.compare_engine(got, want, tol)
        assert not e["ok"] and e["rows_differ"] == 1
    elif case == "stream_short":
        got = _stream([0.5], [3])
        e = golden.compare_engine(got, want, tol)
        assert not e["ok"] and e["rows_differ"] == 2
    else:
        lim = {"sketch": tol, "lse": tol, "argmax": None}
        got = _stream([0.5] * 4, [9, 9, 9, 9])
        e = golden.compare_engine(got, want, lim)
        assert e["ok"] and e["steps_checked"] == 4 and \
            e["argmax_checked"] == 0
        got["rows"][2, 3] += 1                  # a token fed back differs
        got["sketch"][3] *= 2                   # after it, not held
        e = golden.compare_engine(got, want, lim)
        assert e["ok"] and e["steps_checked"] == 2
        got["sketch"][1] *= 2                   # before it, held
        assert not golden.compare_engine(got, want, lim)["ok"]


def _part(sketch=1.0, lse=0.0, argmax=3, gap=0.5, n=4):
    """Made-up summaries of n positions, the sketch scaled by ``sketch``."""
    return {"sketch": np.full((n, golden.N_DIRECTIONS), sketch),
            "lse": np.full(n, lse), "size": np.ones(n),
            "argmax": np.full(n, argmax), "gap": np.full(n, gap)}


def test_limits_each_measure_and_part():
    """A cell's limits: one number for every measure of every part, or
    a measure's own, or one part's, the dtype's where none is set; an
    argmax limit of None leaves the argmax unchecked."""
    one = golden.limits(1e-3)
    assert all(v == 1e-3 for p in one.values() for v in p.values())
    lim = golden.limits({"sketch": 0.1, "decode:lse": 3e-3, "argmax": None},
                        2e-4)
    assert lim["prefill"] == {"sketch": 0.1, "lse": 2e-4, "argmax": None}
    assert lim["decode"]["lse"] == 3e-3 and lim["engine"]["lse"] == 2e-4
    for name, dtype in golden.runs(golden.TIMED):
        tol = golden.tolerance(name, dtype)
        assert set(tol) == set(golden.PARTS)
        assert all(set(p) == set(golden.MEASURES) for p in tol.values())


@pytest.mark.parametrize("case", ["sketch_at_its_limit", "lse_at_default",
                                  "argmax_unchecked", "argmax_checked"])
def test_compare_holds_each_measure_to_its_own_limit(case):
    """A loose sketch limit loosens neither the logsumexp nor the argmax:
    each measure is held to its own."""
    want = {"prefill": _part(), "decode": _part()}
    tol = golden.limits({"sketch": 0.2, "argmax": 1e-2}, 1e-3)
    if case == "sketch_at_its_limit":
        got = {"prefill": _part(1.1), "decode": _part(1.1)}
        assert golden.compare(got, want, tol)["ok"]
        got = {"prefill": _part(1.3), "decode": _part()}
        assert not golden.compare(got, want, tol)["ok"]
    elif case == "lse_at_default":
        got = {"prefill": _part(1.1), "decode": _part(lse=2e-3)}
        e = golden.compare(got, want, tol)
        assert not e["ok"] and e["decode"]["lse_in_sizes"] == 2e-3
    elif case == "argmax_unchecked":
        got = {"prefill": _part(argmax=4), "decode": _part()}
        tol = golden.limits({"argmax": None}, 1e-3)
        e = golden.compare(got, want, tol)
        assert e["ok"] and e["prefill"]["argmax_checked"] == 0
    else:
        got = {"prefill": _part(argmax=4), "decode": _part()}
        e = golden.compare(got, want, tol)
        assert not e["ok"] and e["prefill"]["argmax_differs"] == 4


def test_drift_is_the_ratio_of_distances_from_f32():
    """``drift``: the port's and the reference's distance from the f32
    record, and their ratio where it lies farthest from 1, which
    ``run_cell`` holds within ``DRIFT_RATIO`` of 1 either way."""
    f32 = {"prefill": _part(), "decode": _part()}
    want = {"prefill": _part(1.1), "decode": _part(1.1)}
    got = {"prefill": _part(1.2), "decode": _part(1.1)}
    d = golden.drift(got, want, f32)
    assert d["ratio"] == pytest.approx(2.0)
    assert d["ratio"] > golden.DRIFT_RATIO
    got = {"prefill": _part(1.1), "decode": _part(1.02)}
    d = golden.drift(got, want, f32)
    assert d["ratio"] == pytest.approx(0.2)
    assert d["ratio"] < 1 / golden.DRIFT_RATIO
