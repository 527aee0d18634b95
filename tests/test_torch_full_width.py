"""The port at full width against the JAX reference's own outputs.

``tests/golden/full_width.npz`` holds what the reference computes for each
cell of ``repro_torch.launch.golden.CELLS``: published configs at every
published width, cut only in depth (and the MoEs in experts), batch 1, a
prefill with the logits of every position and 8 teacher-forced decode
steps, on the port's own weights (a seeded ``BlockDraws``).
``tests/reference_golden.py`` writes it:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_golden.py

Here the port runs each cell on the CPU (the kernels' plain versions) and
is held to the file at the cell's tolerance (``golden.tolerance``):

* f32: 2e-4 (rwkv6-7b: 1e-3, its chunked wkv's drift); bf16: 5e-2;
* the logits' projections onto 16 fixed directions, in relative norm;
  each logsumexp, in units of the position's largest |logit| (the
  logsumexp rounds with its largest terms: in bf16 one ulp of a logit of
  30 is 0.125); the argmax wherever the reference's top-two gap exceeds
  twice the tolerance in those units.

Before any of that, each case checks the weights' checksums (f64 sum and
sum of squares of every leaf) against the file's, so that a weight
mismatch shows as one.  Two cells are also run through the reference
again and held to the file to 1e-5: the file is the reference's, up to
XLA's summation order.

All cases live in this one module, so that ``--dist loadfile`` runs them
one after another in one worker; each frees its model before the next
(the largest, qwen3-moe-235b-a22b at 16 experts, ~6.5 GB of f32 weights).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import golden  # noqa: E402
from repro_torch.models.modules import BlockDraws  # noqa: E402

REGENERATED = ["gemma3-1b", "whisper-small"]
REGENERATION_TOL = 1e-5


@pytest.fixture(scope="module")
def stored():
    return golden.load()


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    """Beside the other xdist workers, each on every core, eight intra-op
    threads a worker oversubscribe the box; these cases' products are
    large enough to keep four busy."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,dtype", golden.runs())
def test_port_matches_reference_at_full_width(stored, name, dtype):
    r = golden.run_cell(name, dtype, "cpu", stored)
    e = r["errors"]
    assert e["ok"], f"{name} {dtype} against the reference's file at " \
                    f"{r['tol']}: {e}"
    assert e["prefill"]["argmax_checked"] > 0


@pytest.mark.parametrize("name", REGENERATED)
def test_file_is_the_references(stored, name):
    """The reference, run again on this machine, gives the file's records."""
    import reference_golden
    got = reference_golden.reference_run(name, "float32")
    want = golden.stored(stored, name, "float32")
    assert got["names"] == want["names"]
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-9)
    np.testing.assert_array_equal(got["inputs"]["tokens"],
                                  stored[f"{name}/tokens"])
    e = golden.compare(got, want, REGENERATION_TOL)
    assert e["ok"], f"{name}: the reference now gives {e}"


@pytest.mark.parametrize("name", list(golden.CELLS))
def test_inputs_match_the_file(stored, name):
    """The inputs drawn here (tokens, frames, patches), the directions and
    the config's cut are the file's."""
    cfg = golden.cell_config(name, "float32")
    golden.check_inputs(stored, name, golden.inputs(name, cfg))
    golden.check_directions(stored, cfg.vocab_size)


def test_weights_match_the_file(stored):
    """The file's weights are the port's: the checksums of whisper-small's
    weights, drawn here (each case above checks its own cell's too)."""
    cfg = golden.cell_config("whisper-small", "float32")
    m = golden.model(cfg)
    names, sums = golden.checksums(m)
    want = golden.stored(stored, "whisper-small", "float32")
    bad = golden.checksum_mismatches(names, sums, want["names"],
                                     want["sums"],
                                     [p.numel() for p in m.parameters()])
    assert not bad, bad
    with torch.no_grad():
        next(m.parameters()).mul_(1 + 1e-6)      # a leaf at another scale
    names, sums = golden.checksums(m)
    assert golden.checksum_mismatches(names, sums, want["names"],
                                      want["sums"],
                                      [p.numel() for p in m.parameters()])


def test_cast_weights_match_the_files_bf16(stored):
    """A cell's bf16 weights cast from its f32 ones (``golden.cast``, as
    ``chip_smoke.py`` builds them) are the file's bf16 weights."""
    m = golden.cast(golden.model(golden.cell_config("h2o-danube-1.8b",
                                                    "float32")),
                    golden.cell_config("h2o-danube-1.8b", "bfloat16"))
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16,
                                                 torch.float32}
    names, sums = golden.checksums(m)
    want = golden.stored(stored, "h2o-danube-1.8b", "bfloat16")
    assert not golden.checksum_mismatches(
        names, sums, want["names"], want["sums"],
        [p.numel() for p in m.parameters()])


def test_block_draws_do_not_depend_on_threads():
    shape = (3, BlockDraws.BLOCK + 5)
    one = BlockDraws(5, threads=1)
    many = BlockDraws(5, threads=4)
    for scale in (1.0, 0.02):
        a = one.normal(shape, scale, torch.float32, "cpu")
        b = many.normal(shape, scale, torch.float32, "cpu")
        assert torch.equal(a, b)
    c = BlockDraws(5).normal(shape, 1.0, torch.bfloat16, "cpu")
    assert torch.equal(c, BlockDraws(5).normal(shape, 1.0, torch.float32,
                                               "cpu").to(torch.bfloat16))
    assert not torch.equal(BlockDraws(6).normal(shape, 1.0, torch.float32,
                                                "cpu"), c.float())


def test_file_is_small_and_complete(stored):
    assert golden.GOLDEN.stat().st_size <= 1 << 20
    for name, dtype in golden.runs():
        for part, n in (("prefill", None), ("decode", golden.DECODE_STEPS)):
            a = stored[f"{name}/{dtype}/{part}/sketch"]
            assert a.shape[1] == golden.N_DIRECTIONS
            assert n is None or a.shape[0] == n


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        golden.main(["--cells", "whisper-small"])
