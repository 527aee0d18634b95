"""The port's serving path (repro_torch.serving, repro_torch.launch.serve)
against the JAX reference, plus the port's device rule and import guard.

Engine parity runs in bf16 only: the reference engine builds its cache with
init_cache's bf16 default and cannot take f32 params.  The last logits of
every decode call are compared at 5e-2 (the bf16 tolerance of the model
tests).  Tokens are compared wherever the reference's top-2 margin exceeds
that tolerance; where it does not, the port is handed the reference's token
so that both engines go on from the same inputs.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import disable_flash_attention as jax_flash_off  # noqa: E402
from repro.kernels import enable_flash_attention as jax_flash_on  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.examples import (elastic_restart, serve_pipeline,  # noqa: E402
                                  train_small)
from repro_torch.launch import flood, serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402
from repro_torch.train.steps import init_train_state  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.scenario import NetworkSpec, Scenario, WorkloadSpec  # noqa: E402
from repro_torch.serverless.engine import WorkflowEngine  # noqa: E402
from repro_torch.serverless.workflow import (  # noqa: E402
    flood_weights, flood_workflow, make_payload)
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma3-1b"
BF16_TOL = 5e-2
F32_TOL = 2e-4


def _models(dtype):
    jc = dataclasses.replace(jax_smoke(ARCH), param_dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype)
    jp = jax_init(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _recording(decode, log):
    def wrapped(*args):
        logits, cache = decode(*args)
        log.append(np.asarray(logits[:, -1].float() if torch.is_tensor(logits)
                              else logits[:, -1].astype(jnp.float32)))
        return logits, cache
    return wrapped


def test_engine_matches_jax():
    jc, tc, jp, tp = _models("bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tc.vocab_size, size=n).astype(np.int32)
               for n in (5, 3, 7)]
    je = jeng.ServingEngine(jc, jp, n_slots=2, max_len=64)
    te = teng.ServingEngine(tc, tp, n_slots=2, max_len=64, device="cpu")
    jlog, tlog = [], []
    je._decode = _recording(je._decode, jlog)
    te._decode = _recording(te._decode, tlog)
    for i, p in enumerate(prompts):
        je.submit(jeng.Request(i, p, max_new=6))
        te.submit(teng.Request(i, p, max_new=6))
    checked = 0
    for _ in range(100):
        if not (je.queue or any(s is not None for s in je.slots)):
            break
        # admit first (step() would do it itself), so that the requests
        # of this step are known before it runs, the first step included
        je._admit()
        te._admit()
        jslots = list(je.slots)
        je.step()
        te.step()
        assert len(tlog) == len(jlog)
        np.testing.assert_allclose(tlog[-1], jlog[-1], atol=BF16_TOL,
                                   rtol=BF16_TOL)
        top2 = np.sort(jlog[-1], axis=-1)[:, -2:]
        for i, jr in enumerate(jslots):
            if jr is None:
                continue
            tr = next(r for r in te.slots + te.completed
                      if r is not None and r.req_id == jr.req_id)
            if top2[i, 1] - top2[i, 0] > BF16_TOL:
                assert tr.tokens_out[-1] == jr.tokens_out[-1]
                checked += 1
            tr.tokens_out[-1] = jr.tokens_out[-1]
        assert [s and s.req_id for s in te.slots] == \
            [s and s.req_id for s in je.slots]
    assert sorted(r.req_id for r in te.completed) == [0, 1, 2]
    assert [len(r.tokens_out) for r in te.completed] == \
        [len(r.tokens_out) for r in je.completed]
    assert len(tlog) == len(jlog) > 20
    assert checked > 0, "no token had a clear margin"


def test_steps_match_jax():
    jc, tc, jp, tp = _models("float32")
    tok = np.random.default_rng(1).integers(
        2, tc.vocab_size, (2, 40)).astype(np.int32)
    jax_flash_on(interpret=True, bq=8, bk=8)
    try:
        jn, jcache = jsteps.build_prefill_step(jc)(jp, {"tokens": jnp.asarray(tok)})
    finally:
        jax_flash_off()
    tn, tcache = tsteps.build_prefill_step(tc)(tp, {"tokens": torch.tensor(tok)})
    assert tn.dtype == torch.int32 and tn.shape == (2,)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jdec, tdec = jsteps.build_decode_step(jc), tsteps.build_decode_step(tc)
    jt, tt = jn[:, None], tn[:, None]
    for pos in range(40, 44):
        jt, jcache = jdec(jp, jcache, jt, jnp.int32(pos))
        tt, tcache = tdec(tp, tcache, tt, pos)
        assert tt.shape == (2, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for j, t in zip(jax.tree.leaves(jcache), jax.tree.leaves(
            tcache, is_leaf=torch.is_tensor)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_launch_serve_on_cpu(capsys):
    done = serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert sorted(r.req_id for r in done) == [0, 1, 2]
    assert all(1 <= len(r.tokens_out) <= 4 for r in done)
    assert "3 requests" in capsys.readouterr().out


NEW_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b", "whisper-small",
             "paligemma-3b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launch_serve_new_archs_on_cpu(arch, capsys):
    """The MoE, encoder-decoder and vision archs through the launcher."""
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--max-new", "3"])
    assert sorted(r.req_id for r in done) == [0, 1]
    assert all(1 <= len(r.tokens_out) <= 3 for r in done)
    assert "2 requests" in capsys.readouterr().out


def test_serve_pipeline_on_cpu(capsys):
    """The twin of examples/serve_pipeline.py: its 8 requests, drawn from the
    reference's seeded numpy prompts, each finish with max_new tokens."""
    done = serve_pipeline.main(["--device", "cpu"])
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=rng.integers(3, 8))
               for _ in range(8)]
    assert sorted(r.req_id for r in done) == list(range(8))
    for r in done:
        assert r.prompt.tolist() == prompts[r.req_id].tolist()
        assert len(r.tokens_out) == 12
        assert all(0 <= t < cfg.vocab_size for t in r.tokens_out)
    out = capsys.readouterr().out
    assert "completed 8 requests, 96 tokens" in out and "on cpu" in out


ENTRY_POINTS = {
    "init_params": lambda cfg: init_params(cfg, torch.Generator()),
    "init_cache": lambda cfg: init_cache(cfg, 1, 8),
    "params_from_jax": lambda cfg: params_from_jax({}, cfg),
    "engine": lambda cfg: teng.ServingEngine(
        cfg, init_params(cfg, torch.Generator(), device="cpu")),
    "launch.serve": lambda cfg: serve.main([]),
    "workflow_engine": lambda cfg: WorkflowEngine(NetworkSpec().build(),
                                                  real_compute=True),
    # the payload stays on the host; the flood workflow's ingest moves it
    "make_payload": lambda cfg: flood_workflow().fn("ingest").compute(
        make_payload(1e5)),
    "flood_weights": lambda cfg: flood_weights(),
    "scenario.run": lambda cfg: Scenario(n=1, real_compute=True).run(),
    "launch.flood": lambda cfg: flood.main([]),
    "init_train_state": lambda cfg: init_train_state(None, cfg, adamw()),
    "train_loop": lambda cfg: TrainLoop(cfg, adamw(), batch=2, seq=16),
    "launch.train": lambda cfg: launch_train.main([]),
    "launch.mesh.make_mesh": lambda cfg: make_mesh((1, 1), ("data", "model")),
    "launch.mesh.make_local_mesh": lambda cfg: make_local_mesh(),
    "examples.train_small": lambda cfg: train_small.main([]),
    "examples.elastic_restart": lambda cfg: elastic_restart.main([]),
    "examples.serve_pipeline": lambda cfg: serve_pipeline.main([]),
    "scenario.verify_replay": lambda cfg: Scenario(
        n=1, real_compute=True).verify_replay(),
    "scenario.verify_races": lambda cfg: Scenario(
        workload=WorkloadSpec(kind="stagger"), n=2,
        real_compute=True).verify_races(),
    # examples.quickstart is left out: its sweep is virtual and takes no
    # device
}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_default_device_is_cuda(entry):
    """Every entry point defaults to CUDA and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry](get_smoke_config(ARCH))


ARCH_ENTRY_POINTS = {
    "init_params": lambda arch: init_params(get_smoke_config(arch),
                                            torch.Generator()),
    "init_cache": lambda arch: init_cache(get_smoke_config(arch), 1, 8),
    "params_from_jax": lambda arch: params_from_jax({}, get_smoke_config(arch)),
    "engine": lambda arch: teng.ServingEngine(
        get_smoke_config(arch), init_params(get_smoke_config(arch),
                                            torch.Generator(), device="cpu")),
    "launch.serve": lambda arch: serve.main(["--arch", arch]),
}


@pytest.mark.parametrize("entry", ARCH_ENTRY_POINTS)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_default_device_is_cuda_for_new_archs(arch, entry):
    """The MoE, encoder-decoder and vision archs' entry points default to
    CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ARCH_ENTRY_POINTS[entry](arch)


FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"
