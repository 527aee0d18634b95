"""The port's distribution layer (repro_torch.distributed, launch.mesh and
models.moe.moe_sharded) against the JAX reference, on the CPU.

The multi-rank checks run in 8 processes joined in one gloo group (as the
reference's tests/test_distributed.py runs on 8 forced host devices),
spawned once for the module (``tests/torch_dist_worker.py``, a FileStore in
the test's temp dir, so xdist workers cannot collide on a port) and joined
under a time limit, so that a hung collective fails the tests instead of
stalling the lane.  The MoE inputs are the reference test's own draws; the
pipeline's and the psum's are numpy draws made here.

Tolerances, the reference's own where it has one:
* ``moe_sharded`` in bf16 against the reference's ``moe_dense(groups=2)``
  (capacity competes per data shard) at 3e-2, aux at 1e-2
  (tests/test_distributed.py); decode against ``moe_dense`` at 3e-2.  The
  sharded aux is the mean of the ranks' load-balance losses, each over its
  data shard's tokens, in the reference as in the port, and the dense aux
  is the loss over all tokens: the two differ by the data (0.015 on numpy
  draws of the same shapes, measured when this test was written), so the
  aux is also held to the reference's own mean over the shards, to 1e-3
  (bf16 routes may flip at a near-tie: the port's router product is f64).
* ``moe_sharded`` in f32 against the port's ``moe_dense(groups=2)`` at
  1e-5 (the same arithmetic, partial sums added over the model axis);
  aux: the mean of the data shards' load-balance losses, to 1e-6.
* ``pipeline_apply`` against the sequential stack at 2e-5.
* ``compressed_psum`` against its formula in numpy (int8 payloads summed
  in int32, the scales summed, the rank count): 1e-6 relative.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed.layouts import choose_layout as jax_choose  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import (LM_SHAPES, get_config,  # noqa: E402
                                      get_smoke_config)
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed.layouts import choose_layout  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.modules import MLP  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
JOIN_S = 240
MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
PATHS = ["prefill", "sp", "decode"]


def _inputs():
    """The MoE inputs are the reference test's own draws (bf16 experts from
    ``init_moe(PRNGKey(0))``, x from ``PRNGKey(1)``), held as f32 numpy
    (exact), so the f32 cases run on bf16-valued numbers."""
    rng = np.random.default_rng(0)
    inp = {}
    for arch in MOE_ARCHS:
        jc = jax_smoke(arch)
        p = jmoe.init_moe(jax.random.PRNGKey(0), jc)
        for k, v in p.items():
            if k == "dense":
                for n, w in v.items():
                    inp[f"{arch}/dense/{n}"] = np.array(w, np.float32)
            else:
                inp[f"{arch}/{k}"] = np.array(v, np.float32)
        inp[f"{arch}/x"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(1), (4, 16, jc.d_model), jnp.bfloat16),
            np.float32)
    inp["pipe/w"] = (rng.standard_normal((8, 16, 16)) * 0.3).astype(
        np.float32)
    inp["pipe/x"] = rng.standard_normal((8, 16)).astype(np.float32)
    for r in range(WORLD):
        inp[f"psum/g{r}"] = (rng.standard_normal(256) *
                             rng.uniform(0.1, 3)).astype(np.float32)
        inp[f"psum/r{r}"] = (rng.standard_normal(256) * 1e-3).astype(
            np.float32)
    return inp


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Runs the 8 ranks once; -> (inputs, each rank's results)."""
    d = tmp_path_factory.mktemp("gloo")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(d / "store"), str(d / "inputs.npz"),
         str(d / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} gloo ranks did not finish in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, bad
    return inp, [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]


def _torch_moe(inp, arch, dtype):
    def t(k):
        return torch.from_numpy(inp[f"{arch}/{k}"]).to(dtype)
    dense = None
    if f"{arch}/dense/w_gate" in inp:
        dense = MLP({n: t(f"dense/{n}") for n in ("w_gate", "w_up",
                                                   "w_down")})
    return tmoe.MoE({"router": torch.from_numpy(inp[f"{arch}/router"]),
                     "w_gate": t("w_gate"), "w_up": t("w_up"),
                     "w_down": t("w_down")}, dense)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_bf16_matches_reference(gloo, arch, path):
    """The reference's own check (tests/test_distributed.py): sharded bf16
    against its dense oracle with the data shards as capacity groups."""
    inp, res = gloo
    jc = dataclasses.replace(jax_smoke(arch), param_dtype="bfloat16")
    jp = {k: jnp.asarray(inp[f"{arch}/{k}"], jnp.bfloat16 if k != "router"
                         else jnp.float32)
          for k in ("router", "w_gate", "w_up", "w_down")}
    if f"{arch}/dense/w_gate" in inp:
        jp["dense"] = {n: jnp.asarray(inp[f"{arch}/dense/{n}"], jnp.bfloat16)
                       for n in ("w_gate", "w_up", "w_down")}
    x = jnp.asarray(inp[f"{arch}/x"], jnp.bfloat16)
    if path == "decode":
        y_ref, aux_ref = jmoe.moe_dense(jp, x[:, :1], jc)
    else:
        y_ref, aux_ref = jmoe.moe_dense(jp, x, jc, groups=2)
    got = res[0][f"{arch}/bfloat16/{path}/y"]
    np.testing.assert_allclose(got, np.asarray(y_ref, np.float32), atol=3e-2,
                               rtol=3e-2)
    shards = [x[:, :1].reshape(-1, x.shape[-1])] if path == "decode" else \
        list(x.reshape(2, -1, x.shape[-1]))
    k, E = jc.moe.experts_per_token, jc.moe.n_experts

    def ref_aux(tokens):
        _, idx, probs = jmoe._route(tokens, jp["router"], k)
        return float(jmoe._aux_loss(probs, idx, E))
    shard_aux = np.mean([ref_aux(t) for t in shards])
    for r in range(WORLD):
        aux = float(res[r][f"{arch}/bfloat16/{path}/aux"])
        assert abs(aux - float(aux_ref)) < 1e-2
        assert abs(aux - shard_aux) < 1e-3


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_f32_matches_port_dense(gloo, arch, path):
    inp, res = gloo
    tc = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    p = _torch_moe(inp, arch, torch.float32)
    x = torch.from_numpy(inp[f"{arch}/x"])
    if path == "decode":
        want, aux = tmoe.moe_dense(p, x[:, :1], tc)
    else:
        want, _ = tmoe.moe_dense(p, x, tc, groups=2)
        k = tc.moe.experts_per_token
        auxes = []
        for half in x.reshape(2, -1, x.shape[-1]):
            _, idx, probs = tmoe._route(half, p.router, k)
            auxes.append(tmoe._aux_loss(probs, idx, tc.moe.n_experts))
        aux = sum(auxes) / 2
    np.testing.assert_allclose(res[0][f"{arch}/float32/{path}/y"],
                               want.numpy(), atol=1e-5, rtol=1e-5)
    for r in range(WORLD):
        np.testing.assert_allclose(res[r][f"{arch}/float32/{path}/aux"],
                                   float(aux), rtol=1e-6)


def test_moe_sharded_returns_each_ranks_block(gloo):
    """In and out by the specs: (2, 4, D) a rank on the sequence-parallel
    path (batch over data, sequence over model), (2, 16, D) on the plain
    path, (2, 1, D) in decode."""
    _, res = gloo
    d = jax_smoke("qwen3-moe-235b-a22b").d_model
    want = {"sp": (2, 4, d), "prefill": (2, 16, d), "decode": (2, 1, d)}
    for r in range(WORLD):
        for path, shape in want.items():
            assert tuple(res[r][f"qwen3-moe-235b-a22b/float32/{path}/"
                                f"local_shape"]) == shape


def test_pipeline_apply_matches_sequential(gloo):
    inp, res = gloo
    x = torch.from_numpy(inp["pipe/x"])
    for w in torch.from_numpy(inp["pipe/w"]):
        x = torch.tanh(x @ w)
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["pipe/out"], x.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_compressed_psum_matches_formula(gloo):
    """Over the model axis: ranks 0-3 and 4-7 are two groups of 4."""
    inp, res = gloo
    for g0 in (0, 4):
        gf = [inp[f"psum/g{r}"] + inp[f"psum/r{r}"] for r in range(g0, g0 + 4)]
        scales = [np.float32(max(np.abs(a).max(), 1e-12)) / np.float32(127)
                  for a in gf]
        qs = [np.clip(np.round(a / s), -127, 127).astype(np.int8)
              for a, s in zip(gf, scales)]
        summed = np.sum([q.astype(np.int32) for q in qs], axis=0)
        n = np.float32(4)
        mean = summed.astype(np.float32) * (np.float32(sum(scales)) / n) / n
        for i, r in enumerate(range(g0, g0 + 4)):
            np.testing.assert_allclose(res[r]["psum/mean"], mean, rtol=1e-6)
            np.testing.assert_allclose(
                res[r]["psum/residual"],
                gf[i] - qs[i].astype(np.float32) * scales[i], rtol=1e-6,
                atol=1e-9)


def test_constrain_redistributes_a_dtensor(gloo):
    """Under rules a DTensor is laid out as the logical axes say (batch over
    data, embed over model), its block this rank's ``local_shard`` and its
    values unchanged; a plain tensor passes through."""
    _, res = gloo
    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    for r in range(WORLD):
        assert str(res[r]["constrain/placements"]) == "(Shard(dim=0), " \
            "Shard(dim=1))"
        np.testing.assert_array_equal(res[r]["constrain/local"],
                                      res[r]["constrain/want"])
        np.testing.assert_array_equal(res[r]["constrain/full"], full)
        np.testing.assert_array_equal(res[r]["constrain/plain"], full)


def test_make_local_mesh_takes_the_group(gloo):
    """(2, 4) on 8 ranks, as the reference's on 8 devices."""
    _, res = gloo
    for r in range(WORLD):
        assert tuple(res[r]["local_mesh"]) == (2, 4)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def test_quantize_roundtrip_bound_matches_reference():
    """Twin of tests/test_optim_train.py's round-trip bound, on the
    reference's input: the same q and scale, and the same bound."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (128,)) * 3.0)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    err = (tcomp.dequantize_int8(tq, ts) - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(ts) / 2 + 1e-6


def test_error_feedback_matches_reference():
    """Twin of tests/test_optim_train.py's error-feedback test: 50 steps of
    compress_tree on the reference's draws, the residuals and the
    accumulated signal equal to the reference's, and the residual bounded."""
    keys = jax.random.split(jax.random.PRNGKey(1), 50)
    shape = (64,)
    jres = {"w": jnp.zeros(shape)}
    tres = {"w": torch.zeros(shape)}
    jacc = np.zeros(shape, np.float32)
    tacc = torch.zeros(shape)
    true = np.zeros(shape, np.float32)
    for k in keys:
        g = np.array(jax.random.normal(k, shape))
        true += g
        jq, js, jres = jcomp.compress_tree({"w": jnp.asarray(g)}, jres)
        tq, ts, tres = tcomp.compress_tree({"w": torch.from_numpy(g)}, tres)
        np.testing.assert_array_equal(tq["w"].numpy(), np.asarray(jq["w"]))
        jacc += np.asarray(jcomp.dequantize_int8(jq["w"], js["w"]))
        tacc += tcomp.dequantize_int8(tq["w"], ts["w"])
        np.testing.assert_allclose(tres["w"].numpy(), np.asarray(jres["w"]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tacc.numpy(), jacc, rtol=1e-5, atol=1e-5)
    assert float(np.abs(true - tacc.numpy()).max()) < 0.1
    assert tcomp.wire_bytes_saved({"w": torch.zeros(10, 10)}) == \
        jcomp.wire_bytes_saved({"w": jnp.zeros((10, 10))}) == 300


def test_layout_rules_single_device():
    """Twin of tests/test_distributed.py::test_layout_rules_single_device,
    with the reference's rules beside the port's."""
    tmesh = AbstractMesh(("data", "model"), (1, 1))

    class JMesh:
        shape, axis_names = {"data": 1, "model": 1}, ("data", "model")
    for shape in ("train_4k", "decode_32k"):
        r = choose_layout(get_config("internlm2-20b"), LM_SHAPES[shape],
                          tmesh)
        j = jax_choose(jax_config("internlm2-20b"), JAX_SHAPES[shape], JMesh)
        assert r.rules == j.rules
    r = choose_layout(get_config("internlm2-20b"), LM_SHAPES["train_4k"],
                      tmesh)
    assert r.rules["heads"] == "model"
    assert r.rules["act_seq"] == "model"
    r2 = choose_layout(get_config("internlm2-20b"), LM_SHAPES["decode_32k"],
                       tmesh)
    assert r2.rules["act_seq"] is None
    assert r2.rules["kv_seq"] == "model"
