"""The port's recurrent models (recurrentgemma-2b: RG-LRU + local attention;
rwkv6-7b: RWKV-6) against the JAX reference on their smoke configs: prefill,
decode, the serve steps, the engine and the weight converter.

Weights are the reference's own (``repro.models.init_params``), with every
norm and every zero-initialised recurrent parameter (RG-LRU ``ba``, ``bi``,
``conv_b``; RWKV ``mu_x``, ``mu``, ``lnx_b``, ``mu_k``, ``mu_r``) given
random values so that no path is tested only at zero, converted by
``params_from_jax``.  Inputs are numpy draws.  The JAX model runs its local
attention with the Pallas flash kernel in interpret mode, the function the
port's attention computes (see tests/test_torch_model.py).

Tolerances, with reasons (those of tests/test_torch_model.py):
* f32 params: 2e-4 absolute and relative: summation order over a few layers.
* bf16 params: 5e-2, logits elementwise and cache leaves in relative norm
  (||t - j|| / ||j||): the reference's bf16 gelu in recurrentgemma's MLP
  differs from torch's by one ulp in about half the elements, and that
  drift reaches a few elements of the deeper caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import disable_flash_attention as jax_flash_off  # noqa: E402
from repro.kernels import enable_flash_attention as jax_flash_on  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
B, S = 2, 64
NORMAL = {"ln1": 0.3, "ln2": 0.3, "final_norm": 0.3, "lnx_b": 0.3,
          "ba": 0.5, "bi": 0.5, "conv_b": 0.5}
UNIFORM = {"mu_x", "mu", "mu_k", "mu_r"}


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def _jax_params(cfg, seed):
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        if name in NORMAL:
            return leaf + jnp.asarray(
                rng.standard_normal(leaf.shape) * NORMAL[name], leaf.dtype)
        if name in UNIFORM:
            return jnp.asarray(rng.uniform(0, 1, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, params)


def _models(arch, dtype, seed=0):
    jc, tc = _cfgs(arch, dtype)
    jp = _jax_params(jc, seed)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _jax_prefill(params, cfg, tokens):
    jax_flash_on(interpret=True, bq=16, bk=16)
    try:
        return jtf.forward_prefill(params, cfg, {"tokens": jnp.asarray(tokens)})
    finally:
        jax_flash_off()


def _torch_leaves(cache):
    return [entry[name] for part in ("blocks", "tail") for entry in cache[part]
            for name in sorted(entry)]


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _close_caches(tcache, jcache, tol, normwise=False):
    jl, tl = jax.tree.leaves(jcache), _torch_leaves(tcache)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert tuple(t.shape) == j.shape, (i, t.shape, j.shape)
        assert str(t.dtype).split(".")[1] == str(j.dtype), (i, t.dtype, j.dtype)
        if normwise:
            t, j = t.float().numpy(), np.asarray(j, np.float32)
            err = np.linalg.norm(t - j) / np.linalg.norm(j)
            assert err <= tol, f"cache leaf {i}: relative error {err}"
        else:
            _close(t, j, tol, f"cache leaf {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype)
    tok = _tokens(tc, (B, S), 0)
    jl, jcache = _jax_prefill(jp, jc, tok)
    tl, tcache = ttf.forward_prefill(tp, tc, {"tokens": torch.tensor(tok)})
    assert tl.dtype == getattr(torch, dtype)
    _close(tl, jl, TOL[dtype], "logits")
    _close_caches(tcache, jcache, TOL[dtype], normwise=dtype == "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_jax(arch):
    """16 steps from init_cache: the recurrent state and the caches are
    updated in place, and must track the reference's returned caches."""
    jc, tc, jp, tp = _models(arch, "float32", seed=1)
    steps, cache_len = 16, 24
    jcache = jtf.init_cache(jc, B, cache_len, dtype=jnp.float32)
    tcache = ttf.init_cache(tc, B, cache_len, dtype=torch.float32, device="cpu")
    _close_caches(tcache, jcache, 0.0)
    jdec = jax.jit(lambda p, c, t, pos: jtf.forward_decode(p, jc, c, t, pos))
    toks = _tokens(tc, (steps, B, 1), 1)
    for pos in range(steps):
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks[pos]), jnp.int32(pos))
        tl, tcache = ttf.forward_decode(tp, tc, tcache, torch.tensor(toks[pos]),
                                        pos)
        _close(tl, jl, TOL["float32"], f"logits at step {pos}")
    _close_caches(tcache, jcache, TOL["float32"])


@pytest.mark.parametrize("seq", [S, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_jax(arch, seq):
    """Decoding at pos=seq on a prefill cache, 4 steps; the recurrent state
    carries on from the prefill's last step.  recurrentgemma's local layers
    have a window of 32: at seq=64 their ring has 32 slots; at seq=16 the
    prefill keeps only 16 slots and decode overwrites slot pos % 16, so it
    sees fewer positions than the window (the reference's ring branch,
    mirrored, as at full size with 1024-token prompts and a 2048 window)."""
    jc, tc, jp, tp = _models(arch, "float32", seed=2)
    tok = _tokens(tc, (B, seq), 2)
    _, jcache = _jax_prefill(jp, jc, tok)
    _, tcache = ttf.forward_prefill(tp, tc, {"tokens": torch.tensor(tok)})
    nxt = _tokens(tc, (4, B, 1), 3)
    for i in range(4):
        jl, jcache = jtf.forward_decode(jp, jc, jcache, jnp.asarray(nxt[i]),
                                        jnp.int32(seq + i))
        tl, tcache = ttf.forward_decode(tp, tc, tcache, torch.tensor(nxt[i]),
                                        seq + i)
        _close(tl, jl, TOL["float32"], f"logits at step {i}")
    _close_caches(tcache, jcache, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_jax(arch):
    jc, tc, jp, tp = _models(arch, "float32", seed=4)
    tok = _tokens(tc, (B, 48), 4)
    jax_flash_on(interpret=True, bq=16, bk=16)
    try:
        jn, jcache = jsteps.build_prefill_step(jc)(
            jp, {"tokens": jnp.asarray(tok)})
    finally:
        jax_flash_off()
    tn, tcache = tsteps.build_prefill_step(tc)(tp, {"tokens": torch.tensor(tok)})
    assert tn.dtype == torch.int32 and tn.shape == (B,)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jdec, tdec = jsteps.build_decode_step(jc), tsteps.build_decode_step(tc)
    jt, tt = jn[:, None], tn[:, None]
    for pos in range(48, 52):
        jt, jcache = jdec(jp, jcache, jt, jnp.int32(pos))
        tt, tcache = tdec(tp, tcache, tt, pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close_caches(tcache, jcache, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip(arch):
    """Every parameter of the port's model is the reference's leaf, cut out
    of its superblock stack, with its dtype; and the port's own init builds
    the same names, shapes and dtypes."""
    jc, tc, jp, tp = _models(arch, "bfloat16")
    R, P = tc.n_superblocks, tc.pattern_len
    n_leaves = 0
    for name, t in tp.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            if i < R * P:
                r, j = divmod(i, P)
                leaf, take = jp["blocks"][j], (lambda a: a[r])
            else:
                leaf, take = jp["tail"][i - R * P], (lambda a: a)
            for key in parts[2:]:
                leaf = leaf[key]
            leaf = take(leaf)
        else:
            leaf = jp[name]
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32), name)
        n_leaves += 1
    # every reference leaf is used: once, or once per superblock
    assert n_leaves == R * len(jax.tree.leaves(jp["blocks"])) + len(
        jax.tree.leaves({k: v for k, v in jp.items() if k != "blocks"}))
    own = ttf.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in own.named_parameters()} \
        == {n: (tuple(t.shape), t.dtype) for n, t in tp.named_parameters()}


def _recording(decode, log):
    def wrapped(*args):
        logits, cache = decode(*args)
        log.append(np.asarray(logits[:, -1].float() if torch.is_tensor(logits)
                              else logits[:, -1].astype(jnp.float32)))
        return logits, cache
    return wrapped


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """Both engines feed every slot each prompt token, so the recurrent
    state of a slot absorbs other requests' prompts: the port mirrors that.
    Teacher-forced as in tests/test_torch_serving.py::test_engine_matches_jax:
    logits at 5e-2, tokens wherever the reference's top-2 margin exceeds it."""
    jc, tc, jp, tp = _models(arch, "bfloat16")
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
        np.testing.assert_allclose(tlog[-1], jlog[-1], atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"])
        top2 = np.sort(jlog[-1], axis=-1)[:, -2:]
        for i, jr in enumerate(jslots):
            if jr is None:
                continue
            tr = next(r for r in te.slots + te.completed
                      if r is not None and r.req_id == jr.req_id)
            if top2[i, 1] - top2[i, 0] > TOL["bfloat16"]:
                assert tr.tokens_out[-1] == jr.tokens_out[-1]
                checked += 1
            tr.tokens_out[-1] = jr.tokens_out[-1]
    assert sorted(r.req_id for r in te.completed) == [0, 1, 2]
    assert [len(r.tokens_out) for r in te.completed] == \
        [len(r.tokens_out) for r in je.completed]
    assert len(tlog) == len(jlog) > 20
    assert checked > 0, "no token had a clear margin"


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--max-new", "3"])
    assert sorted(r.req_id for r in done) == [0, 1]
    assert all(1 <= len(r.tokens_out) <= 3 for r in done)
    assert "2 requests" in capsys.readouterr().out
