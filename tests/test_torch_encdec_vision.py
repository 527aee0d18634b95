"""The port's encoder-decoder (whisper-small), prefix-LM vision model
(paligemma-3b) and int8 KV cache (``kv_quant``) against the JAX reference on
the smoke configs: prefill then decode, the train forward, the encoder, the
sinusoidal positions, the masks, the int8 quantizer, the model inputs
(``models.io``) and the serving engine with the reference's quirks.

Weights, inputs and tolerances are those of tests/test_torch_moe.py, whose
helpers this file uses: f32 2e-4, bf16 5e-2 (cache leaves in relative
norm, int8 leaves too).  In f32 an int8 cache leaf is held to one
quantization step: its values come from keys that agree to rounding, so a
value near a rounding boundary may land on the next integer; on the same
input the quantizer's values are equal (``test_kv_quantize_matches_jax``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import list_archs as jax_archs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import io as jio  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs.base import LM_SHAPES, get_smoke_config  # noqa: E402
from repro_torch.configs.base import list_archs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import io as tio  # noqa: E402
from repro_torch.models import modules as tmod  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from test_torch_moe import (TOL, as_torch,  # noqa: E402
                            check_prefill_then_decode, check_train_forward,
                            close, models, numpy_batch)

ARCHS = ["whisper-small", "paligemma-3b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch, dtype):
    """whisper: the decoder's self-attention cache has S // 4 slots, so its
    decode steps write the last slot (the reference's clamped write); the
    cross caches ``ck``, ``cv`` hold the encoder's keys and values."""
    check_prefill_then_decode(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b",
                                  "whisper-small"])
def test_kv_quant_prefill_then_decode_matches_jax(arch, dtype):
    """The int8 cache (``kv_quant=True``): int8 ``k``, ``v`` and f32 ``ksc``,
    ``vsc`` on every self-attention cache, a ring of the window on
    gemma3's local layers, bf16 ``ck``, ``cv`` on whisper's."""
    check_prefill_then_decode(arch, dtype, kv_quant=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    assert check_train_forward(arch, "float32") == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jc, tc, jp, tp = models("whisper-small", dtype, seed=3)
    frames = np.random.default_rng(3).standard_normal(
        (2, 48, tc.d_model)).astype(np.float32)
    (jx, jpos) = jtf._encode(jp, jc, jnp.asarray(frames))
    (tx, tpos) = ttf._encode(tp, tc, torch.tensor(frames))
    assert tx.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    close(tx, jx, TOL[dtype], "encoder output")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,d", [(1, 2), (64, 64), (1024, 768)])
def test_sinusoidal_pos_emb_matches_jax(seq, d, dtype):
    """Computed in float64 and cast: equal to the reference's."""
    j = jmod.sinusoidal_pos_emb(seq, d, getattr(jnp, dtype))
    t = tmod.sinusoidal_pos_emb(seq, d, getattr(torch, dtype))
    assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("pos", [0, 5, 700])
def test_sin_at_matches_jax(pos):
    """f32 angles: at pos 700 one ulp of the angle is 6.1e-5, and the two
    frameworks' f32 power and division may differ by that."""
    j = jtf._sin_at(jnp.int32(pos), 64, jnp.float32)
    t = ttf._sin_at(pos, 64, torch.float32, "cpu")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL["float32"])


def test_kv_quantize_matches_jax():
    """The int8 values equal exactly, on random keys and on values that lie
    exactly halfway between two integers after scaling (round half to
    even: 0.5 -> 0, 2.5 -> 2, -3.5 -> -4), and on an all-zero row (the
    1e-8 scale floor)."""
    rng = np.random.default_rng(0)
    rand = rng.standard_normal((2, 7, 3, 16)).astype(np.float32) * 3
    ties = np.zeros((1, 2, 1, 8), np.float32)
    ties[0, 0, 0] = [127, 0.5, 1.5, 2.5, -3.5, -0.5, 126.5, -126.5]
    ties[0, 1, 0] = [0, 0, 0, 0, 0, 0, 0, 0]
    for t in (rand, ties, rand.astype(jnp.bfloat16)):
        jq, js = jattn._kv_quantize(jnp.asarray(t))
        tq, ts = tattn._kv_quantize(torch.tensor(np.asarray(t, np.float32)).to(
            torch.bfloat16 if t.dtype == jnp.bfloat16 else torch.float32))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for dt in ("float32", "bfloat16"):
            np.testing.assert_array_equal(
                tattn._kv_dequantize(tq, ts, getattr(torch, dt)).float().numpy(),
                np.asarray(jattn._kv_dequantize(jq, js, getattr(jnp, dt)),
                           np.float32))
    assert np.asarray(jattn._kv_quantize(jnp.asarray(ties))[0])[0, 0, 0].tolist() \
        == [127, 0, 2, 2, -4, 0, 126, -126]


@pytest.mark.parametrize("mode,window,prefix", [
    ("bidir", 0, 0), ("bidir", 4, 0), ("prefix", 0, 5), ("prefix", 3, 5),
    ("prefix", 0, 0), ("causal", 0, 0), ("causal", 6, 0)])
def test_make_mask_fn_matches_jax(mode, window, prefix):
    q, kv = np.arange(12), np.arange(-2, 15)
    j = jattn.make_mask_fn(mode, window, prefix)(jnp.asarray(q), jnp.asarray(kv))
    t = tattn.make_mask_fn(mode, window, prefix)(torch.tensor(q),
                                                 torch.tensor(kv))
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cross_attention_has_no_qk_norm():
    cfg = get_smoke_config("gemma3-1b")
    g = torch.Generator().manual_seed(0)
    names = {n for n, _ in tattn.init_attention(cfg, g, "cpu", cross=True)
             .named_parameters()}
    assert names == {"wq", "wk", "wv", "wo"}


def _specs(tree):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in jax.tree.leaves(tree, is_leaf=torch.is_tensor)]


@pytest.mark.parametrize("arch", sorted(jax_archs()))
def test_io_specs_and_batch_match_jax(arch):
    """batch_specs, decode_specs (meta tensors) and make_batch have the
    reference's structure, shapes and dtypes; labels are the tokens rolled
    by one, -1 over paligemma's prefix."""
    assert list_archs() == sorted(jax_archs())
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    for shape in ("train_4k", "decode_32k"):
        jb = jio.batch_specs(jcfg, JAX_SHAPES[shape], batch=2, seq=64)
        tb = tio.batch_specs(cfg, LM_SHAPES[shape], batch=2, seq=64)
        assert sorted(tb) == sorted(jb)
        assert all(t.device.type == "meta" for t in tb.values())
        assert _specs(tb) == _specs(jb)
    jd = jio.decode_specs(jcfg, JAX_SHAPES["decode_32k"], batch=2, seq=64)
    td = tio.decode_specs(cfg, LM_SHAPES["decode_32k"], batch=2, seq=64)
    assert jax.tree.structure(jd) == jax.tree.structure(
        td, is_leaf=torch.is_tensor)
    assert _specs(td) == _specs(jd)
    batch = tio.make_batch(cfg, torch.Generator().manual_seed(0), 2, 64)
    assert _specs(batch) == _specs(jb)
    tok, labels = batch["tokens"], batch["labels"]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    P = labels.shape[1] - tok.shape[1]
    assert (labels[:, :P] == -1).all()
    np.testing.assert_array_equal(labels[:, P:].numpy(),
                                  np.roll(tok.numpy(), -1, axis=1))


def test_prefix_decode_attends_to_the_prefix_slots():
    """paligemma decode allows every slot below n_prefix_tokens, written or
    not (``allow |= kv_pos < prefix_len``): at position 0 of a zero cache
    the zero keys of the prefix slots dilute the attention, as in the
    reference."""
    jc, tc, jp, tp = models("paligemma-3b", "float32", seed=5)
    x = np.random.default_rng(5).standard_normal((2, 1, tc.d_model)).astype(
        np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"][0])["attn"]
    tblk = tp.layers[0].attn
    outs = []
    for prefix in (0, tc.n_prefix_tokens):
        jcache = jattn.init_attn_cache(jc, "global", 2, 8, jnp.float32)
        tcache = tattn.init_attn_cache(tc, "global", 2, 8, torch.float32, "cpu")
        jo, _ = jattn.attention_decode(jblk, jnp.asarray(x), jc, "global",
                                       jcache, jnp.int32(0), prefix)
        to, _ = tattn.attention_decode(tblk, torch.tensor(x), tc, "global",
                                       tcache, 0, prefix)
        close(to, jo, TOL["float32"], f"prefix_len {prefix}")
        outs.append(to)
    assert not torch.allclose(outs[0], outs[1])


def _recording(decode, log):
    def wrapped(*args):
        logits, cache = decode(*args)
        log.append(np.asarray(logits[:, -1].float() if torch.is_tensor(logits)
                              else logits[:, -1].astype(jnp.float32)))
        return logits, cache
    return wrapped


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """Teacher-forced as in tests/test_torch_serving.py::test_engine_matches_jax
    (bf16, logits at 5e-2, tokens wherever the reference's top-2 margin
    exceeds it), with the reference's quirks: whisper's decoder cache has
    max_len // 4 = 8 slots, so positions past 7 write slot 7, and its cross
    caches stay zero (the engine never runs the encoder); paligemma's decode
    attends to the zero keys of the 4 prefix slots (the engine never
    prefills patches)."""
    jc, tc, jp, tp = models(arch, "bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tc.vocab_size, size=n).astype(np.int32)
               for n in (5, 3, 7)]
    je = jeng.ServingEngine(jc, jp, n_slots=2, max_len=32)
    te = teng.ServingEngine(tc, tp, n_slots=2, max_len=32, device="cpu")
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
    assert checked > 0, "no token had a clear margin"
    entry = te.cache["blocks"][0]
    if arch == "whisper-small":
        assert entry["k"].shape[2] == 32 // tc.dec_len_ratio
        assert entry["ck"].shape[2] == 32
        assert not entry["ck"].any() and not entry["cv"].any()
        assert max(len(p) for p in prompts) + 6 > entry["k"].shape[2]
    else:
        assert te.cfg.n_prefix_tokens == 4 and entry["k"].shape[2] == 32


def test_batch_inputs_reach_the_reference_paths():
    """The prefill batch of each frontend is the reference's: whisper's
    logits depend on its frames, paligemma's on its patches."""
    for arch, key in (("whisper-small", "frames"), ("paligemma-3b", "patches")):
        _, tc, _, tp = models(arch, "float32")
        batch = numpy_batch(tc, 2, 32, 0)
        a, _ = ttf.forward_prefill(tp, tc, as_torch(batch))
        batch[key] = batch[key] + 1
        b, _ = ttf.forward_prefill(tp, tc, as_torch(batch))
        assert not torch.allclose(a, b), arch
