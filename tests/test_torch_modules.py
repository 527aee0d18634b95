"""The port's building blocks (repro_torch.models.modules) against the JAX
reference (repro.models.modules) on the same numpy inputs.

Tolerances: f32 1e-5 (the two frameworks differ only in summation order and
in the last bits of cos/sin/tanh); bf16 2e-2 absolute and relative (about
two bf16 ulps near 1, where one rounding step may land differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import modules as jm  # noqa: E402
from repro_torch.models import modules as tm  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dt):
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _close(j, t, dt):
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3.0
    scale = rng.standard_normal(64).astype(np.float32) * 0.5
    jx, tx = _pair(x, dt)
    _close(jm.rms_norm(jx, jnp.asarray(scale), 1e-6),
           tm.rms_norm(tx, torch.tensor(scale), 1e-6), dt)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dt", DTYPES)
def test_rope(theta, dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    jx, tx = _pair(x, dt)
    _close(jm.rope(jx, jnp.asarray(pos), theta),
           tm.rope(tx, torch.tensor(pos), theta), dt)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_plain", "relu_sq"])
@pytest.mark.parametrize("dt", DTYPES)
def test_activation(name, dt):
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    jx, tx = _pair(x, dt)
    _close(jm.activation(name)(jx), tm.activation(name)(tx), dt)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
@pytest.mark.parametrize("dt", DTYPES)
def test_mlp(act, dt):
    rng = np.random.default_rng(3)
    d, f = 64, 128
    names = ["w_up", "w_down"] if act == "gelu_plain" else \
        ["w_gate", "w_up", "w_down"]
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    w = {n: (rng.standard_normal(shapes[n]) * shapes[n][0] ** -0.5)
         .astype(np.float32) for n in names}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    jx, tx = _pair(x, dt)
    jp = {n: _pair(a, dt)[0] for n, a in w.items()}
    tp = tm.MLP({n: _pair(a, dt)[1] for n, a in w.items()})
    _close(jm.mlp(jp, jx, act), tm.mlp(tp, tx, act), dt)
