"""Twins of tests/test_optim_train.py for the port: optimizers, schedule,
checkpoint/restart, training loop, data pipeline, straggler monitor.  The
two tests of ``distributed/compression.py`` wait for its port.  No JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import TwoTierCheckpoint  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.optim import adafactor, adamw, cosine_schedule  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402


def test_adamw_minimizes_quadratic():
    opt = adamw(weight_decay=0.0, max_grad_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    st = opt.init(params)
    for i in range(200):
        g = {"w": 2 * params["w"]}          # d/dw w^2
        params, st, _ = opt.update(g, st, params, 0.05)
    assert float(params["w"].abs().max()) < 0.2


def test_adafactor_minimizes_quadratic():
    opt = adafactor(weight_decay=0.0)
    params = {"w": torch.full((4, 4), 2.0)}
    st = opt.init(params)
    for i in range(200):
        g = {"w": 2 * params["w"]}
        params, st, _ = opt.update(g, st, params, 0.05)
    assert float(params["w"].abs().max()) < 0.3


def test_adafactor_state_is_factored():
    opt = adafactor()
    p = {"w": torch.zeros((64, 32))}
    st = opt.init(p)
    assert st["vs"]["w"]["vr"].shape == (64,)
    assert st["vs"]["w"]["vc"].shape == (32,)


def test_cosine_schedule():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-4
    assert float(lr(5)) < float(lr(10))


def test_train_loop_loss_decreases(tmp_path):
    cfg = get_smoke_config("h2o-danube-1.8b")
    loop = TrainLoop(cfg, adamw(weight_decay=0.0), batch=4, seq=32,
                     lr=3e-3, ckpt_dir=None, device="cpu")
    m = loop.run(30, log_every=0)
    first = np.mean(m.losses[:5])
    last = np.mean(m.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_checkpoint_restart_resumes(tmp_path):
    cfg = get_smoke_config("h2o-danube-1.8b")
    ck = str(tmp_path / "ck")
    loop = TrainLoop(cfg, adamw(weight_decay=0.0), batch=2, seq=32,
                     lr=1e-3, ckpt_dir=ck, device="cpu")
    # crash at step 25 (checkpoints at 10, 20)
    with pytest.raises(RuntimeError):
        loop.run(40, fail_at=25, log_every=0)
    loop2 = TrainLoop(cfg, adamw(weight_decay=0.0), batch=2, seq=32,
                      lr=1e-3, ckpt_dir=ck, device="cpu")
    state, start = loop2.init_or_restore()
    assert start == 20 and int(state["step"]) == 20
    m = loop2.run(30, log_every=0)
    assert m.steps == 30


def test_checkpoint_tiers_and_gc(tmp_path):
    ck = TwoTierCheckpoint(str(tmp_path / "c"), local_every=1,
                           global_every=5, keep=2)
    state = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}}
    for step in range(1, 8):
        ck.maybe_save(state, step)
    ck.wait()
    locs = sorted(ck.local_dir.glob("*.ckpt"))
    globs = sorted(ck.global_dir.glob("*.ckpt"))
    assert len(locs) <= 2 and len(globs) >= 1
    target = {"a": torch.zeros(4), "b": {"c": torch.zeros((2, 2))}}
    restored, step = ck.restore(target)
    assert step == 7
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(4.0))


def test_data_pipeline_deterministic():
    from repro_torch.data import SyntheticTokens
    cfg = get_smoke_config("internlm2-20b")
    a = SyntheticTokens(cfg, 2, 16, seed=3).batch_for_step(7)
    b = SyntheticTokens(cfg, 2, 16, seed=3).batch_for_step(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticTokens(cfg, 2, 16, seed=3).batch_for_step(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_straggler_monitor():
    from repro_torch.train.straggler import StragglerMonitor
    mon = StragglerMonitor(threshold=2.0)
    for step in range(5):
        for h in ("host0", "host1", "host2", "host3"):
            mon.record(h, 1.0 if h != "host2" else 5.0)
    assert mon.stragglers() == ["host2"]
    assert not mon.available("host2")
    assert mon.available("host0")
    assert "host2" not in mon.healthy_hosts()
    # recovery: host2 speeds back up
    for step in range(20):
        mon.record("host2", 1.0)
    assert mon.available("host2")
