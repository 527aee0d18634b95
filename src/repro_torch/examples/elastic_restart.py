"""Fault tolerance demo: a training run is killed mid-flight ("node
failure"), then restarted from the freshest two-tier checkpoint — data order
and optimizer state resume exactly (Databelt's local/global storage design
applied to training state).  The port's twin of
``examples/elastic_restart.py``.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
"""
import argparse
import tempfile

from repro_torch.configs.base import get_smoke_config
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("gemma3-1b")
    with tempfile.TemporaryDirectory() as d:
        print("phase 1: train to step 60, 'node failure' at step 45")
        loop = TrainLoop(cfg, adamw(), batch=4, seq=32, lr=1e-3, ckpt_dir=d,
                         device=args.device)
        try:
            loop.run(60, fail_at=45, log_every=20)
        except RuntimeError as e:
            print(f"  !! {e}")

        print("phase 2: restart — restore from freshest tier, resume")
        loop2 = TrainLoop(cfg, adamw(), batch=4, seq=32, lr=1e-3, ckpt_dir=d,
                          device=args.device)
        state, start = loop2.init_or_restore()
        print(f"  restored at step {start} "
              f"(local tier, async-written)")
        m = loop2.run(60, log_every=20)
        print(f"  finished at step {m.steps}; final loss "
              f"{m.final_loss:.4f}")
        assert m.steps == 60
        return m


if __name__ == "__main__":
    main()
