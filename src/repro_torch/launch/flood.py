"""The paper's flood-disaster mission end to end on the port:
``PYTHONPATH=src python -m repro_torch.launch.flood [--device cuda|cpu]
[--size-mb 10] [--fusion-depth 2]``.

Drones stream video to LEO satellites; Ingest filters blurry frames, Detect
runs a person-detection DNN, Map runs a flood CNN, Alarm decides — each body
real torch compute on ``--device`` (CUDA by default), with Databelt state
propagation and function fusion, declared as one ``Scenario`` (the twin of
``examples/flood_detection.py``).  Prints the placement, the latency split
and the local reads.
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.scenario import Scenario, WorkloadSpec
from repro_torch.serverless.workflow import flood_workflow


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size-mb", type=float, default=10.0)
    ap.add_argument("--fusion-depth", type=int, default=2)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sc = Scenario(workload=WorkloadSpec(kind="sequential"),
                  strategy="databelt", n=1, input_bytes=args.size_mb * 1e6,
                  fusion_depth=args.fusion_depth, real_compute=True)

    # peek at the control plane before running: the same engine the
    # scenario drives, built from the same spec
    eng = sc.build_engine(device=device)
    placement = eng.place_functions(flood_workflow("flood-mission-0"), 0.0)
    print("function placement (HyperDrive planner):")
    for f, n in placement.items():
        print(f"  {f:<8s} -> {n}")

    m = sc.run(device=device).instances[0]
    print(f"\nworkflow latency   {m.latency:6.2f}s "
          f"(compute {m.compute_time:.2f}s, state read {m.read_time:.2f}s, "
          f"write {m.write_time:.2f}s) on {device}")
    print(f"local state reads  {m.local_reads}/{m.reads} "
          f"({100*m.local_availability:.0f}%)")
    print(f"storage ops        {m.storage_ops} "
          f"(fusion depth {args.fusion_depth})")
    print(f"SLO (60ms handoff) {m.slo_violations}/{m.handoffs} violations")
    return m


if __name__ == "__main__":
    main()
