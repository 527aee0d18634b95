"""databelt-lint CLI.

Usage:
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch   # lint
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --strict
    PYTHONPATH=src python -m repro_torch.analysis --list-checks
    PYTHONPATH=src python -m repro_torch.analysis --replay-smoke  # sanitizer
    PYTHONPATH=src python -m repro_torch.analysis --race-smoke    # HB races
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --format sarif > out.sarif

Exit codes: 0 clean (suppressed/allowlisted findings do not fail),
1 unsuppressed findings (or, with --strict, undocumented suppressions;
or a diverging replay with --replay-smoke; or an unordered conflicting
access with --race-smoke).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.config import AnalysisConfig, default_config
from repro_torch.analysis.framework import run_analysis
from repro_torch.analysis.report import (exit_code, render, render_catalog,
                                   render_sarif)


def replay_smoke() -> int:
    """Fig18-style churn spec run through the replay sanitizer: 2-region
    continuum, regional-diurnal arrivals, Poisson cloud drains — the
    configuration with the most moving parts (faults + cross-region
    fallback), verified to replay bit-identically and, if not, localized
    to its first divergent event."""
    from repro_torch.scenario import (FaultPlan, NetworkSpec, Scenario,
                                WorkloadSpec)
    sc = Scenario(
        network=NetworkSpec(regions=2),
        workload=WorkloadSpec(kind="regional_diurnal", rate=8.0,
                              peak_to_trough=2.0, seed=11),
        strategy="databelt", n=24, input_bytes=2e6,
        faults=FaultPlan.poisson(rate=0.1, outage_s=6.0,
                                 targets=("cloud0", "cloud1"),
                                 horizon_s=14.0, seed=7))
    check = sc.verify_replay()
    print(check.describe())
    return 0 if check.ok else 1


def race_smoke() -> int:
    """Fig20-style DAG spec run under the happens-before race sanitizer:
    diamond workflows fanning out across a 2-region continuum while the
    autoscaler resizes pools and Poisson drains knock clouds out — the
    densest same-timestamp interleaving the benchmarks exercise.  Clean
    means every conflicting access pair was ordered by spawn/wake,
    acquire→release, or the clock itself; a race is localized to its
    first conflicting event index and both process labels."""
    from repro_torch.scenario import (AutoscalePolicy, FaultPlan, NetworkSpec,
                                Scenario, WorkloadSpec)
    sc = Scenario(
        network=NetworkSpec(regions=2),
        workload=WorkloadSpec(kind="regional_diurnal", rate=8.0,
                              peak_to_trough=2.0, seed=11),
        strategy="databelt", n=24, input_bytes=2e6,
        workflow="diamond:3",
        autoscale=AutoscalePolicy(interval_s=0.5, p95_slo_s=2.0),
        faults=FaultPlan.poisson(rate=0.1, outage_s=6.0,
                                 targets=("cloud0", "cloud1"),
                                 horizon_s=14.0, seed=7))
    check = sc.verify_races()
    print(check.describe())
    return 0 if check.ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="databelt-lint: determinism & replay-invariant "
                    "analyzer")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to analyze (default: "
                         "src/repro_torch/)")
    ap.add_argument("--strict", action="store_true",
                    help="require a reason on every used suppression "
                         "pragma")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed/allowlisted findings")
    ap.add_argument("--config", default=None,
                    help="JSON config overriding scopes/allowlist")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the check catalog and exit")
    ap.add_argument("--replay-smoke", action="store_true",
                    help="run the runtime replay sanitizer on a churn "
                         "spec instead of linting")
    ap.add_argument("--race-smoke", action="store_true",
                    help="run the happens-before race sanitizer on a "
                         "DAG+churn+autoscale spec instead of linting")
    ap.add_argument("--format", choices=("text", "sarif"), default="text",
                    help="finding output format (sarif emits a SARIF "
                         "2.1.0 document for CI upload)")
    args = ap.parse_args(argv)

    if args.list_checks:
        print(render_catalog())
        return 0
    if args.replay_smoke:
        return replay_smoke()
    if args.race_smoke:
        return race_smoke()

    config = AnalysisConfig.from_json(args.config) if args.config \
        else default_config()
    # differs from repro/analysis/__main__.py:110: the port's own tree
    paths = args.paths or ["src/repro_torch"]
    findings = run_analysis(paths, config=config,
                            require_reasons=args.strict)
    if args.format == "sarif":
        print(render_sarif(findings))
    else:
        print(render(findings, show_suppressed=args.show_suppressed))
    return exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
