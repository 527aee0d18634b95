"""``repro_torch.analysis`` — databelt-lint: the determinism &
replay-invariant analyzer; the port's twin of ``repro.analysis``.

Static half: an AST pass over the simulator packages reporting typed
``DB0xx`` findings (wall-clock reads, unseeded RNG, unordered iteration,
id()-keyed memos, kernel-protocol violations, version-guard breaches,
slot leaks) with file:line, a fix hint, a ``# repro: allow(DBxxx): why``
suppression pragma and a module allowlist.  Runnable and CI-gated::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --strict

Runtime half: ``repro_torch.analysis.replay`` — trace diffing +
``Scenario.verify_replay()``, which runs a spec twice and reports the
*first divergent event* instead of a bare goldens mismatch — and
``repro_torch.analysis.races`` — the databelt-race gate: static race-shape
checks DB010–DB013 plus ``Scenario.verify_races()`` /
``--race-smoke``, driving the happens-before sanitizer
(``SimKernel(race_detect=True)``) over a full scenario.
"""
from repro_torch.analysis.config import (AnalysisConfig, CHECK_CATALOG,
                                   default_config)
from repro_torch.analysis.framework import (CHECKERS, Checker, Finding,
                                      ModuleUnit, analyze_source,
                                      register_checker, run_analysis)
# importing the checker modules registers them
from repro_torch.analysis import cache as _cache              # noqa: F401
from repro_torch.analysis import determinism as _determinism  # noqa: F401
from repro_torch.analysis import protocol as _protocol        # noqa: F401
from repro_torch.analysis import races as _races              # noqa: F401
from repro_torch.analysis.replay import (ReplayCheck, diff_traces,
                                         verify_scenario)
from repro_torch.analysis.races import RaceCheck, verify_scenario_races

__all__ = [
    "AnalysisConfig", "CHECK_CATALOG", "CHECKERS", "Checker", "Finding",
    "ModuleUnit", "RaceCheck", "ReplayCheck", "analyze_source",
    "default_config", "diff_traces", "register_checker", "run_analysis",
    "verify_scenario", "verify_scenario_races",
]
