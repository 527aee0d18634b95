"""Configuration for the databelt-lint determinism analyzer.

The analyzer's behavior is data-driven: which modules each check applies
to, which modules are *allowlisted* (legitimately wall-clock, like the
compile-measurement harness), and which classes carry a version-guarded
memo discipline.  ``DEFAULT_CONFIG`` encodes today's repo layout; a JSON
file with the same field names can override any of it
(``python -m repro_torch.analysis src/repro_torch --config my.json``).

Scope patterns are ``fnmatch`` globs over *dotted module names*
(``repro_torch.sim.kernel``).  Files that do not live under the
``repro_torch`` package (e.g. fixture snippets in a test tmpdir) match
every scope — the analyzer is a determinism gate for this repo, not a
general linter, so unknown files get the full battery.

The port's twin of ``repro/analysis/config.py``: every module glob reads
``repro_torch.X`` where the reference's reads ``repro.X`` (each such line
is marked), so the port's own packages get the reference's scopes and
allowlist.  ``benchmarks*`` and ``tests*`` stay as they are.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

#: every check code the analyzer knows, with its one-line charter.
CHECK_CATALOG: Dict[str, str] = {
    "DB001": "wall-clock read inside deterministic simulator code",
    "DB002": "unseeded RNG (module-level np.random / bare random.*)",
    "DB003": "iteration over a set feeding event order without sorted()",
    "DB004": "id()-keyed memo without a paired strong ref or identity "
             "guard",
    "DB005": "kernel-process protocol violation (unknown effect op / "
             "blocking builtin in a process generator)",
    "DB006": "version-guarded class mutates cached state without bumping "
             "the version (or reads a memo without the version check)",
    "DB007": "SlotResource acquire without a matching release",
    "DB008": "telemetry/span emission timestamped from the host clock "
             "instead of the kernel clock",
    "DB009": "kernel child-process spawn/wake scheduled from unordered "
             "(set) iteration — branch joins would not replay",
    "DB010": "attribute of an object shared between spawned kernel "
             "processes written in one and accessed in another with no "
             "mediating acquire/release pair or version bump",
    "DB011": "read-modify-write of shared state spanning a yield with "
             "no resource held — the classic lost update",
    "DB012": "daemon process mutating a version-guarded class while "
             "non-daemon processes may hold memo-derived references",
    "DB013": "one mutable container passed into multiple kernel.spawn() "
             "call sites without a copy",
}


@dataclass
class VersionedClass:
    """DB006 description of one version-guarded class."""
    name: str
    #: attributes whose structural mutation must bump the version
    guarded_attrs: Tuple[str, ...]
    #: attribute name of the version counter ("" when the class
    #: invalidates through a method instead)
    version_attr: str = "_version"
    #: method names that perform the invalidation (calling one of these
    #: counts as bumping the version)
    invalidate_methods: Tuple[str, ...] = ()
    #: memo attributes whose reads must consult the version counter
    memo_attrs: Tuple[str, ...] = ()
    #: methods exempt from both rules (constructors, the invalidators
    #: themselves, fresh-object builders)
    exempt_methods: Tuple[str, ...] = ("__init__",)


@dataclass
class AnalysisConfig:
    #: check code -> list of module globs it applies to (["*"] = all)
    scopes: Dict[str, List[str]] = field(default_factory=dict)
    #: module glob -> check codes allowlisted there (module-level
    #: suppression for legitimately wall-clock / nondeterministic code)
    allowlist: Dict[str, List[str]] = field(default_factory=dict)
    #: DB006 class inventory
    versioned_classes: List[VersionedClass] = field(default_factory=list)
    #: DB005 known effect ops a kernel process may yield.  This is the
    #: runtime protocol ``repro_torch.sim.kernel.KNOWN_EFFECT_OPS`` — the
    #: lint must stay importable without the sim's numpy dependency, so the
    #: literal is pinned equal by ``tests/test_torch_races.py`` instead of
    #: imported.
    known_ops: Tuple[str, ...] = ("acquire", "release")
    #: DB005 blocking calls a process generator must never make
    blocking_calls: Tuple[str, ...] = (
        "time.sleep", "open", "input", "socket.socket",
        "subprocess.run", "subprocess.Popen", "os.system")

    # ------------------------------------------------------------------
    def scope_for(self, code: str) -> List[str]:
        return self.scopes.get(code, ["*"])

    def applies(self, code: str, module: Optional[str]) -> bool:
        """Does ``code`` apply to ``module``?  ``module=None`` (a file
        outside the repro_torch package) matches every scope."""
        if module is None:
            return True
        return any(fnmatch(module, pat) for pat in self.scope_for(code))

    def allowlisted(self, code: str, module: Optional[str]) -> bool:
        if module is None:
            return False
        for pat, codes in self.allowlist.items():
            if fnmatch(module, pat) and code in codes:
                return True
        return False

    # ------------------------------------------------------------------
    @classmethod
    def from_json(cls, path: str) -> "AnalysisConfig":
        with open(path) as f:
            d = json.load(f)
        vcs = [VersionedClass(
            name=v["name"],
            guarded_attrs=tuple(v.get("guarded_attrs", ())),
            version_attr=v.get("version_attr", "_version"),
            invalidate_methods=tuple(v.get("invalidate_methods", ())),
            memo_attrs=tuple(v.get("memo_attrs", ())),
            exempt_methods=tuple(v.get("exempt_methods", ("__init__",))),
        ) for v in d.get("versioned_classes", [])]
        base = default_config()
        return cls(
            scopes={**base.scopes, **d.get("scopes", {})},
            allowlist={**base.allowlist, **d.get("allowlist", {})},
            versioned_classes=vcs or base.versioned_classes,
            known_ops=tuple(d.get("known_ops", base.known_ops)),
            blocking_calls=tuple(d.get("blocking_calls",
                                       base.blocking_calls)),
        )


#: module globs of the deterministic simulator core: everything the
#: replayed event loop touches.
DETERMINISTIC_SCOPE = [
    # differs from repro/analysis/config.py:136-137: repro_torch.X
    "repro_torch.sim*", "repro_torch.serverless*", "repro_torch.continuum*",
    "repro_torch.core*", "repro_torch.scenario*",
]


def default_config() -> AnalysisConfig:
    return AnalysisConfig(
        scopes={
            # wall-clock & RNG hygiene applies repo-wide (the allowlist
            # below carves out the measurement harnesses)
            "DB001": ["*"],
            "DB002": ["*"],
            # unordered iteration only matters where it can feed the
            # event heap — harnesses drive the heap too, so benchmarks
            # and tests stay in scope
            # differs from repro/analysis/config.py:151: repro_torch.X
            "DB003": ["repro_torch.sim*", "repro_torch.serverless*",
                      "benchmarks*", "tests*"],
            "DB004": ["*"],
            "DB005": DETERMINISTIC_SCOPE,
            "DB006": ["*"],
            "DB007": ["*"],
            # flight-recorder emission lives in (and is called from)
            # the simulator packages; stamping it from the host clock
            # breaks trace replay without breaking the sim itself
            # differs from repro/analysis/config.py:160-161: repro_torch.X
            "DB008": ["repro_torch.sim*", "repro_torch.serverless*",
                      "repro_torch.continuum*"],
            # the DAG scheduler's contract: child kernel processes
            # (workflow branches) spawn in deterministic order so sync
            # barriers join replay-identically — harness-spawned
            # processes included
            # differs from repro/analysis/config.py:166: repro_torch.X
            "DB009": ["repro_torch.serverless*", "benchmarks*", "tests*"],
            # race shapes (repro_torch.analysis.races): generators sharing
            # state across spawned kernel processes live in the sim and
            # engine packages; DB012 additionally covers the continuum
            # (version-guarded topology mutated by control daemons)
            # differs from repro/analysis/config.py:171-175: repro_torch.X
            "DB010": ["repro_torch.sim*", "repro_torch.serverless*"],
            "DB011": ["repro_torch.sim*", "repro_torch.serverless*"],
            "DB012": ["repro_torch.sim*", "repro_torch.serverless*",
                      "repro_torch.continuum*"],
            "DB013": ["repro_torch.sim*", "repro_torch.serverless*"],
        },
        allowlist={
            # compile/measurement harness: lower+compile timings are
            # real wall time by design, never on a replayed path
            # differs from repro/analysis/config.py:180: repro_torch.X
            "repro_torch.launch.*": ["DB001"],
            # checkpoint metadata records the wall-clock write time —
            # the one legitimately wall-clock field in the repo
            # differs from repro/analysis/config.py:183: repro_torch.X
            "repro_torch.checkpoint.*": ["DB001"],
            # training-loop step timing measures the actual hardware
            # differs from repro/analysis/config.py:185: repro_torch.X
            "repro_torch.train.*": ["DB001"],
            # harnesses are legitimately wall-clock (pytest timing,
            # benchmark wall-time reporting); determinism-relevant
            # checks (DB002/DB003/DB009) still fire there
            "benchmarks*": ["DB001"],
            "tests*": ["DB001"],
        },
        versioned_classes=[
            VersionedClass(
                name="TopologyGraph",
                guarded_attrs=("nodes", "adj"),
                version_attr="_version",
                memo_attrs=("_sssp", "_paths", "_nearest", "_vicinity",
                            "_hops", "_kind_ids", "_pathcost", "_prefix"),
                exempt_methods=("__init__", "copy_shallow"),
            ),
            VersionedClass(
                name="ContinuumNetwork",
                guarded_attrs=("_down_nodes", "_down_links"),
                version_attr="",
                invalidate_methods=("_invalidate",),
                memo_attrs=(),
                exempt_methods=("__init__", "_invalidate",
                                "_make_nodes"),
            ),
        ],
    )
