"""databelt-lint in the port (repro_torch.analysis) against the reference
(repro.analysis): the twins of tests/test_analysis.py, the parity of the two
analyzers over the simulator packages, and the pins that both lint trees
stay clean.

Every fixture goes through both analyzers, the port's with the module name
``repro_torch.X`` and the reference's with ``repro.X``; their findings must
be identical (code, line, column, message, hint, suppressed, allowlisted)
before the twin's own assertions run on the port's.
"""
import pathlib
import textwrap

import pytest

pytest.importorskip("torch")

import repro.analysis as ja  # noqa: E402
from repro_torch.analysis import (CHECK_CATALOG, analyze_source,  # noqa: E402
                                  default_config)
from repro_torch.analysis import framework as tframework  # noqa: E402
from repro_torch.analysis.report import active, exit_code, render  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIM_PACKAGES = ("sim", "serverless", "continuum", "core", "scenario")


def reference_module(module):
    """``repro_torch.X`` -> ``repro.X``; anything else as it is."""
    if module is not None and module.split(".")[0] == "repro_torch":
        return "repro" + module[len("repro_torch"):]
    return module


def key(f):
    return (f.path, f.code, f.line, f.col, f.message, f.hint, f.suppressed,
            f.allowlisted)


def both(src, module, path="<memory>"):
    """The port's findings on ``src``, held equal to the reference's."""
    got = analyze_source(src, path=path, module=module)
    want = ja.analyze_source(src, path=path, module=reference_module(module))
    assert [key(f) for f in got] == [key(f) for f in want]
    return got


def findings_for(src, code=None, module=None):
    out = both(textwrap.dedent(src), module)
    if code is not None:
        out = [f for f in out if f.code == code]
    return out


def active_for(src, code=None, module=None):
    return [f for f in findings_for(src, code, module)
            if not f.suppressed and not f.allowlisted]


def run_analysis(paths, **kw):
    """The port's ``run_analysis``, held equal to the reference's on files
    outside both packages (each analyzer gives them the full battery)."""
    got = tframework.run_analysis(paths, **kw)
    assert [key(f) for f in got] == \
        [key(f) for f in ja.run_analysis(paths, **kw)]
    return got


# ---------------------------------------------------------------------------
# DB001 — wall-clock reads
# ---------------------------------------------------------------------------
def test_db001_flags_wall_clock():
    fs = active_for("""
        import time
        def sample():
            return time.time()
    """, "DB001")
    assert len(fs) == 1
    assert "time.time" in fs[0].message
    assert fs[0].line == 4


def test_db001_resolves_import_aliases():
    fs = active_for("""
        import time as _t
        def sample():
            return _t.perf_counter()
    """, "DB001")
    assert len(fs) == 1
    assert "time.perf_counter" in fs[0].message


def test_db001_clean_on_simulated_time():
    assert active_for("""
        def sample(kernel):
            return kernel.now
    """, "DB001") == []


# ---------------------------------------------------------------------------
# DB002 — unseeded RNG
# ---------------------------------------------------------------------------
def test_db002_flags_global_rng():
    fs = active_for("""
        import random
        def jitter():
            return random.random() + random.gauss(0, 1)
    """, "DB002")
    assert len(fs) == 2


def test_db002_flags_numpy_global():
    fs = active_for("""
        import numpy as np
        def jitter():
            return np.random.rand(3)
    """, "DB002")
    assert len(fs) == 1


def test_db002_clean_on_seeded_generators():
    assert active_for("""
        import random
        import numpy as np
        def jitter(seed):
            rng = random.Random(seed)
            g = np.random.default_rng(seed)
            return rng.random() + g.standard_normal()
    """, "DB002") == []


# ---------------------------------------------------------------------------
# DB003 — unordered set iteration
# ---------------------------------------------------------------------------
def test_db003_flags_set_iteration():
    fs = active_for("""
        def schedule(kernel, procs):
            pending = set(procs)
            for p in pending:
                kernel.spawn(p)
    """, "DB003")
    assert len(fs) == 1


def test_db003_flags_set_algebra():
    fs = active_for("""
        def schedule(a, b):
            live = set(a)
            out = [x for x in live - set(b)]
            return out
    """, "DB003")
    assert len(fs) == 1


def test_db003_clean_on_sorted_and_lists():
    assert active_for("""
        def schedule(kernel, procs):
            pending = set(procs)
            for p in sorted(pending):
                kernel.spawn(p)
            for q in list(procs):
                kernel.spawn(q)
    """, "DB003") == []


def test_db003_set_inference_is_scope_local():
    # a set-typed `names` in one method must not taint a list-typed
    # `names` in a sibling (the workflow.py false positive)
    assert active_for("""
        class W:
            def validate(self):
                names = {f.name for f in self.fns}
                return len(names)
            def order(self):
                names = [f.name for f in self.fns]
                return [n for n in names]
    """, "DB003") == []


def test_db003_scoped_to_event_feeding_packages():
    src = """
        def walk(items):
            for x in set(items):
                print(x)
    """
    assert active_for(src, "DB003", module="repro_torch.sim.kernel")
    assert active_for(src, "DB003", module="repro_torch.core.topology") == []


# ---------------------------------------------------------------------------
# DB004 — id()-keyed memos
# ---------------------------------------------------------------------------
#: the pre-fix ``core/propagation.py`` memo, verbatim shape: id()-keyed,
#: nothing pinning the callable alive, no identity re-check on hits.
PREFIX_PROPAGATION = """
    _IDENTIFY_CACHE = {}

    def identify_cached(graph, available, t):
        key = (id(available), graph._version)
        hit = _IDENTIFY_CACHE.get(key)
        if hit is not None:
            return hit
        keep = [n for n in graph.nodes if available(n, t)]
        pruned = _prune(graph, keep)
        _IDENTIFY_CACHE[key] = pruned
        return pruned
"""


def test_db004_fires_on_prefix_propagation_memo():
    fs = active_for(PREFIX_PROPAGATION, "DB004")
    assert len(fs) == 1
    assert "alias" in fs[0].message


def test_db004_clean_with_paired_strong_ref():
    assert active_for("""
        _CACHE = {}

        def memo(graph, available):
            _CACHE[id(available)] = (available, prune(graph))
            return _CACHE[id(available)][1]
    """, "DB004") == []


def test_db004_clean_with_identity_guard():
    assert active_for("""
        _CACHE = {}

        def memo(graph, available):
            hit = _CACHE.get(id(available))
            if hit is not None and hit[0] is available:
                return hit[1]
            return prune(graph)
    """, "DB004") == []


# ---------------------------------------------------------------------------
# DB005 — kernel-process protocol
# ---------------------------------------------------------------------------
def test_db005_flags_unknown_effect_op():
    fs = active_for("""
        def proc(res):
            yield ("aquire", res)
            yield ("release", res)
    """, "DB005")
    assert len(fs) == 1
    assert "aquire" in fs[0].message


def test_db005_flags_blocking_builtin_in_process():
    fs = active_for("""
        import time
        def proc():
            time.sleep(1.0)
            yield 0.5
    """, "DB005")
    assert len(fs) == 1
    assert "time.sleep" in fs[0].message


def test_db005_clean_on_well_formed_process():
    assert active_for("""
        def proc(res):
            yield 1.5
            yield ("acquire", res)
            yield 0.1
            yield ("release", res)
    """, "DB005") == []


def test_db005_ignores_non_generators():
    # time.sleep outside a process generator is DB001's (and the
    # allowlist's) business, not a protocol violation
    assert active_for("""
        import time
        def not_a_process():
            time.sleep(1.0)
    """, "DB005") == []


# ---------------------------------------------------------------------------
# DB006 — version-guard discipline
# ---------------------------------------------------------------------------
def test_db006_flags_mutation_without_bump():
    fs = active_for("""
        class TopologyGraph:
            def add_node(self, n):
                self.nodes[n.node_id] = n
    """, "DB006")
    assert len(fs) == 1
    assert "without bumping" in fs[0].message


def test_db006_flags_memo_read_without_version_check():
    fs = active_for("""
        class TopologyGraph:
            def sssp(self, src):
                hit = self._sssp.get(src)
                if hit is not None:
                    return hit
                return self._dijkstra(src)
    """, "DB006")
    assert len(fs) == 1
    assert "_version" in fs[0].message


def test_db006_clean_with_bump_and_check():
    assert active_for("""
        class TopologyGraph:
            def add_node(self, n):
                self.nodes[n.node_id] = n
                self._version += 1
            def sssp(self, src):
                hit = self._sssp.get(src)
                if hit is not None and hit[0] == self._version:
                    return hit[1]
                return self._dijkstra(src)
    """, "DB006") == []


def test_db006_only_checks_configured_classes():
    assert active_for("""
        class Scratchpad:
            def add_node(self, n):
                self.nodes[n.node_id] = n
    """, "DB006") == []


# ---------------------------------------------------------------------------
# DB007 — slot acquire/release pairing
# ---------------------------------------------------------------------------
def test_db007_flags_leaked_acquire():
    fs = active_for("""
        def proc(res):
            yield ("acquire", res)
            yield 1.0
    """, "DB007")
    assert len(fs) == 1
    assert "leaks" in fs[0].message


def test_db007_clean_on_paired_slots():
    assert active_for("""
        def proc(a, b):
            yield ("acquire", a)
            yield ("acquire", b)
            yield 1.0
            yield ("release", b)
            yield ("release", a)
    """, "DB007") == []


# ---------------------------------------------------------------------------
# DB008 — host-clock timestamps flowing into telemetry
# ---------------------------------------------------------------------------
def test_db008_flags_wall_clock_telemetry_timestamp():
    fs = active_for("""
        import time
        def emit(rec):
            rec.instant("tick", "kernel", "cpu:n0", t=time.time())
    """, "DB008", module="repro_torch.sim.fixture")
    assert len(fs) == 1
    assert "time.time" in fs[0].message and ".instant(" in fs[0].message


def test_db008_flags_clock_read_nested_in_span_attr():
    fs = active_for("""
        import time
        def emit(rec, sid):
            rec.end(sid, elapsed=time.perf_counter() - 3.0)
    """, "DB008", module="repro_torch.serverless.fixture")
    assert len(fs) == 1
    assert "time.perf_counter" in fs[0].message


def test_db008_clean_on_kernel_clock_and_bound_recorder():
    assert active_for("""
        def emit(rec, kernel):
            rec.instant("tick", "kernel", "cpu:n0", t=kernel.now)
            sid = rec.begin("phase", "phase", "lane")
            rec.end(sid)
            rec.complete("op", "storage", "n0", 0.0, kernel.now)
    """, "DB008", module="repro_torch.continuum.fixture") == []


def test_db008_scope_excludes_measurement_harnesses():
    # repro_torch.launch is real wall-clock by design; DB008's scope is the
    # simulator packages only
    assert findings_for("""
        import time
        def emit(rec):
            rec.log(time.time())
    """, "DB008", module="repro_torch.launch.dryrun") == []


# ---------------------------------------------------------------------------
# DB009 — kernel child spawns scheduled from set iteration
# ---------------------------------------------------------------------------
def test_db009_flags_spawn_from_set_iteration():
    fs = active_for("""
        def launch(kernel, branches):
            ready = set(branches)
            for b in ready:
                kernel.spawn(b.proc(), label=b.name)
    """, "DB009", module="repro_torch.serverless.fixture")
    assert len(fs) == 1
    assert ".spawn(" in fs[0].message


def test_db009_flags_wake_from_set_algebra():
    fs = active_for("""
        def release(kernel, waiting, done):
            for w in set(waiting) - set(done):
                kernel.wake(w.proc, w.label)
    """, "DB009", module="repro_torch.serverless.fixture")
    assert len(fs) == 1
    assert ".wake(" in fs[0].message


def test_db009_clean_on_ordered_scheduling():
    # the shipped pattern: topo-ordered lists / dicts / sorted sets
    assert active_for("""
        def launch(kernel, branches, pending):
            for b in branches:
                kernel.spawn(b.proc(), label=b.name)
            for b in sorted(set(pending)):
                kernel.spawn(b.proc(), label=b.name)
    """, "DB009", module="repro_torch.serverless.fixture") == []


def test_db009_scoped_to_serverless():
    # DB003 still covers repro_torch.sim; DB009 pins the serverless DAG
    # scheduler specifically
    assert findings_for("""
        def launch(kernel, branches):
            for b in set(branches):
                kernel.spawn(b.proc(), label=b.name)
    """, "DB009", module="repro_torch.core.fixture") == []


# ---------------------------------------------------------------------------
# suppression pragma + allowlist mechanics
# ---------------------------------------------------------------------------
def test_pragma_suppresses_same_line():
    fs = findings_for("""
        import time
        def sample():
            return time.time()  # repro: allow(DB001): fixture
    """, "DB001")
    assert len(fs) == 1 and fs[0].suppressed


def test_pragma_on_comment_line_suppresses_next_code_line():
    fs = findings_for("""
        import time
        def sample():
            # repro: allow(DB001): fixture
            return time.time()
    """, "DB001")
    assert len(fs) == 1 and fs[0].suppressed


def test_pragma_is_code_specific():
    fs = findings_for("""
        import time
        def sample():
            return time.time()  # repro: allow(DB002): wrong code
    """, "DB001")
    assert len(fs) == 1 and not fs[0].suppressed


def test_allowlist_marks_but_keeps_findings():
    fs = findings_for("""
        import time
        def stamp():
            return time.time()
    """, "DB001", module="repro_torch.launch.dryrun")
    assert len(fs) == 1 and fs[0].allowlisted
    assert exit_code(fs) == 0


def test_exit_code_fails_on_active_findings():
    fs = findings_for("""
        import time
        def sample():
            return time.time()
    """, "DB001")
    assert active(fs) == fs
    assert exit_code(fs) == 1
    assert "DB001" in render(fs)


def test_strict_requires_reason_on_used_pragmas(tmp_path):
    bad = tmp_path / "bare.py"
    bad.write_text("import time\n"
                   "t = time.time()  # repro: allow(DB001)\n")
    fs = run_analysis([str(bad)], require_reasons=True)
    assert any(f.code == "DB000" for f in fs)
    assert exit_code(fs) == 1
    # same pragma with a reason is fine
    good = tmp_path / "documented.py"
    good.write_text("import time\n"
                    "t = time.time()  # repro: allow(DB001): fixture\n")
    fs = run_analysis([str(good)], require_reasons=True)
    assert exit_code(fs) == 0


def test_db000_on_unparseable_file(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def oops(:\n")
    fs = run_analysis([str(f)])
    assert [f.code for f in fs] == ["DB000"]


def test_catalog_covers_db001_through_db007():
    assert {f"DB{i:03d}" for i in range(1, 8)} <= set(CHECK_CATALOG)


# ---------------------------------------------------------------------------
# parity over the simulator packages: each source through both analyzers
# ---------------------------------------------------------------------------
SIM_SOURCES = sorted(
    str(p.relative_to(ROOT)) for pkg in SIM_PACKAGES
    for root in ("repro", "repro_torch")
    for p in (ROOT / "src" / root / pkg).rglob("*.py"))


@pytest.mark.parametrize("path", SIM_SOURCES)
def test_findings_match_reference_on_simulator_sources(path):
    """The reference's five simulator packages and the port's copies, each
    file through both analyzers under its mapped module name: identical
    findings, suppressions included."""
    parts = pathlib.Path(path).with_suffix("").parts[2:]
    module = ".".join(("repro_torch",) + parts)
    if module.endswith(".__init__"):
        module = module[:-len(".__init__")]
    both((ROOT / path).read_text(), module, path=path)


def test_simulator_sources_are_covered():
    ref = [p for p in SIM_SOURCES if p.startswith("src/repro/")]
    port = [p for p in SIM_SOURCES if p.startswith("src/repro_torch/")]
    assert len(ref) == len(port) >= 26


def test_module_name_of_takes_the_port_as_root():
    assert tframework.module_name_of(
        pathlib.Path("src/repro_torch/sim/kernel.py")) == "repro_torch.sim.kernel"
    assert tframework.module_name_of(
        pathlib.Path("src/repro_torch/analysis/__init__.py")) == \
        "repro_torch.analysis"
    assert tframework.module_name_of(pathlib.Path("tests/test_x.py")) == \
        "tests.test_x"
    # the reference package is outside the port's root: the full battery
    assert tframework.module_name_of(
        pathlib.Path("src/repro/sim/kernel.py")) is None


def port_glob(pattern):
    """A reference glob ``repro.X`` read as the port's ``repro_torch.X``."""
    if pattern.startswith("repro."):
        return "repro_torch" + pattern[len("repro"):]
    return pattern


def test_config_is_the_reference_config_with_the_root_renamed():
    """Every scope and allowlist glob of the port's config is the
    reference's with ``repro.`` read as ``repro_torch.``; the rest is the
    reference's."""
    ref, port = ja.default_config(), default_config()
    assert port.scopes == {code: [port_glob(p) for p in pats]
                           for code, pats in ref.scopes.items()}
    assert port.allowlist == {port_glob(p): codes
                              for p, codes in ref.allowlist.items()}
    assert [vars(v) for v in port.versioned_classes] == \
        [vars(v) for v in ref.versioned_classes]
    assert port.known_ops == ref.known_ops
    assert port.blocking_calls == ref.blocking_calls
    assert CHECK_CATALOG == ja.CHECK_CATALOG
    assert sorted(tframework.CHECKERS) == sorted(ja.CHECKERS)


# ---------------------------------------------------------------------------
# tier-1 pins: both lint trees are clean under --strict semantics
# ---------------------------------------------------------------------------
def test_src_tree_has_zero_active_findings(repo_src):
    fs = tframework.run_analysis([str(repo_src / "repro_torch")],
                                 require_reasons=True)
    bad = active(fs)
    assert bad == [], "\n".join(f.format() for f in bad)


def test_reference_lint_is_clean_over_the_port(repo_src):
    """The reference's analyzer sees the port as files outside its package
    (the full battery, no allowlist): each of the port's wall-clock reads
    must carry a documented ``# repro: allow(DB001)`` pragma, so that
    ``python -m repro.analysis src/ benchmarks/ tests/ --strict`` stays
    clean over a tree that holds the port."""
    fs = ja.run_analysis([str(repo_src / "repro_torch")],
                         require_reasons=True)
    bad = active(fs)
    assert bad == [], "\n".join(f.format() for f in bad)
    assert sum(f.code == "DB001" and f.suppressed for f in fs) >= 9


def test_cli_smoke(repo_src, capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--list-checks"]) == 0
    assert "DB001" in capsys.readouterr().out
    assert main([str(repo_src / "repro_torch"), "--strict"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_sarif_matches_reference(repo_src, capsys):
    from repro.analysis.__main__ import main as jmain
    from repro_torch.analysis.__main__ import main as tmain
    path = str(repo_src / "repro_torch" / "serverless")
    assert tmain([path, "--format", "sarif"]) == 0
    got = capsys.readouterr().out
    assert jmain([path, "--format", "sarif"]) == 0
    assert got == capsys.readouterr().out
    assert '"databelt-lint"' in got


@pytest.fixture
def repo_src():
    return ROOT / "src"
