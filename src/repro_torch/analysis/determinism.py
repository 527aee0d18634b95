"""Determinism checkers: DB001 wall-clock reads, DB002 unseeded RNG,
DB003 unordered-set iteration feeding event order, DB008 host-clock
timestamps flowing into telemetry emission.

Replay of the discrete-event kernel is bit-identical only while every
quantity an event computes is a pure function of (seed, spec, simulated
time).  These checkers guard the classic leaks: the host's clock,
process-global RNG state, Python set iteration order (which hashes
object addresses for non-str keys and is therefore run-dependent), and
span/metric emission stamped from the host clock instead of the kernel
clock (the trace would differ between replays even when the simulation
itself does not).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.framework import (Checker, Finding, ModuleUnit,
                                      register_checker)

#: dotted call targets that read a host clock.  perf_counter/monotonic
#: are included on purpose: *any* host-clock read inside replayed code
#: makes results machine-dependent, monotonic or not.
WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today", "datetime.now",
    "datetime.utcnow",
}

#: attribute calls on the random module that are process-global (seeded,
#: if at all, far from the call site).  Constructing a seeded generator
#: is the sanctioned pattern and stays clean.
_RANDOM_SAFE = {"Random", "SystemRandom", "getstate", "setstate"}
_NP_RANDOM_SAFE = {"default_rng", "Generator", "SeedSequence", "PCG64",
                   "Philox", "SFC64", "BitGenerator", "RandomState"}


@register_checker
class WallClockChecker(Checker):
    """DB001 — host-clock reads inside deterministic simulator code."""

    CODE = "DB001"
    HINT = ("simulated time is SimKernel.now; for real measurement "
            "harnesses add the module to the DB001 allowlist or suppress "
            "with '# repro: allow(DB001): <why>'")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            target = unit.resolve_call(node.func)
            if target in WALL_CLOCK_CALLS:
                out.append(self.finding(
                    unit, node,
                    f"wall-clock read `{target}()` in deterministic "
                    f"scope — replay will not be bit-identical"))
        return out


@register_checker
class UnseededRngChecker(Checker):
    """DB002 — draws from process-global RNG state."""

    CODE = "DB002"
    HINT = ("draw from a seeded generator: random.Random(seed) / "
            "np.random.default_rng(seed) threaded from the scenario "
            "seed")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            target = unit.resolve_call(node.func)
            if target is None:
                continue
            if target.startswith("numpy.random.") or \
                    target.startswith("np.random."):
                attr = target.rsplit(".", 1)[-1]
                if attr not in _NP_RANDOM_SAFE:
                    out.append(self.finding(
                        unit, node,
                        f"module-level numpy RNG `{target}()` — global "
                        f"state is shared across every run in the "
                        f"process"))
            elif target.startswith("random."):
                attr = target.split(".", 1)[1]
                if "." not in attr and attr not in _RANDOM_SAFE:
                    out.append(self.finding(
                        unit, node,
                        f"bare `random.{attr}()` — draws from the "
                        f"process-global generator, not a seeded "
                        f"stream"))
        return out


#: recorder emission surface (repro_torch.sim.trace.SpanRecorder) plus the
#: generic logging verbs instrumented code tends to grow.  DB008 looks
#: *inside* the arguments of these calls for a host-clock read.
TELEMETRY_METHODS = {"begin", "end", "instant", "complete", "observe",
                     "add", "log"}


@register_checker
class TelemetryClockChecker(Checker):
    """DB008 — telemetry emission timestamped from the host clock.

    The flight recorder stamps spans from the bound kernel clock so a
    trace replays bit-identically.  Passing ``time.time()`` (or any
    ``WALL_CLOCK_CALLS`` read) as a span/metric/log argument silently
    breaks that: the simulation still replays, the telemetry does not.
    Scope covers every package that emits into the recorder
    (``repro_torch.sim``, ``repro_torch.serverless``,
    ``repro_torch.continuum``).
    """

    CODE = "DB008"
    HINT = ("stamp telemetry from the simulation clock — kernel.now / "
            "clock.now — or omit t= and let the recorder read its bound "
            "kernel")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in TELEMETRY_METHODS):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                for inner in ast.walk(arg):
                    if not isinstance(inner, ast.Call):
                        continue
                    target = unit.resolve_call(inner.func)
                    if target in WALL_CLOCK_CALLS:
                        out.append(self.finding(
                            unit, inner,
                            f"telemetry call `.{node.func.attr}(...)` "
                            f"timestamped with host clock `{target}()` "
                            f"— the emitted trace will not replay"))
        return out


def _returns_set(node: ast.expr, set_vars: Set[str]) -> bool:
    """Is ``node`` a set-typed expression?  Literal sets, set/frozenset
    constructors and comprehensions, set-algebra method calls, and
    names locally assigned one of those."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in set_vars
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and \
                node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "intersection", "difference",
                "symmetric_difference"):
            # set-algebra producing another unordered set; only treat as
            # set-typed when the receiver already is one (dict.keys()
            # has no such methods, str methods named union don't exist)
            return _returns_set(node.func.value, set_vars)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _returns_set(node.left, set_vars) or \
            _returns_set(node.right, set_vars)
    return False


@register_checker
class UnorderedIterationChecker(Checker):
    """DB003 — iterating a set (insertion-order-free) in event-feeding
    code without ``sorted``.

    Dict iteration is insertion-ordered and therefore replay-stable;
    *set* iteration orders by hash, which for object elements includes
    the allocation address — two runs of the same seed can schedule in
    different orders.  Scope is the event-feeding packages
    (``repro_torch.sim``, ``repro_torch.serverless``) where that order
    reaches the heap.
    """

    CODE = "DB003"
    HINT = "iterate `sorted(<set>)` (or keep a list alongside the set)"

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        # one pass per scope (module body + every function), never
        # descending into nested scopes: set-typed inference is local,
        # so a set-typed `names` in one method cannot taint a list-typed
        # `names` in another
        scopes = [unit.tree] + [
            n for n in ast.walk(unit.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            nodes = list(self._walk_scope(scope))
            set_vars: Set[str] = set()
            for stmt in nodes:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and _returns_set(stmt.value, set_vars):
                    set_vars.add(stmt.targets[0].id)
            for node in nodes:
                iters = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    iters.extend(g.iter for g in node.generators)
                for it in iters:
                    if _returns_set(it, set_vars):
                        out.append(self.finding(
                            unit, it,
                            "iteration over a set — element order "
                            "hashes object addresses and is not "
                            "replay-stable"))
        return out

    @staticmethod
    def _walk_scope(scope):
        """Walk one scope's statements without entering nested function
        or class bodies (those are scopes of their own)."""
        stack = list(scope.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))


@register_checker
class SpawnOrderChecker(Checker):
    """DB009 — kernel child-process scheduling from unordered iteration.

    The DAG scheduler (``repro_torch.serverless.dag`` / ``engine._dag_run``)
    runs workflow branches as concurrent child kernel processes; the
    order of ``kernel.spawn``/``kernel.wake`` calls assigns heap
    sequence numbers, which break same-timestamp ties.  Spawning or
    waking from a set-typed iterable therefore makes branch scheduling
    — and the barrier join order behind it — vary between runs even
    under the same seed.  DB003 already flags set iteration broadly in
    ``repro_torch.sim``; this check pins the specific contract that child
    processes inside ``repro_torch.serverless*`` join deterministically.
    """

    CODE = "DB009"
    HINT = ("schedule branch children from a deterministically ordered "
            "sequence (topo-ordered list, dict, deque) — never from a "
            "set")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        scopes = [unit.tree] + [
            n for n in ast.walk(unit.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        walk = UnorderedIterationChecker._walk_scope
        for scope in scopes:
            nodes = list(walk(scope))
            set_vars: Set[str] = set()
            for stmt in nodes:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and _returns_set(stmt.value, set_vars):
                    set_vars.add(stmt.targets[0].id)
            for node in nodes:
                if not isinstance(node, ast.For) or \
                        not _returns_set(node.iter, set_vars):
                    continue
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Call) and \
                            isinstance(inner.func, ast.Attribute) and \
                            inner.func.attr in ("spawn", "wake"):
                        out.append(self.finding(
                            unit, inner,
                            f"kernel `.{inner.func.attr}(...)` inside "
                            f"iteration over a set — branch spawn "
                            f"order (heap sequence numbers) would "
                            f"differ between runs of the same seed"))
        return out
