"""Race-shape checkers (DB010–DB013) + the runtime race-check glue.

databelt-lint's determinism battery (DB001–DB009) guards *replay*
determinism; these four checks guard *cross-process ordering* — the
interleavings PR 9's concurrent DAG branches and the control daemons
(autoscaler, fault injector, the planned orbital re-epoching daemon)
introduce.  They are AST heuristics over one module at a time: an
interprocedural pass first identifies process-generator functions
(anything handed to ``kernel.spawn``/``wake``), then builds
per-generator attribute read/write sets and flags conflicting pairs no
``("acquire"/"release")`` discipline or version bump mediates.

* **DB010** — an object reachable from two or more spawned kernel
  processes (two distinct spawn call sites passing the same actual
  argument expression) has an attribute *written* in one generator and
  read/written in another, with no common acquired resource and no
  version bump on the writing side.
* **DB011** — read-modify-write of shared state spanning a ``yield``:
  an attribute read before an interleaving point and written back after
  it while no resource is held — the classic lost update.
* **DB012** — a *daemon* process mutating a version-guarded class
  (guarded attribute stores, or known topology mutators like
  ``set_node_down``) while the module also spawns non-daemon processes
  that may hold memo-derived references — DB006's rule extended across
  processes.
* **DB013** — one mutable container (list/dict/set display or
  constructor) passed into multiple ``kernel.spawn()`` call sites
  without a copy at the site.

The runtime half lives in ``repro_torch.sim.races`` (the happens-before
sanitizer ``SimKernel(race_detect=True)`` attaches); this module's
``verify_scenario_races`` drives it over a full scenario and wraps the
findings — the ``Scenario.verify_races()`` / ``--race-smoke`` entry
points.

Heuristic limits (documented, deliberate): aliasing is recognized
through spawn-site actual arguments (not closures), resource mediation
through each generator's own ``acquire`` yields translated to the
spawn-site actuals, and daemon mutation scanning is shallow (mutations
the daemon makes *directly*, not through helper calls).  The runtime
sanitizer is the backstop for everything the static shapes miss.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (Checker, Finding, ModuleUnit,
                                      register_checker)
from repro_torch.analysis.protocol import (_functions, _is_generator,
                                     _walk_shallow)

#: mutating methods on version-guarded classes that DB012 treats as
#: guarded-state writes even without a direct attribute store
GUARDED_MUTATOR_METHODS = ("set_node_down", "set_link_down")

#: container-mutating method names: calling one of these on a guarded
#: attribute is a structural mutation of it
_CONTAINER_MUTATORS = ("add", "discard", "remove", "clear", "update",
                      "pop", "append", "extend")

#: constructors whose result is a shared-mutable container (DB013)
_MUTABLE_CTORS = ("list", "dict", "set", "bytearray", "deque",
                  "defaultdict", "Counter", "OrderedDict")

#: call targets that produce a fresh copy at a spawn site (DB013 clean)
_COPY_CALLS = ("list", "dict", "set", "tuple", "frozenset", "sorted",
               "copy.copy", "copy.deepcopy")


# ---------------------------------------------------------------------------
# shared AST plumbing
# ---------------------------------------------------------------------------
@dataclass
class SpawnSite:
    """One ``kernel.spawn(gen_fn(args...), ...)`` call."""
    call: ast.Call                  # the spawn(...) call itself
    gen_name: Optional[str]         # generator function name (if a call)
    actuals: List[ast.expr]         # positional args of the inner call
    daemon: bool
    raw_args: List[ast.expr]        # spawn's own positional args


def _is_spawn_call(node: ast.AST) -> Optional[str]:
    """``"spawn"``/``"wake"`` when ``node`` is a kernel scheduling call
    (method named spawn/wake on any receiver), else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("spawn", "wake"):
        return node.func.attr
    return None


def _spawn_sites(scope_nodes) -> List[SpawnSite]:
    sites: List[SpawnSite] = []
    for node in scope_nodes:
        if _is_spawn_call(node) != "spawn" or not node.args:
            continue
        first = node.args[0]
        gen_name: Optional[str] = None
        actuals: List[ast.expr] = []
        if isinstance(first, ast.Call):
            if isinstance(first.func, ast.Name):
                gen_name = first.func.id
            elif isinstance(first.func, ast.Attribute):
                gen_name = first.func.attr
            actuals = list(first.args)
        daemon = any(kw.arg == "daemon"
                     and isinstance(kw.value, ast.Constant)
                     and kw.value.value is True
                     for kw in node.keywords)
        sites.append(SpawnSite(call=node, gen_name=gen_name,
                               actuals=actuals, daemon=daemon,
                               raw_args=list(node.args)))
    return sites


def _module_shallow(tree: ast.Module):
    """Module-level statements without descending into function/class
    bodies (their spawn sites belong to *their* scope)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _formals(fn) -> List[str]:
    return [a.arg for a in fn.args.args]


def _base_name(expr: ast.expr) -> Optional[str]:
    """The root ``Name`` id of an attribute chain (``p.a.b`` -> ``p``)."""
    node = expr
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@dataclass
class GenProfile:
    """Per-generator access summary keyed by formal-parameter name."""
    fn: object
    formals: List[str]
    # formal -> attrs read / written on it (one attribute deep)
    reads: Dict[str, Set[str]]
    writes: Dict[str, Dict[str, ast.AST]]   # attr -> the write node
    # resource expressions this generator acquires, as
    # ("formal", name) for a bare formal or ("expr", ast.dump) otherwise
    acquires: Set[Tuple[str, str]]
    # formals whose version the generator bumps (DB006-style mediation):
    # a ``<formal>._version``-ish store or an invalidate-method call
    version_bumped: Set[str]


def _yield_op(node: ast.AST) -> Optional[str]:
    """``"acquire"``/``"release"`` for a protocol-tuple yield, ``"plain"``
    for any other yield, None for non-yields."""
    if not isinstance(node, (ast.Yield, ast.YieldFrom)):
        return None
    if isinstance(node, ast.Yield) and isinstance(node.value, ast.Tuple) \
            and node.value.elts \
            and isinstance(node.value.elts[0], ast.Constant) \
            and node.value.elts[0].value in ("acquire", "release"):
        return node.value.elts[0].value
    return "plain"


def _profile_generator(fn, config) -> GenProfile:
    formals = _formals(fn)
    fset = set(formals)
    reads: Dict[str, Set[str]] = {}
    writes: Dict[str, Dict[str, ast.AST]] = {}
    acquires: Set[Tuple[str, str]] = set()
    bumped: Set[str] = set()
    version_attrs = {"_version"} | {
        vc.version_attr for vc in config.versioned_classes
        if vc.version_attr}
    invalidators = {m for vc in config.versioned_classes
                    for m in vc.invalidate_methods}
    for node in _walk_shallow(fn):
        op = _yield_op(node)
        if op in ("acquire", "release"):
            res = node.value.elts[1]
            if isinstance(res, ast.Name) and res.id in fset:
                acquires.add(("formal", res.id))
            else:
                acquires.add(("expr", ast.dump(res)))
            continue
        if isinstance(node, ast.Attribute):
            base = _base_name(node.value) if isinstance(node.value,
                                                        ast.Attribute) \
                else (node.value.id if isinstance(node.value, ast.Name)
                      else None)
            if base not in fset:
                continue
            if isinstance(node.ctx, ast.Store):
                if node.attr in version_attrs:
                    bumped.add(base)
                else:
                    writes.setdefault(base, {}).setdefault(node.attr, node)
            elif isinstance(node.ctx, ast.Load):
                reads.setdefault(base, set()).add(node.attr)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in invalidators \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in fset:
            bumped.add(node.func.value.id)
    return GenProfile(fn=fn, formals=formals, reads=reads, writes=writes,
                      acquires=acquires, version_bumped=bumped)


def _translate_acquires(profile: GenProfile, site: SpawnSite) -> Set[str]:
    """The generator's acquired-resource identities in *spawn-site*
    terms: a bare formal maps to the dump of the actual passed for it,
    so two generators locking the same passed-in resource compare equal
    regardless of parameter naming."""
    out: Set[str] = set()
    pos = {name: i for i, name in enumerate(profile.formals)}
    for kind, val in profile.acquires:
        if kind == "formal" and val in pos and pos[val] < len(site.actuals):
            out.add(ast.dump(site.actuals[pos[val]]))
        else:
            out.add(val)
    return out


# ---------------------------------------------------------------------------
# DB010 — unmediated shared-attribute conflict across spawned processes
# ---------------------------------------------------------------------------
@register_checker
class SharedWriteChecker(Checker):
    """DB010 — an attribute of an object passed to two (or more) spawned
    kernel processes is written in one generator and read/written in
    another, with no common acquired resource and no version bump."""

    CODE = "DB010"
    HINT = ("serialize the conflicting accesses under one resource "
            "(yield ('acquire', lock) ... yield ('release', lock)) or "
            "give each process its own copy of the state")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        fn_by_name = {f.name: f for f in _functions(unit.tree)}
        profiles: Dict[str, GenProfile] = {}

        def profile(name: Optional[str]) -> Optional[GenProfile]:
            if name is None or name not in fn_by_name:
                return None
            if name not in profiles:
                fn = fn_by_name[name]
                if not _is_generator(fn):
                    return None
                profiles[name] = _profile_generator(fn, self.config)
            return profiles.get(name)

        out: List[Finding] = []
        seen: Set[Tuple[int, int, str]] = set()
        for scope in self._scopes(unit):
            sites = _spawn_sites(scope)
            for i in range(len(sites)):
                for j in range(i + 1, len(sites)):
                    self._check_pair(unit, sites[i], sites[j], profile,
                                     out, seen)
        return out

    @staticmethod
    def _scopes(unit: ModuleUnit):
        """Spawn sites are paired within one function (or the module
        body) — cross-function pairs would mostly be different runs."""
        for fn in _functions(unit.tree):
            yield list(_walk_shallow(fn))
        yield list(_module_shallow(unit.tree))

    def _check_pair(self, unit, sa: SpawnSite, sb: SpawnSite, profile,
                    out: List[Finding], seen: Set[Tuple[int, str]]):
        pa, pb = profile(sa.gen_name), profile(sb.gen_name)
        if pa is None or pb is None:
            return
        # shared actuals: same expression passed to both spawn sites
        pairs = []
        for i, ea in enumerate(sa.actuals):
            if not isinstance(ea, (ast.Name, ast.Attribute)):
                continue
            da = ast.dump(ea)
            for j, eb in enumerate(sb.actuals):
                if isinstance(eb, (ast.Name, ast.Attribute)) \
                        and ast.dump(eb) == da:
                    pairs.append((i, j))
        if not pairs:
            return
        # mediation: both generators acquire the same resource identity
        if _translate_acquires(pa, sa) & _translate_acquires(pb, sb):
            return
        for i, j in pairs:
            if i >= len(pa.formals) or j >= len(pb.formals):
                continue
            fa, fb = pa.formals[i], pb.formals[j]
            self._conflicts(unit, pa, fa, sa, pb, fb, sb, out, seen)
            self._conflicts(unit, pb, fb, sb, pa, fa, sa, out, seen)

    def _conflicts(self, unit, pw: GenProfile, fw: str, sw: SpawnSite,
                   pr: GenProfile, fr: str, sr: SpawnSite,
                   out: List[Finding], seen: Set[Tuple[int, int, str]]):
        """Writes in ``pw`` on formal ``fw`` vs reads/writes in ``pr``
        on the aliased formal ``fr``."""
        if fw in pw.version_bumped:
            return
        for attr, node in pw.writes.get(fw, {}).items():
            other = attr in pr.reads.get(fr, set()) \
                or attr in pr.writes.get(fr, {})
            if not other:
                continue
            key = (node.lineno, node.col_offset, attr)
            if key in seen:
                continue
            seen.add(key)
            wname = pw.fn.name
            rname = pr.fn.name
            out.append(self.finding(
                unit, node,
                f"`.{attr}` of an object shared between spawned "
                f"processes `{wname}` and `{rname}` is written here "
                f"and accessed in `{rname}` with no mediating "
                f"acquire/release pair or version bump — the outcome "
                f"depends on event-heap tie-breaking"))


# ---------------------------------------------------------------------------
# DB011 — read-modify-write spanning a yield (lost update)
# ---------------------------------------------------------------------------
@register_checker
class LostUpdateChecker(Checker):
    """DB011 — a value read from shared state before an interleaving
    point (a plain ``yield`` while holding no resource) and written back
    after it: another process can interleave at the yield and its update
    is lost."""

    CODE = "DB011"
    HINT = ("hold a resource across the read-modify-write (yield "
            "('acquire', lock) before the read, release after the "
            "write-back) or re-read the value after the yield")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        spawned = {s.gen_name
                   for fn in _functions(unit.tree)
                   for s in _spawn_sites(_walk_shallow(fn))}
        spawned |= {s.gen_name for s in _spawn_sites(ast.walk(unit.tree))}
        out: List[Finding] = []
        for fn in _functions(unit.tree):
            if not _is_generator(fn):
                continue
            # kernel processes only: spawned in this module, or clearly
            # speaking the protocol (acquire/release yields)
            ops = [(_yield_op(n), n) for n in _walk_shallow(fn)]
            protocol = any(o in ("acquire", "release") for o, _ in ops)
            if fn.name not in spawned and not protocol:
                continue
            out.extend(self._check_fn(unit, fn))
        return out

    def _check_fn(self, unit: ModuleUnit, fn) -> List[Finding]:
        # linear statement walk in source order: track (approximate)
        # held-resource depth, attribute reads, and unprotected yields
        events = []
        for node in _walk_shallow(fn):
            op = _yield_op(node)
            if op is not None:
                events.append((node.lineno, "yield:" + op, None, node))
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.value, (ast.Name, ast.Attribute)):
                base = _base_name(node)
                if base is None:
                    continue
                mode = "w" if isinstance(node.ctx, ast.Store) else \
                    ("r" if isinstance(node.ctx, ast.Load) else None)
                if mode:
                    events.append((node.lineno, mode,
                                   (ast.dump(node.value), node.attr),
                                   node))
        events.sort(key=lambda e: e[0])
        out: List[Finding] = []
        depth = 0
        # cell -> line of last read; bare-yield lines at depth 0
        last_read: Dict[Tuple[str, str], int] = {}
        open_yields: List[int] = []
        flagged: Set[Tuple[str, str]] = set()
        for lineno, kind, cell, node in events:
            if kind == "yield:acquire":
                depth += 1
            elif kind == "yield:release":
                depth = max(0, depth - 1)
            elif kind == "yield:plain":
                if depth == 0:
                    open_yields.append(lineno)
            elif kind == "r":
                last_read[cell] = lineno
            elif kind == "w":
                read_at = last_read.get(cell)
                if read_at is not None and cell not in flagged and any(
                        read_at < y < lineno for y in open_yields):
                    flagged.add(cell)
                    out.append(self.finding(
                        unit, node,
                        f"`.{cell[1]}` read before a yield and written "
                        f"back after it with no resource held — a "
                        f"concurrent update at the interleaving point "
                        f"is silently lost"))
        return out


# ---------------------------------------------------------------------------
# DB012 — daemon mutating version-guarded state under live readers
# ---------------------------------------------------------------------------
@register_checker
class DaemonMutationChecker(Checker):
    """DB012 — a daemon process directly mutates a version-guarded class
    (guarded attribute stores / container mutations, or known topology
    mutators) while the module also spawns non-daemon processes that may
    hold memo-derived references across the mutation."""

    CODE = "DB012"
    HINT = ("route the mutation through an ordering edge the readers "
            "see — apply it from a non-daemon process, or wake affected "
            "readers after the mutation (spawn/wake edges order "
            "accesses) — and keep the version bump (DB006)")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        guarded = {a for vc in self.config.versioned_classes
                   for a in vc.guarded_attrs}
        fn_by_name = {f.name: f for f in _functions(unit.tree)}
        all_sites = list(_spawn_sites(ast.walk(unit.tree)))
        has_regular = any(not s.daemon for s in all_sites)
        if not has_regular:
            return []
        out: List[Finding] = []
        for site in all_sites:
            if not site.daemon or site.gen_name not in fn_by_name:
                continue
            fn = fn_by_name[site.gen_name]
            if not _is_generator(fn):
                continue
            for node in _walk_shallow(fn):
                msg = self._mutation(node, guarded)
                if msg:
                    out.append(self.finding(
                        unit, node,
                        f"daemon process `{fn.name}` {msg} while "
                        f"non-daemon processes may hold memo-derived "
                        f"references — readers observe the flip at an "
                        f"order decided by tie-breaking"))
        return out

    @staticmethod
    def _mutation(node: ast.AST, guarded: Set[str]) -> Optional[str]:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr in guarded:
                    return f"writes guarded attribute `.{t.attr}`"
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in GUARDED_MUTATOR_METHODS:
                return f"calls topology mutator `{node.func.attr}()`"
            if node.func.attr in _CONTAINER_MUTATORS \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr in guarded:
                return (f"mutates guarded container "
                        f"`.{node.func.value.attr}` via "
                        f"`.{node.func.attr}()`")
        return None


# ---------------------------------------------------------------------------
# DB013 — one mutable container spawned into several processes
# ---------------------------------------------------------------------------
@register_checker
class SharedContainerChecker(Checker):
    """DB013 — a name bound to a mutable container is passed into two or
    more distinct ``kernel.spawn()`` call sites without a copy: every
    process mutates the same object."""

    CODE = "DB013"
    HINT = ("copy at the spawn site (list(x) / dict(x) / x.copy()) so "
            "each process owns its state, or make the sharing explicit "
            "and serialize access (DB010)")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for fn in _functions(unit.tree):
            out.extend(self._check_scope(
                unit, list(_walk_shallow(fn))))
        out.extend(self._check_scope(
            unit, list(_module_shallow(unit.tree))))
        return out

    def _check_scope(self, unit: ModuleUnit, nodes) -> List[Finding]:
        mutable: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if self._is_mutable_expr(node.value, unit):
                    mutable.add(node.targets[0].id)
        if not mutable:
            return []
        sites = _spawn_sites(nodes)
        passed: Dict[str, List[Tuple[SpawnSite, ast.expr]]] = {}
        for site in sites:
            for arg in site.actuals:
                if isinstance(arg, ast.Name) and arg.id in mutable:
                    passed.setdefault(arg.id, []).append((site, arg))
        out: List[Finding] = []
        for name, uses in passed.items():
            distinct = {(site.call.lineno, site.call.col_offset)
                        for site, _ in uses}
            if len(distinct) < 2:
                continue
            site, arg = uses[1]
            out.append(self.finding(
                unit, arg,
                f"mutable container `{name}` is passed into "
                f"{len(distinct)} spawn sites without a copy — every "
                f"process mutates the same object"))
        return out

    @staticmethod
    def _is_mutable_expr(expr: ast.expr, unit: ModuleUnit) -> bool:
        if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call):
            target = unit.resolve_call(expr.func)
            if target is not None and \
                    target.split(".")[-1] in _MUTABLE_CTORS:
                # a constructor *copying* another value is still a fresh
                # object per assignment — but one assignment shared into
                # two spawns is still one object, so it counts
                return True
        return False


# ---------------------------------------------------------------------------
# runtime glue: Scenario.verify_races() / --race-smoke
# ---------------------------------------------------------------------------
@dataclass
class RaceCheck:
    """Result of one race-detected scenario run."""
    scenario: object
    races: List[object]             # repro_torch.sim.races.RaceReport list
    events_processed: int = 0

    @property
    def ok(self) -> bool:
        return not self.races

    def describe(self) -> str:
        if self.ok:
            return (f"race-clean: no unordered conflicting accesses in "
                    f"{self.events_processed} events")
        lines = [f"{len(self.races)} race(s) detected over "
                 f"{self.events_processed} events:"]
        lines.extend(r.describe() for r in self.races)
        return "\n".join(lines)


# differs from repro/analysis/races.py:570: the device of real compute
def verify_scenario_races(scenario, *, device="cuda") -> RaceCheck:
    """Run ``scenario`` once with the happens-before sanitizer attached
    and wrap the findings.  Detection is passive, so the run's metrics
    are bit-identical to a detection-off run of the same spec.
    ``device`` goes to ``Scenario.run``: it binds the flood bodies of a
    ``real_compute`` spec; a virtual spec touches no device."""
    traced = scenario.replace(race_detect=True)
    # differs from repro/analysis/races.py:575: run(device=)
    rep = traced.run(device=device).rep
    return RaceCheck(scenario=traced, races=list(rep.races or ()),
                     events_processed=rep.events_processed)
