"""Cache-coherence checkers: DB004 id()-keyed memos, DB006
version-guard discipline on memoizing classes.

Both target the same failure shape: a cache whose key can silently alias
a *different* value than the one it was built for.  ``id()`` reuses
addresses after GC (the ``core/propagation.py`` bug this repo shipped);
version-guarded memos go stale the moment a mutation path forgets the
bump.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.framework import (Checker, Finding, ModuleUnit,
                                      register_checker)

#: method calls that structurally mutate a dict/set attribute
_MUTATORS = {"pop", "popitem", "clear", "update", "setdefault", "add",
             "discard", "remove", "append", "extend", "insert"}


def _contains_name(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _enclosing_functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


@register_checker
class IdKeyedMemoChecker(Checker):
    """DB004 — ``id(x)`` used as (part of) a memo key with nothing
    pinning ``x`` alive or re-checking its identity.

    After ``x`` is garbage-collected its address can be handed to a new
    object, whose ``id()`` then *hits* the stale entry.  Two escapes are
    recognized per enclosing function:

    * a **paired strong reference** — some subscript store whose value
      expression contains ``x`` itself (``cache[id(x)] = (x, derived)``),
      keeping the id stable for the entry's lifetime;
    * an **identity guard** — an ``is`` comparison against ``x``
      (``if hit[0] is x:``) re-validating the hit before use.
    """

    CODE = "DB004"
    HINT = ("store the object in the entry (cache[id(x)] = (x, v)) and "
            "guard hits with `entry[0] is x`, or key on a stable token "
            "instead of id()")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for fn in _enclosing_functions(unit.tree):
            id_calls = [
                n for n in ast.walk(fn)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name) and n.func.id == "id"
                and len(n.args) == 1]
            if not id_calls:
                continue
            stores = [n for n in ast.walk(fn)
                      if isinstance(n, ast.Assign)
                      and any(isinstance(t, ast.Subscript)
                              for t in n.targets)]
            is_cmps = [n for n in ast.walk(fn)
                       if isinstance(n, ast.Compare)
                       and any(isinstance(op, (ast.Is, ast.IsNot))
                               for op in n.ops)]
            for call in id_calls:
                arg = call.args[0]
                if not isinstance(arg, ast.Name):
                    # id(self.attr) etc.: compare by source dump
                    dump = ast.dump(arg)
                    paired = any(dump in ast.dump(s.value)
                                 for s in stores)
                    guarded = any(dump in ast.dump(c) for c in is_cmps)
                else:
                    name = arg.id
                    paired = any(_contains_name(s.value, name)
                                 for s in stores)
                    guarded = any(_contains_name(c, name)
                                  for c in is_cmps)
                if not (paired or guarded):
                    out.append(self.finding(
                        unit, call,
                        "id()-keyed memo: after GC the id can alias a "
                        "different object and serve a stale entry"))
        return out


def _attr_chain(node: ast.expr) -> Optional[str]:
    """'self.nodes' -> 'nodes' when the receiver is self, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


@register_checker
class VersionGuardChecker(Checker):
    """DB006 — version-guard discipline on configured memoizing classes.

    For every class in ``AnalysisConfig.versioned_classes``, each method
    that structurally mutates a guarded attribute (subscript store,
    ``del``, or a mutator-method call on it) must also bump the version
    counter or call an invalidate method; and each method that *reads* a
    memo attribute (``.get(...)`` or a subscript load) must reference the
    version counter somewhere — a memo hit served without the version
    check is exactly the stale-cache bug the counter exists to prevent.
    """

    CODE = "DB006"
    HINT = ("bump self.<version> (or call the invalidator) in the same "
            "method, and compare memo hits against the current version")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        specs = {v.name: v for v in self.config.versioned_classes}
        out: List[Finding] = []
        for cls in ast.walk(unit.tree):
            if not isinstance(cls, ast.ClassDef) or cls.name not in specs:
                continue
            spec = specs[cls.name]
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name in spec.exempt_methods:
                    continue
                self._check_method(unit, spec, meth, out)
        return out

    def _check_method(self, unit: ModuleUnit, spec, meth,
                      out: List[Finding]) -> None:
        mutates = []     # nodes mutating a guarded attr
        reads_memo = []  # nodes reading a memo attr
        bumps = False
        for node in ast.walk(meth):
            # version bump: any store/augstore touching version_attr,
            # or a call to an invalidate method
            if spec.version_attr and isinstance(
                    node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if any(_attr_chain(t) == spec.version_attr
                       for t in targets):
                    bumps = True
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in spec.invalidate_methods and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                bumps = True
            # guarded-attr mutation
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            _attr_chain(t.value) in spec.guarded_attrs:
                        mutates.append(t)
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            _attr_chain(t.value) in spec.guarded_attrs:
                        mutates.append(t)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS and \
                    _attr_chain(node.func.value) in spec.guarded_attrs:
                mutates.append(node)
            # memo read
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and \
                    _attr_chain(node.func.value) in spec.memo_attrs:
                reads_memo.append(node)
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    _attr_chain(node.value) in spec.memo_attrs:
                reads_memo.append(node)
        if mutates and not bumps:
            out.append(self.finding(
                unit, mutates[0],
                f"{spec.name}.{meth.name} mutates "
                f"{'/'.join(spec.guarded_attrs)} without bumping "
                f"{spec.version_attr or spec.invalidate_methods} — "
                f"stale memos survive the mutation"))
        if reads_memo and spec.version_attr:
            checks_version = any(
                _attr_chain(n) == spec.version_attr
                for n in ast.walk(meth)
                if isinstance(n, ast.Attribute)
                and isinstance(n.ctx, ast.Load))
            if not checks_version:
                out.append(self.finding(
                    unit, reads_memo[0],
                    f"{spec.name}.{meth.name} reads a memo without "
                    f"consulting {spec.version_attr} — a stale hit is "
                    f"served after any mutation"))
