"""Kernel-process protocol checkers: DB005 effect discipline, DB007
slot acquire/release pairing.

A kernel process is a generator the ``SimKernel`` drives: it may yield a
non-negative delay or one of the known effect tuples
(``("acquire", res)`` / ``("release", res)``).  Anything else either
raises at runtime deep inside a run (unknown op) or silently breaks
determinism (a blocking builtin consumes *wall* time and OS state the
replay cannot reproduce).
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.framework import (Checker, Finding, ModuleUnit,
                                      register_checker)


def _walk_shallow(fn):
    """Walk a function body without descending into nested function or
    class definitions (their yields belong to *their* protocol)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_generator(fn) -> bool:
    return any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in _walk_shallow(fn))


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


@register_checker
class KernelProtocolChecker(Checker):
    """DB005 — process generators yielding unknown effect ops or calling
    blocking builtins mid-process."""

    CODE = "DB005"
    HINT = ("a kernel process may yield a delay or "
            "('acquire'|'release', resource); blocking work must become "
            "simulated time (yield the duration) or a deferred "
            "kernel.call_at")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        blocking = set(self.config.blocking_calls)
        known = set(self.config.known_ops)
        for fn in _functions(unit.tree):
            if not _is_generator(fn):
                continue
            for node in _walk_shallow(fn):
                if isinstance(node, ast.Yield) and \
                        isinstance(node.value, ast.Tuple) and \
                        node.value.elts and \
                        isinstance(node.value.elts[0], ast.Constant) and \
                        isinstance(node.value.elts[0].value, str) and \
                        node.value.elts[0].value not in known:
                    op = node.value.elts[0].value
                    out.append(self.finding(
                        unit, node,
                        f"process yields unknown effect op {op!r} — the "
                        f"kernel only understands "
                        f"{sorted(known)}"))
                if isinstance(node, ast.Call):
                    target = unit.resolve_call(node.func)
                    if target in blocking:
                        out.append(self.finding(
                            unit, node,
                            f"blocking builtin `{target}()` inside a "
                            f"kernel process — wall time and OS state "
                            f"leak into the replayed event order"))
        return out


@register_checker
class SlotLeakChecker(Checker):
    """DB007 — ``("acquire", res)`` with no matching ``("release", res)``
    in the same generator: the slot leaks and every later instance on
    that node parks forever."""

    CODE = "DB007"
    HINT = ("pair every yield ('acquire', r) with yield ('release', r) "
            "on all paths (a try/finally around the held span keeps the "
            "pairing obvious)")

    def check(self, unit: ModuleUnit) -> List[Finding]:
        out: List[Finding] = []
        for fn in _functions(unit.tree):
            acquires: List = []
            releases: Dict[str, int] = {}
            for node in _walk_shallow(fn):
                if not (isinstance(node, ast.Yield)
                        and isinstance(node.value, ast.Tuple)
                        and len(node.value.elts) == 2
                        and isinstance(node.value.elts[0], ast.Constant)):
                    continue
                op = node.value.elts[0].value
                res = ast.dump(node.value.elts[1])
                if op == "acquire":
                    acquires.append((node, res))
                elif op == "release":
                    releases[res] = releases.get(res, 0) + 1
            for node, res in acquires:
                if releases.get(res, 0) > 0:
                    releases[res] -= 1
                else:
                    out.append(self.finding(
                        unit, node,
                        "acquire without a matching release in this "
                        "process — the slot leaks on every path"))
        return out
