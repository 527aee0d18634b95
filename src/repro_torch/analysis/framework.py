"""databelt-lint checker framework: typed findings, suppression pragmas,
module walking.

A *checker* is a class with a ``CODE`` (``DB0xx``), a ``HINT`` (the fix
suggestion printed with every finding) and a ``check(module) -> findings``
method over a parsed ``ModuleUnit``.  Checkers register themselves with
``@register_checker`` and the runner instantiates every registered
checker whose scope (``AnalysisConfig.scopes``) covers the module under
analysis.

Suppression is explicit and line-scoped::

    t0 = time.perf_counter()   # repro: allow(DB001): real-compute timing

A pragma suppresses the named codes on its own line, or — when the
comment stands alone — on the next code line.  ``--strict`` additionally
requires every pragma to carry a reason after the colon: a suppression
without a *why* is itself a finding (DB000).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple, Type

# The token stays ``repro:``, as in the reference: the port's copied
# simulator modules carry it, and both analyzers honour the same pragmas.
PRAGMA_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*(?P<codes>DB\d{3}(?:\s*,\s*DB\d{3})*)\s*\)"
    r"(?::\s*(?P<reason>.*))?")


@dataclass
class Finding:
    """One typed analyzer finding."""
    code: str
    message: str
    path: str
    line: int
    col: int = 0
    hint: str = ""
    suppressed: bool = False
    allowlisted: bool = False

    def format(self) -> str:
        tag = ""
        if self.suppressed:
            tag = " [suppressed]"
        elif self.allowlisted:
            tag = " [allowlisted]"
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: {self.code} {self.message}{tag}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out


@dataclass
class Pragma:
    line: int           # line the pragma suppresses
    codes: Tuple[str, ...]
    reason: str
    pragma_line: int    # line the comment physically sits on
    used: bool = False


@dataclass
class ModuleUnit:
    """One parsed source file plus everything checkers need."""
    path: str
    module: Optional[str]       # dotted name, None outside repro_torch
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    pragmas: Dict[int, List[Pragma]] = field(default_factory=dict)
    #: import alias map: local name -> dotted module it refers to
    #: (``import time as _time`` -> {"_time": "time"}); from-imports map
    #: the bound name to "module.attr".
    imports: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, module: Optional[str],
              source: str) -> "ModuleUnit":
        tree = ast.parse(source, filename=path)
        unit = cls(path=path, module=module, source=source, tree=tree,
                   lines=source.splitlines())
        unit._collect_pragmas()
        unit._collect_imports()
        return unit

    # -- pragmas ---------------------------------------------------------
    def _collect_pragmas(self) -> None:
        for i, text in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            codes = tuple(c.strip() for c in m.group("codes").split(","))
            reason = (m.group("reason") or "").strip()
            # a comment-only line suppresses the next code line
            target = i
            if text.lstrip().startswith("#"):
                j = i + 1
                while j <= len(self.lines) and (
                        not self.lines[j - 1].strip()
                        or self.lines[j - 1].lstrip().startswith("#")):
                    j += 1
                target = j
            p = Pragma(line=target, codes=codes, reason=reason,
                       pragma_line=i)
            self.pragmas.setdefault(target, []).append(p)

    def suppression_for(self, code: str, line: int) -> Optional[Pragma]:
        for p in self.pragmas.get(line, ()):
            if code in p.codes:
                return p
        return None

    # -- imports ---------------------------------------------------------
    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve_call(self, func: ast.expr) -> Optional[str]:
        """Dotted name a call target resolves to through the module's
        import aliases: ``_time.perf_counter`` -> ``time.perf_counter``,
        a bare ``sleep`` imported from time -> ``time.sleep``.  None for
        anything unresolvable (method calls on objects, locals)."""
        parts: List[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.imports.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# checker registry
# ---------------------------------------------------------------------------
class Checker:
    CODE: str = "DB000"
    HINT: str = ""

    def __init__(self, config):
        self.config = config

    def check(self, unit: ModuleUnit) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, unit: ModuleUnit, node: ast.AST,
                message: str, hint: Optional[str] = None) -> Finding:
        return Finding(code=self.CODE, message=message, path=unit.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       hint=self.HINT if hint is None else hint)


CHECKERS: Dict[str, Type[Checker]] = {}


def register_checker(cls: Type[Checker]) -> Type[Checker]:
    CHECKERS[cls.CODE] = cls
    return cls


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------
def module_name_of(path: Path) -> Optional[str]:
    """Dotted module name for files under the ``repro_torch`` package — or
    the repo's ``benchmarks``/``tests`` trees, so scope globs and the
    allowlist can tune the battery for harness code.  None for anything
    else (fixture files get the full battery)."""
    parts = list(path.with_suffix("").parts)
    # differs from repro/analysis/framework.py:184: the port's package root
    for root in ("repro_torch", "benchmarks", "tests"):
        if root in parts:
            i = len(parts) - 1 - parts[::-1].index(root)
            mod = parts[i:]
            if mod[-1] == "__init__":
                mod = mod[:-1]
            return ".".join(mod)
    return None


def iter_py_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            out.extend(sorted(pth.rglob("*.py")))
        elif pth.suffix == ".py":
            out.append(pth)
    return out


def analyze_source(source: str, path: str = "<memory>",
                   module: Optional[str] = None,
                   config=None) -> List[Finding]:
    """Run every applicable checker over one source blob (the test
    fixture entry point).  Suppression pragmas and the allowlist are
    applied; suppressed/allowlisted findings are returned flagged, not
    dropped — callers filter on ``.suppressed`` / ``.allowlisted``."""
    from repro_torch.analysis.config import default_config
    config = config or default_config()
    unit = ModuleUnit.parse(path, module, source)
    findings: List[Finding] = []
    for code, cls in sorted(CHECKERS.items()):
        if not config.applies(code, module):
            continue
        allowed = config.allowlisted(code, module)
        for f in cls(config).check(unit):
            pragma = unit.suppression_for(f.code, f.line)
            if pragma is not None:
                pragma.used = True
                f.suppressed = True
            f.allowlisted = allowed
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def run_analysis(paths: Iterable[str], config=None,
                 require_reasons: bool = False) -> List[Finding]:
    """Analyze every ``.py`` file under ``paths``.  With
    ``require_reasons`` (the ``--strict`` contract) every *used*
    suppression pragma must carry a reason after the colon; bare
    pragmas are reported as DB000 findings."""
    from repro_torch.analysis.config import default_config
    config = config or default_config()
    all_findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            source = path.read_text()
            unit = ModuleUnit.parse(str(path), module_name_of(path),
                                    source)
        except (SyntaxError, UnicodeDecodeError) as e:
            all_findings.append(Finding(
                code="DB000", message=f"unparseable: {e}",
                path=str(path), line=getattr(e, "lineno", 0) or 0))
            continue
        module = unit.module
        for code, cls in sorted(CHECKERS.items()):
            if not config.applies(code, module):
                continue
            allowed = config.allowlisted(code, module)
            for f in cls(config).check(unit):
                pragma = unit.suppression_for(f.code, f.line)
                if pragma is not None:
                    pragma.used = True
                    f.suppressed = True
                f.allowlisted = allowed
                all_findings.append(f)
        if require_reasons:
            for plist in unit.pragmas.values():
                for p in plist:
                    if p.used and not p.reason:
                        all_findings.append(Finding(
                            code="DB000",
                            message=f"suppression allow"
                                    f"({','.join(p.codes)}) has no "
                                    f"reason — document why",
                            path=str(path), line=p.pragma_line,
                            hint="write '# repro: allow(DBxxx): "
                                 "<why this is safe>'"))
    all_findings.sort(key=lambda f: (f.path, f.line, f.code))
    return all_findings
