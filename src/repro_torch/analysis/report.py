"""Finding presentation + exit-code policy for databelt-lint."""
from __future__ import annotations

import json
from collections import Counter
from typing import List

from repro_torch.analysis.config import CHECK_CATALOG
from repro_torch.analysis.framework import Finding


def active(findings: List[Finding]) -> List[Finding]:
    """Findings that gate a merge: neither suppressed nor allowlisted."""
    return [f for f in findings if not f.suppressed and not f.allowlisted]


def render(findings: List[Finding], show_suppressed: bool = False) -> str:
    lines: List[str] = []
    shown = findings if show_suppressed else active(findings)
    for f in shown:
        lines.append(f.format())
    counts = Counter(f.code for f in active(findings))
    muted = len(findings) - len(active(findings))
    if counts:
        per = ", ".join(f"{c}x{n}" for c, n in sorted(counts.items()))
        lines.append(f"\ndatabelt-lint: {sum(counts.values())} "
                     f"finding(s) [{per}]"
                     + (f", {muted} suppressed/allowlisted" if muted
                        else ""))
    else:
        lines.append(f"databelt-lint: clean"
                     + (f" ({muted} suppressed/allowlisted)" if muted
                        else ""))
    return "\n".join(lines)


def render_catalog() -> str:
    return "\n".join(f"{code}  {desc}"
                     for code, desc in sorted(CHECK_CATALOG.items()))


def render_sarif(findings: List[Finding]) -> str:
    """SARIF 2.1.0 document for the *active* findings — the format CI
    uploads so findings annotate PRs inline.  Suppressed/allowlisted
    findings are carried with ``suppressions`` entries (SARIF's own
    mechanism), so viewers can show them muted instead of losing them."""
    rules = [{
        "id": code,
        "shortDescription": {"text": desc},
    } for code, desc in sorted(CHECK_CATALOG.items())]
    results = []
    for f in findings:
        result = {
            "ruleId": f.code,
            "level": "error",
            "message": {"text": f.message + (f"\nfix: {f.hint}"
                                             if f.hint else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": f.col + 1},
                },
            }],
        }
        if f.suppressed or f.allowlisted:
            result["suppressions"] = [{
                "kind": "inSource" if f.suppressed else "external",
            }]
        results.append(result)
    doc = {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "databelt-lint",
                "informationUri":
                    "https://github.com/databelt/databelt-repro",
                "rules": rules,
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def exit_code(findings: List[Finding]) -> int:
    return 1 if active(findings) else 0
