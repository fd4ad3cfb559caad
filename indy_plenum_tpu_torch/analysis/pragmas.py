"""Pragma & baseline suppression layer.

Grammar (one comment, anywhere on a line)::

    # da: allow[rule]               <- INVALID: reason required
    # da: allow[rule] -- reason     <- suppresses `rule` on this line
    # da: allow[r1,r2] -- reason    <- multiple rules
    # da: allow-file[rule] -- reason  <- suppresses `rule` module-wide

Placement: a trailing pragma covers its own physical line; a pragma on a
line of its own (``standalone``) covers the NEXT line too, for call
sites that don't fit a trailing comment. ``allow-file`` belongs near the
top of a module and sanctions a whole seam (e.g. a wall-clock
offload-steering module) — use sparingly, it also covers future code in
that file.

A pragma without a ``-- reason`` justification, or naming a rule the
analyzer doesn't ship, is ITSELF a finding (rule ``pragma``) — the
suppression layer cannot rot silently.

Baselines: a JSON file of ``Finding.baseline_key()`` strings lets a
staged burn-down land incrementally. The repo ships an EMPTY baseline
(``indy_plenum_tpu_torch/analysis/baseline.json``) so every new finding fails
closed; ``--write-baseline`` exists for downstream forks mid-burn-down.

Copy of ``indy_plenum_tpu/analysis/pragmas.py``: the same grammar, so a
pragma reads the same in both packages.
"""
from __future__ import annotations

import io
import json
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Set, Tuple

__all__ = ["Pragma", "parse_pragmas", "pragma_findings",
           "load_baseline", "write_baseline"]

_PRAGMA_RE = re.compile(
    r"#\s*da:\s*(?P<kind>allow|allow-file)\s*"
    r"\[(?P<rules>[^\]]*)\]\s*(?:--\s*(?P<reason>\S.*))?$")


@dataclass
class Pragma:
    line: int
    rules: Tuple[str, ...]
    reason: str
    file_level: bool = False
    standalone: bool = False  # comment-only line: also covers line + 1


def parse_pragmas(source: str) -> Dict[int, Pragma]:
    """line number (1-based) -> Pragma for every ``# da:`` COMMENT.

    Tokenize-based, so pragma grammar quoted inside docstrings or
    string literals (like the examples above) never parses as a real
    suppression."""
    out: Dict[int, Pragma] = {}
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            continue
        idx = tok.start[0]
        rules = tuple(sorted({r.strip() for r in
                              m.group("rules").split(",") if r.strip()}))
        out[idx] = Pragma(
            line=idx, rules=rules, reason=(m.group("reason") or "").strip(),
            file_level=m.group("kind") == "allow-file",
            standalone=tok.string.strip() == tok.line.strip())
    return out


def pragma_findings(path: str, pragmas: Dict[int, Pragma],
                    known_rules: Set[str]) -> List:
    """Self-lint of the suppression layer: reasonless pragmas and
    pragmas naming unknown rules are findings (rule ``pragma``, never
    itself suppressible)."""
    from .core import Finding  # local import: core imports this module

    findings: List[Finding] = []
    for prag in pragmas.values():
        if not prag.reason:
            findings.append(Finding(
                rule="pragma", path=path, line=prag.line, col=0,
                message="pragma missing justification: every "
                        "'# da: allow[...]' must carry '-- reason'"))
        if not prag.rules:
            findings.append(Finding(
                rule="pragma", path=path, line=prag.line, col=0,
                message="pragma names no rules"))
        for rule in prag.rules:
            if rule not in known_rules:
                findings.append(Finding(
                    rule="pragma", path=path, line=prag.line, col=0,
                    message=f"pragma names unknown rule '{rule}'"))
    return findings


def load_baseline(path: str) -> Set[str]:
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    return set(data.get("findings", []))


def write_baseline(path: str, keys: List[str]) -> None:
    Path(path).write_text(json.dumps(
        {"findings": sorted(set(keys))}, indent=2) + "\n")
