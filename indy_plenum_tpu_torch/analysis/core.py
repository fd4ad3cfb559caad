"""Rule-visitor framework for the determinism & hot-path analyzer.

Every fingerprint this repo gates on — ``ordered_hash``, ``trace_hash``,
``journey_hash``, ``shed_hash``, the chaos ``replay_command`` — rests on
seeded byte-identical replay, the property RBFT's master-vs-backup
monitoring needs (Aublin et al., ICDCS 2013). The dynamic gates in
``scripts/check_dispatch_budget.py`` re-run pools and diff those
fingerprints, but they only cover the paths their seeds exercise. This
package enforces the same contracts at the SOURCE level: pure-AST rule
visitors (no torch import — the analyzer must run anywhere, instantly)
walk every module and flag the hazard *class* once, for all current and
future code.

Architecture:

- :class:`Rule` — a named check. ``check_module`` sees one parsed
  module; ``finalize`` sees the whole project (for cross-module rules
  like the config-knob registry).
- :class:`ModuleInfo` / :class:`Project` — parsed source + pragma table
  + an import-alias map (``import time as _t`` resolves ``_t.monotonic``
  to the canonical ``time.monotonic``).
- :class:`Analyzer` — deterministic driver: files are discovered in
  sorted order, findings are sorted on a total key, and
  ``findings_hash`` (sha256 over the canonical JSON rendering) is
  byte-identical across runs — the static gate replays the analysis and
  diffs the hash exactly like the dynamic gates diff ``ordered_hash``.

Suppression is two-layer (:mod:`.pragmas`): inline
``# da: allow[rule] -- reason`` pragmas (reason REQUIRED — a reasonless
pragma is itself a finding) and an optional baseline file for staged
burn-downs. The shipped baseline is EMPTY: new findings fail closed.

Copy of ``indy_plenum_tpu/analysis/core.py``: the same framework walks
the port, whose modules it names ``indy_plenum_tpu_torch/...``.
"""
from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .pragmas import Pragma, parse_pragmas, pragma_findings

__all__ = [
    "Finding", "ModuleInfo", "Project", "Rule", "Analyzer", "Report",
    "attach_parents", "resolve_call_name", "build_import_map",
    "iter_scope", "terminal_name", "is_sink_call", "SINK_TERMINALS",
]

# sink names whose inputs must be reproducible bytes — shared by the
# hash-id-flow and unordered-fingerprint rules so they can never
# disagree about what counts as a fingerprint sink
SINK_TERMINALS = frozenset({
    "sha256", "sha512", "sha1", "md5", "blake2b", "blake2s",
    "sha3_256", "to_jsonl",
})


@dataclass(frozen=True)
class Finding:
    """One analyzer hit. Frozen + totally ordered so reports sort and
    hash deterministically."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    suppressed: str = ""  # "" | "pragma" | "baseline"
    reason: str = ""  # pragma justification when suppressed
    # occurrence ordinal among same-(rule, path, message) findings in
    # line order: keeps baseline keys line-drift-proof WITHOUT letting
    # one baselined entry suppress every future identical finding in
    # the file (assigned by the Analyzer)
    ordinal: int = 0

    def sort_key(self) -> Tuple:
        return (self.path, self.line, self.col, self.rule, self.message)

    def baseline_key(self) -> str:
        """Line-number-free identity for baseline matching (lines drift
        as files are edited; rule+path+message+ordinal do not)."""
        digest = hashlib.sha256(self.message.encode()).hexdigest()[:16]
        return f"{self.rule}|{self.path}|{digest}|{self.ordinal}"

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "suppressed": self.suppressed, "reason": self.reason,
            "ordinal": self.ordinal,
        }

    def render(self) -> str:
        tag = f" [{self.suppressed}]" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}{tag}")


def terminal_name(func: ast.AST) -> Optional[str]:
    """The rightmost name of a call target (``x.y.sha256`` -> sha256)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def is_sink_call(node: ast.Call) -> bool:
    """Does this call feed a fingerprint (hash/serialization) sink?"""
    name = terminal_name(node.func)
    if name is None:
        return False
    return name in SINK_TERMINALS or name.endswith("_hash")


def iter_scope(fn):
    """Nodes in ``fn``'s OWN scope: descends everything except nested
    function/lambda definitions, which are visited as their own scopes
    by per-function rules (prevents duplicate findings and cross-scope
    taint bleed)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.da_parent`` so rules can walk
    ancestor chains (guard detection needs enclosing If/IfExp/BoolOp)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.da_parent = node  # type: ignore[attr-defined]


def build_import_map(tree: ast.AST) -> Dict[str, str]:
    """alias -> canonical dotted path, from every import statement.

    ``import numpy as np``            -> {"np": "numpy"}
    ``from time import perf_counter`` -> {"perf_counter": "time.perf_counter"}
    ``from datetime import datetime`` -> {"datetime": "datetime.datetime"}
    """
    mapping: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mapping[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            # relative imports map without the package prefix
            # (``from ..tpu import ed25519`` -> "tpu.ed25519"): enough
            # for scope checks like imports_module("tpu"). Bare
            # relative imports (``from . import ed25519``) map to the
            # sibling's own name.
            for alias in node.names:
                if alias.name == "*":
                    continue
                mapping[alias.asname or alias.name] = \
                    (f"{node.module}.{alias.name}" if node.module
                     else alias.name)
    return mapping


def resolve_call_name(func: ast.AST,
                      imports: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a call target, through import aliases:
    ``_time.perf_counter`` -> ``time.perf_counter``. None when the base
    is not a plain name (method calls on computed receivers)."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = imports.get(node.id, node.id)
    parts.append(base)
    return ".".join(reversed(parts))


@dataclass
class ModuleInfo:
    """One parsed module plus the per-line pragma table."""

    path: str  # repo-relative posix
    source: str
    tree: ast.Module
    pragmas: Dict[int, Pragma]
    imports: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_source(cls, source: str, path: str) -> "ModuleInfo":
        tree = ast.parse(source)
        attach_parents(tree)
        return cls(path=path, source=source, tree=tree,
                   pragmas=parse_pragmas(source),
                   imports=build_import_map(tree))

    def imports_module(self, dotted_prefix: str) -> bool:
        """True when any import resolves into ``dotted_prefix`` (e.g.
        ``torch`` matches ``import torch.nn.functional as F``)."""
        for canon in self.imports.values():
            if canon == dotted_prefix \
                    or canon.startswith(dotted_prefix + "."):
                return True
        return False

    def suppressing_pragma(self, finding: Finding) -> Optional[Pragma]:
        """The pragma covering ``finding``, if any: same line, a
        standalone pragma on the line above, or a file-level
        ``allow-file`` pragma."""
        for line in (finding.line, finding.line - 1):
            prag = self.pragmas.get(line)
            if prag is None:
                continue
            if line == finding.line - 1 and not prag.standalone:
                continue  # trailing pragma on the previous line covers
                # that line only; standalone pragmas cover the next
            if finding.rule in prag.rules:
                return prag
        for prag in self.pragmas.values():
            if prag.file_level and finding.rule in prag.rules:
                return prag
        return None


@dataclass
class Project:
    """Every analyzed module, in deterministic (sorted-path) order."""

    modules: List[ModuleInfo]

    def by_path(self, suffix: str) -> Optional[ModuleInfo]:
        for mod in self.modules:
            if mod.path.endswith(suffix):
                return mod
        return None


class Rule:
    """Base class: subclasses set ``name``/``summary`` and override
    ``check_module`` (per-module findings) and/or ``finalize``
    (cross-module findings, run after every module was seen)."""

    name: str = ""
    summary: str = ""

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        return []

    def finalize(self, project: Project) -> List[Finding]:
        return []


@dataclass
class Report:
    """Sorted findings + the byte-stable fingerprint the gate diffs."""

    findings: List[Finding]
    files_analyzed: int
    rules: List[str]

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def findings_hash(self) -> str:
        """sha256 over the canonical JSON rendering of EVERY finding,
        suppression state included — editing a pragma moves the hash, so
        the static gate's two-run diff covers the suppression layer too."""
        payload = json.dumps([f.to_dict() for f in self.findings],
                             sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()

    def to_dict(self) -> Dict:
        return {
            "files_analyzed": self.files_analyzed,
            "rules": self.rules,
            "findings": [f.to_dict() for f in self.findings],
            "total": len(self.findings),
            "unsuppressed": len(self.unsuppressed),
            "suppressed": len(self.suppressed),
            "findings_hash": self.findings_hash,
        }


class Analyzer:
    """Deterministic driver: sorted file walk, sorted findings, pragma +
    baseline suppression applied uniformly."""

    def __init__(self, rules: Sequence[Rule],
                 known_rules: Optional[set] = None):
        """``known_rules``: the FULL catalog for the pragma self-lint.
        Defaults to the active rules; a filtered run (CLI ``--rule``)
        must pass the full set or pragmas naming unfiltered rules would
        false-positive as 'unknown rule'."""
        names = [r.name for r in rules]
        assert len(names) == len(set(names)), "duplicate rule names"
        self.rules = list(rules)
        self.known_rules = (set(known_rules) if known_rules is not None
                            else set(names))

    # --- discovery ------------------------------------------------------

    @staticmethod
    def discover(paths: Iterable[str]) -> List[Tuple[str, Path]]:
        """(repo-relative posix path, absolute Path) for every .py file
        under ``paths``, sorted — the walk order is part of the
        determinism contract. Relative names are anchored at each input
        path's parent, so ``lint indy_plenum_tpu_torch`` names files
        ``indy_plenum_tpu_torch/...`` regardless of the CWD they resolve
        from."""
        out: List[Tuple[str, Path]] = []
        for raw in paths:
            p = Path(raw).resolve()
            if not p.exists():
                # fail CLOSED: a typo'd path or wrong CWD must never
                # report the package clean
                raise FileNotFoundError(
                    f"analysis path does not exist: {raw}")
            # anchor at the PACKAGE root (nearest ancestor without an
            # __init__.py), so single-file and subdirectory runs name
            # modules exactly like a whole-package walk would —
            # path-prefix allowlists and scope checks depend on it
            root = p.parent
            probe = p if p.is_dir() else p.parent
            while (probe / "__init__.py").exists() \
                    and probe.parent != probe:
                probe = probe.parent
                root = probe
            if p.is_file():
                out.append((p.relative_to(root).as_posix(), p))
                continue
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                out.append((f.relative_to(root).as_posix(), f))
        out.sort()
        return out

    # --- analysis -------------------------------------------------------

    def analyze_modules(self, modules: List[ModuleInfo],
                        baseline_keys: Optional[set] = None) -> Report:
        project = Project(modules=modules)
        findings: List[Finding] = []
        for mod in modules:
            findings.extend(pragma_findings(
                mod.path, mod.pragmas, known_rules=self.known_rules))
            for rule in self.rules:
                findings.extend(rule.check_module(mod))
        for rule in self.rules:
            findings.extend(rule.finalize(project))

        # occurrence ordinals per (rule, path, message) in line order,
        # BEFORE baseline matching — they are part of the baseline key
        findings.sort(key=Finding.sort_key)
        seen_counts: Dict[Tuple, int] = {}
        numbered: List[Finding] = []
        for f in findings:
            key = (f.rule, f.path, f.message)
            n = seen_counts.get(key, 0)
            seen_counts[key] = n + 1
            numbered.append(replace(f, ordinal=n) if n else f)
        findings = numbered

        by_path = {mod.path: mod for mod in modules}
        resolved: List[Finding] = []
        for f in findings:
            mod = by_path.get(f.path)
            prag = mod.suppressing_pragma(f) if mod is not None else None
            if f.rule == "pragma":
                pass  # the suppression layer's self-lint is never
                # suppressible — not by pragma, not by baseline
            elif prag is not None:
                f = replace(f, suppressed="pragma", reason=prag.reason)
            elif baseline_keys and f.baseline_key() in baseline_keys:
                f = replace(f, suppressed="baseline")
            resolved.append(f)
        resolved.sort(key=Finding.sort_key)
        return Report(findings=resolved, files_analyzed=len(modules),
                      rules=sorted(r.name for r in self.rules))

    def analyze_paths(self, paths: Iterable[str],
                      baseline_keys: Optional[set] = None) -> Report:
        modules = []
        for rel, abs_path in self.discover(paths):
            modules.append(ModuleInfo.from_source(
                abs_path.read_text(), path=rel))
        return self.analyze_modules(modules, baseline_keys=baseline_keys)
