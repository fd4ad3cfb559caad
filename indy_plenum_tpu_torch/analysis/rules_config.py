"""Rule: config-knob cross-check + the generated knob registry.

``config-knob`` — the knob surface (``Catchup*``, ``Governor*``,
``Ingress*``, ...) has grown PR-over-PR with no registry: a typo'd
``config.CatchupMaxRetrys`` read silently evaluates the getattr default
forever, and a knob nobody reads anymore ships as dead documentation.
This rule cross-checks both directions over the WHOLE package:

- every ``config.X`` / ``getattr(config, "X", ...)`` attribute read
  must resolve to a field (or method) of :class:`~indy_plenum_tpu_torch.
  config.Config`;
- every field defined in ``config.py`` must be read somewhere in the
  analyzed paths (knobs consumed only by out-of-package scripts carry a
  pragma on their definition line saying so).

The collected read map doubles as the knob REGISTRY:
``python -m indy_plenum_tpu_torch.analysis --emit-knobs`` renders it as
a markdown table — config knobs documented in one generated place.

Copy of ``indy_plenum_tpu/analysis/rules_config.py``; it reads the
port's ``config.py``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo, Project, Rule, resolve_call_name

__all__ = ["ConfigKnobRule"]

# receiver terminal names that denote a Config instance ("cfg" is NOT
# here: the repo uses it for non-Config locals; names assigned from
# getConfig(...) are tainted per-module instead)
_CONFIG_NAMES = {"config", "_config"}
# attribute names on Config that are machinery, not knobs
_NON_KNOB_ATTRS = {"overlay", "replicas_count", "governor_bounds"}


def _receiver_terminal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclass
class _KnobDef:
    name: str
    line: int
    default: str
    pragma_reason: str = ""  # the def-line pragma's justification


class ConfigKnobRule(Rule):
    name = "config-knob"
    summary = ("config.X reads must resolve to a default in config.py; "
               "every defined knob must be read somewhere")

    def __init__(self) -> None:
        # knob -> sorted reader module paths; populated by finalize and
        # consumed by the --emit-knobs registry renderer
        self.registry: Dict[str, List[str]] = {}
        self.knob_defs: Dict[str, _KnobDef] = {}
        self._config_path = "config.py"
        self._reads: List[Tuple[str, int, int, str]] = []

    # --- per-module: collect reads -------------------------------------

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        is_config_py = module.path.endswith("/config.py") \
            or module.path == "config.py"
        # names assigned from getConfig(...) are Config instances too
        config_locals = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                canon = resolve_call_name(node.value.func, module.imports)
                if canon is not None and canon.endswith("getConfig"):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            config_locals.add(tgt.id)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                recv = node.value
                term = _receiver_terminal(recv)
                if term in _CONFIG_NAMES or (
                        isinstance(recv, ast.Name)
                        and recv.id in config_locals):
                    # canonical dotted base through import aliases, so
                    # foreign `.config` objects (jax.config.update)
                    # are skipped
                    base = resolve_call_name(recv, module.imports)
                    if base is not None and (base.startswith("jax.")
                                             or base == "jax"):
                        continue
                    self._note_read(module.path, node.lineno,
                                    node.col_offset, node.attr)
                elif is_config_py and isinstance(recv, ast.Name) \
                        and recv.id == "self":
                    # Config methods reading their own fields count as
                    # consumption (callers reach them via the method)
                    self._note_read(module.path, node.lineno,
                                    node.col_offset, node.attr)
            elif isinstance(node, ast.Call):
                canon = resolve_call_name(node.func, module.imports)
                if canon == "getattr" and len(node.args) >= 2:
                    term = _receiver_terminal(node.args[0])
                    if (term in _CONFIG_NAMES or term in config_locals) \
                            and isinstance(node.args[1], ast.Constant) \
                            and isinstance(node.args[1].value, str):
                        self._note_read(module.path, node.lineno,
                                        node.col_offset,
                                        node.args[1].value)
        if is_config_py:
            self._collect_defs(module)
        return []

    def _note_read(self, path: str, line: int, col: int,
                   attr: str) -> None:
        if attr.startswith("__") or attr in _NON_KNOB_ATTRS:
            return
        self._reads.append((path, line, col, attr))

    def _collect_defs(self, module: ModuleInfo) -> None:
        self._config_path = module.path
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and node.name == "Config":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        default = (ast.unparse(stmt.value)
                                   if stmt.value is not None else "")
                        # same placement contract as suppressing_pragma:
                        # a line-above pragma counts only when
                        # standalone, or a trailing neighbor would leak
                        # its justification onto the NEXT knob
                        reason = ""
                        for line in (stmt.lineno, stmt.lineno - 1):
                            prag = module.pragmas.get(line)
                            if prag is None:
                                continue
                            if line == stmt.lineno - 1 \
                                    and not prag.standalone:
                                continue
                            if self.name in prag.rules:
                                reason = prag.reason
                                break
                        self.knob_defs[stmt.target.id] = _KnobDef(
                            name=stmt.target.id, line=stmt.lineno,
                            default=default, pragma_reason=reason)

    # --- cross-module verdicts -----------------------------------------

    def finalize(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        if not self.knob_defs:
            # config.py outside the analyzed set (rule fixtures): only
            # the read map is available, no cross-check possible
            self._reads.clear()
            return findings
        config_path = self._config_path
        read_by: Dict[str, Set[str]] = {}
        for path, line, col, attr in self._reads:
            if attr in self.knob_defs:
                read_by.setdefault(attr, set()).add(path)
            else:
                findings.append(Finding(
                    rule=self.name, path=path, line=line, col=col,
                    message=f"config knob '{attr}' has no default in "
                            "config.py — typo'd reads evaluate their "
                            "getattr fallback forever"))
        for knob, kdef in self.knob_defs.items():
            readers = read_by.get(knob, set())
            # a knob read ONLY inside config.py's own methods without
            # any caller module is still an orphan — require a reader
            # outside the defining module OR a method-mediated read
            # (method reads count: the method has package callers)
            if not readers:
                findings.append(Finding(
                    rule=self.name, path=config_path, line=kdef.line,
                    col=0,
                    message=f"config knob '{knob}' is defined but "
                            "never read in the analyzed paths — dead "
                            "surface (delete it, or pragma with where "
                            "it IS read)"))
        self.registry = {k: sorted(v) for k, v in read_by.items()}
        self._reads.clear()
        return findings

    # --- registry rendering (--emit-knobs) -----------------------------

    def render_registry(self) -> str:
        """Markdown table of every defined knob: default + readers.
        Deterministic: knobs in definition order, readers sorted."""
        lines = ["| Knob | Default | Read by |",
                 "| --- | --- | --- |"]
        for knob, kdef in sorted(self.knob_defs.items(),
                                 key=lambda kv: kv[1].line):
            readers = self.registry.get(knob, [])
            shown = ", ".join(
                f"`{r.split('indy_plenum_tpu_torch/')[-1]}`" for r in readers
                if not r.endswith("config.py"))
            if not shown:
                shown = (f"_{kdef.pragma_reason}_"
                         if kdef.pragma_reason else "_(config.py only)_")
            default = kdef.default.replace("|", "\\|")
            lines.append(f"| `{knob}` | `{default}` | {shown} |")
        return "\n".join(lines)
