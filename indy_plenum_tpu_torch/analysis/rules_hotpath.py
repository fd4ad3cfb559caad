"""Rule: hot-path trace call sites must guard allocation on `.enabled`.

``trace-guard`` — the flight recorder's disabled mode (``NULL_TRACE``)
makes ``record()``/``span()`` free, but the ARGUMENTS are built by the
caller before the no-op method ever sees them: a dict display, a tuple
key or an f-string allocates on every pass through the hot loop even
when tracing is off. The repo's contract (observability/trace.py
docstring, proven dynamically for exercised sites by the strict
NULL_TRACE test) is that every call site with allocating args is guarded
on ``trace.enabled`` — this rule covers ALL sites in the hot-path
packages statically, exercised or not.

Recognized guard shapes::

    if self.trace.enabled: self.trace.record(..., args={...})
    trace_on = self.trace.enabled        # guard-name
    if trace_on: ...
    with t.span(...) if t.enabled else _NO_SPAN: ...
    t.enabled and t.record(...)
    if not trace.enabled: return         # early-exit guard
    ...unguarded-after-return is guarded...

Calls whose every argument is a constant or a plain name/attribute load
are exempt — they allocate nothing.

Copy of ``indy_plenum_tpu/analysis/rules_hotpath.py``; its scope names
the port's packages (``network/`` kept for when it lands).
"""
from __future__ import annotations

import ast
import itertools
from typing import List, Set

from .core import Finding, ModuleInfo, Rule, iter_scope

__all__ = ["TraceGuardRule"]

# hot-path packages: the dispatch plane, the 3PC services, admission,
# and both transports (the tick loop calls straight into all four)
_SCOPE = (
    "indy_plenum_tpu_torch/tpu/",
    "indy_plenum_tpu_torch/server/consensus/",
    "indy_plenum_tpu_torch/ingress/",
    "indy_plenum_tpu_torch/network/",
)


def _is_trace_name(name) -> bool:
    return name is not None and ("trace" in name.lower()
                                 or name in ("trc", "recorder"))


def _terminal_of(node: ast.AST):
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _receiver_is_trace(func: ast.Attribute) -> bool:
    """True for <recv>.record / <recv>.span where the receiver's
    terminal name smells like a trace recorder."""
    return _is_trace_name(_terminal_of(func.value))


def _allocates(node: ast.AST) -> bool:
    """Does evaluating this argument expression allocate? Constants and
    plain name/attribute loads don't; displays, calls, f-strings,
    arithmetic and subscripts do."""
    if isinstance(node, ast.Constant):
        return False
    if isinstance(node, ast.Name):
        return False
    if isinstance(node, ast.Attribute):
        return _allocates(node.value)
    if isinstance(node, ast.UnaryOp) \
            and isinstance(node.operand, ast.Constant):
        return False
    return True


def _mentions_enabled(expr: ast.AST, guard_names: Set[str]) -> bool:
    """A TRACE-enabled test: ``<trace-ish>.enabled`` or a guard-name
    derived from one. An unrelated feature flag's ``.enabled``
    (``self.metrics.enabled``) is NOT a trace guard — accepting it
    would let any flag silence the rule."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr == "enabled" \
                and _is_trace_name(_terminal_of(sub.value)):
            return True
        if isinstance(sub, ast.Name) and sub.id in guard_names:
            return True
    return False


def _test_polarity(test: ast.AST, guard_names: Set[str]) -> int:
    """+1 when the test is TRUE while tracing is on (plain mention),
    -1 when it is the negation (``not trace.enabled`` — true while
    tracing is OFF), 0 when tracing is not involved. Polarity decides
    WHICH branch of an If/IfExp counts as guarded."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return -1 if _mentions_enabled(test.operand, guard_names) else 0
    return 1 if _mentions_enabled(test, guard_names) else 0


class TraceGuardRule(Rule):
    name = "trace-guard"
    summary = ("trace.record()/span() with allocating args not guarded "
               "on trace.enabled in a hot-path package")

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        if not any(module.path.startswith(p) for p in _SCOPE):
            return []
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(self._check_function(module, fn))
        return findings

    def _check_function(self, module: ModuleInfo, fn) -> List[Finding]:
        # per-scope walk (iter_scope): nested defs are their own scopes
        guard_names: Set[str] = set()
        for node in iter_scope(fn):
            # only POSITIVE derivations become guard names: `off = not
            # trace.enabled` guards the DISABLED branch, not this one
            if isinstance(node, ast.Assign) \
                    and _test_polarity(node.value, set()) > 0:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        guard_names.add(tgt.id)

        # early-exit guards: every node lexically after
        # `if not <enabled>: return/continue/raise` in the same block
        shielded: Set[int] = set()
        for node in itertools.chain((fn,), iter_scope(fn)):
            for block in (getattr(node, "body", None),
                          getattr(node, "orelse", None),
                          getattr(node, "finalbody", None)):
                if not isinstance(block, list):
                    continue
                for i, stmt in enumerate(block):
                    if self._is_early_exit_guard(stmt, guard_names):
                        for later in block[i + 1:]:
                            for sub in ast.walk(later):
                                shielded.add(id(sub))

        findings: List[Finding] = []
        for node in iter_scope(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("record", "span")
                    and _receiver_is_trace(node.func)):
                continue
            alloc_args = [a for a in list(node.args)
                          + [kw.value for kw in node.keywords]
                          if _allocates(a)]
            if not alloc_args:
                continue
            if id(node) in shielded:
                continue
            if self._is_guarded(node, fn, guard_names):
                continue
            findings.append(Finding(
                rule=self.name, path=module.path,
                line=node.lineno, col=node.col_offset,
                message=f"{ast.unparse(node.func)}(...) in {fn.name}() "
                        "builds allocating args unguarded — wrap in "
                        "'if trace.enabled:' (or '... if trace.enabled "
                        "else _NO_SPAN' for spans) so a disabled "
                        "recorder costs one branch"))
        return findings

    @staticmethod
    def _is_early_exit_guard(stmt: ast.AST,
                             guard_names: Set[str]) -> bool:
        if not isinstance(stmt, ast.If) or stmt.orelse:
            return False
        test = stmt.test
        if not (isinstance(test, ast.UnaryOp)
                and isinstance(test.op, ast.Not)
                and _mentions_enabled(test.operand, guard_names)):
            return False
        last = stmt.body[-1]
        return isinstance(last, (ast.Return, ast.Continue, ast.Raise))

    @staticmethod
    def _is_guarded(node: ast.AST, fn, guard_names: Set[str]) -> bool:
        cur = getattr(node, "da_parent", None)
        while cur is not None and cur is not fn.da_parent:  # type: ignore
            if isinstance(cur, ast.If):
                # polarity picks the guarded branch: body for
                # `if trace.enabled`, orelse for `if not trace.enabled`
                pol = _test_polarity(cur.test, guard_names)
                branch = cur.body if pol > 0 else \
                    cur.orelse if pol < 0 else []
                if any(id(node) == id(sub)
                       for s in branch for sub in ast.walk(s)):
                    return True
            if isinstance(cur, ast.IfExp):
                pol = _test_polarity(cur.test, guard_names)
                branch = cur.body if pol > 0 else \
                    cur.orelse if pol < 0 else None
                if branch is not None and any(
                        id(node) == id(sub)
                        for sub in ast.walk(branch)):
                    return True
            if isinstance(cur, ast.BoolOp) \
                    and isinstance(cur.op, ast.And):
                for i, val in enumerate(cur.values):
                    if any(id(node) == id(sub) for sub in ast.walk(val)):
                        if any(_mentions_enabled(prev, guard_names)
                               for prev in cur.values[:i]):
                            return True
                        break
            if cur is fn:
                break
            cur = getattr(cur, "da_parent", None)
        return False
