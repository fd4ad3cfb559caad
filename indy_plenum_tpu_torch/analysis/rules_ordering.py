"""Rule: unordered iteration inside fingerprint-producing functions.

``unordered-fingerprint`` — ``ordered_hash`` / ``trace_hash`` /
``shed_hash`` / ``journey_hash`` are sha256 over a serialized walk of
host data structures. Iterating a ``set`` (arbitrary order under hash
randomization) or ``dict.values()`` (insertion order — deterministic
only if every insertion path is) inside a function whose output reaches
such a sink yields a fingerprint that can differ between identical
seeded runs. Taint-lite: the rule looks intra-function — a function
counts as "fingerprint context" when its NAME is a fingerprint
(``*_hash``) or its body calls a hash/serialization sink; any unordered
iteration inside it is flagged. The fix is ``sorted(...)`` with an
explicit key; sites whose order provably cannot reach the sink take a
pragma saying why.

Copy of ``indy_plenum_tpu/analysis/rules_ordering.py``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, ModuleInfo, Rule, is_sink_call, iter_scope

__all__ = ["UnorderedFingerprintRule"]


def _is_fingerprint_fn(fn) -> bool:
    if fn.name.endswith("_hash") or fn.name == "fingerprint":
        return True
    for node in iter_scope(fn):
        if isinstance(node, ast.Call) and is_sink_call(node):
            return True
    return False


class UnorderedFingerprintRule(Rule):
    name = "unordered-fingerprint"
    summary = ("set / dict.values() iteration inside a function that "
               "feeds a hash or serialization sink")

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_fingerprint_fn(fn):
                continue
            findings.extend(self._check_function(module, fn))
        return findings

    def _check_function(self, module: ModuleInfo, fn) -> List[Finding]:
        # names bound (anywhere in this scope) from set constructors;
        # nested functions are their own scopes (iter_scope)
        set_names: Set[str] = set()
        for node in iter_scope(fn):
            if isinstance(node, ast.Assign) \
                    and self._is_set_expr(node.value, set_names):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        set_names.add(tgt.id)

        findings: List[Finding] = []
        iters: List[ast.AST] = []
        for node in iter_scope(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters.extend(gen.iter for gen in node.generators)
        for it in iters:
            why = self._unordered_why(it, set_names)
            if why is not None:
                findings.append(Finding(
                    rule=self.name, path=module.path,
                    line=it.lineno, col=it.col_offset,
                    message=f"iteration over {why} inside fingerprint "
                            f"context {fn.name}() — order is not part "
                            "of the replay contract; wrap in "
                            "sorted(..., key=...)"))
        return findings

    @staticmethod
    def _is_set_expr(node: ast.AST, set_names: Set[str]) -> bool:
        if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.Name) and node.id in set_names:
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            # set algebra keeps set-ness: s1 | s2, s & t, s - t
            return (UnorderedFingerprintRule._is_set_expr(
                        node.left, set_names)
                    or UnorderedFingerprintRule._is_set_expr(
                        node.right, set_names))
        return False

    @classmethod
    def _unordered_why(cls, it: ast.AST,
                       set_names: Set[str]) -> Optional[str]:
        if cls._is_set_expr(it, set_names):
            if isinstance(it, ast.Name):
                return f"set '{it.id}'"
            return "a set expression"
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr == "values" and not it.args:
            return "dict.values() (insertion-order dependent)"
        return None
