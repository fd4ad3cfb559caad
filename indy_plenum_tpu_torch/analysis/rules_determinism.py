"""Rules: nondeterminism sources & builtin hash()/id() feeding sinks.

``nondet-source`` — every fingerprint in this repo (``ordered_hash``,
``trace_hash``, ``shed_hash``, ``journey_hash``) assumes a seeded run
replays byte-identically. A wall-clock read, an unseeded RNG or an
``os.urandom`` draw anywhere on a consensus-reachable path breaks that
silently — exactly the hazard class RBFT's master-vs-backup monitoring
cannot tolerate. Sanctioned seams (crypto key generation, the deployed
Node's injected ``perf_counter`` trace clock) are allowlisted by module;
everything else needs a line pragma naming WHY the reading never feeds
consensus state or a fingerprint.

``hash-id-flow`` — builtin ``hash()`` is salted per-process
(PYTHONHASHSEED) and ``id()`` is an allocator address: neither may ever
reach a ``*_hash`` / serialization sink. ``__hash__`` implementations
are exempt (dict/set identity is in-process by definition).

Copy of ``indy_plenum_tpu/analysis/rules_determinism.py``; its allowlist
names the port's package.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import (
    Finding,
    ModuleInfo,
    Rule,
    is_sink_call,
    iter_scope,
    resolve_call_name,
    terminal_name,
)

__all__ = ["NondeterminismSourceRule", "HashIdFlowRule"]

# canonical call targets that read wall clocks / entropy
_FORBIDDEN_EXACT = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
    "uuid.uuid1", "uuid.uuid4",
    "os.urandom",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.choice", "secrets.randbelow",
}
# stdlib `random` module-level draws ride the shared unseeded instance
_RANDOM_DRAWS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "getrandbits", "randbytes", "gauss",
    "betavariate", "expovariate", "normalvariate", "lognormvariate",
    "triangular", "vonmisesvariate", "paretovariate", "weibullvariate",
}
# numpy.random direct draws (the legacy global RandomState)
_NP_DRAWS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "permutation", "shuffle", "normal", "uniform",
    "standard_normal", "bytes", "seed",
}
# constructors that are fine WHEN SEEDED (an argument present)
_SEEDABLE = {
    "random.Random", "numpy.random.RandomState",
    "numpy.random.default_rng", "numpy.random.SeedSequence",
    "numpy.random.Generator",
}


class NondeterminismSourceRule(Rule):
    name = "nondet-source"
    summary = ("wall-clock / entropy / unseeded-RNG reads outside the "
               "sanctioned clock & key-generation seams")

    # Sanctioned seams (module-path prefixes): crypto KEY GENERATION is
    # entropy by design; the analysis package itself never runs inside a
    # consensus process.
    ALLOWLIST = (
        "indy_plenum_tpu_torch/crypto/",
        "indy_plenum_tpu_torch/analysis/",
    )

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        if any(module.path.startswith(p) for p in self.ALLOWLIST):
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = resolve_call_name(node.func, module.imports)
            if canon is None:
                continue
            msg = self._classify(canon, node)
            if msg is not None:
                findings.append(Finding(
                    rule=self.name, path=module.path,
                    line=node.lineno, col=node.col_offset, message=msg))
        return findings

    @staticmethod
    def _classify(canon: str, node: ast.Call) -> Optional[str]:
        if canon in _FORBIDDEN_EXACT:
            return (f"call to {canon}() — wall-clock/entropy read; "
                    "seeded replay cannot reproduce it (inject the "
                    "timer/seed, or pragma a sanctioned seam)")
        if canon in _SEEDABLE:
            if not node.args and not node.keywords:
                return (f"{canon}() constructed WITHOUT a seed — every "
                        "RNG must derive from the run seed")
            return None
        if canon == "random.SystemRandom":
            return "random.SystemRandom is os-entropy by definition"
        parts = canon.split(".")
        if parts[0] == "random" and len(parts) == 2 \
                and parts[1] in _RANDOM_DRAWS:
            return (f"module-level {canon}() rides the shared UNSEEDED "
                    "random instance — draw from a random.Random(seed)")
        if canon.startswith("numpy.random.") \
                and parts[-1] in _NP_DRAWS:
            return (f"{canon}() rides numpy's global RandomState — "
                    "draw from np.random.RandomState(seed) / "
                    "default_rng(seed)")
        return None


class HashIdFlowRule(Rule):
    name = "hash-id-flow"
    summary = ("builtin hash()/id() feeding a *_hash or serialization "
               "sink (hash() is PYTHONHASHSEED-salted, id() is an "
               "address)")

    def check_module(self, module: ModuleInfo) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__hash__":
                continue  # in-process dict/set identity is the POINT
            findings.extend(self._check_function(module, fn))
        return findings

    def _check_function(self, module: ModuleInfo, fn) -> List[Finding]:
        # taint-lite: names assigned (directly) from hash()/id() calls;
        # iter_scope keeps nested functions out — they are visited as
        # their own scopes, so no duplicate findings or taint bleed.
        # Accumulator names assigned from sink constructors
        # (``acc = hashlib.sha256()``) make ``acc.update(...)`` a sink
        # too — the streaming idiom must not escape the rule.
        tainted: Set[str] = set()
        accumulators: Set[str] = set()
        for node in iter_scope(fn):
            if not isinstance(node, ast.Assign):
                continue
            if isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name) \
                    and node.value.func.id in ("hash", "id"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tainted.add(tgt.id)
            elif isinstance(node.value, ast.Call) \
                    and is_sink_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        accumulators.add(tgt.id)

        def is_sink(node: ast.Call) -> bool:
            if is_sink_call(node):
                return True
            return (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in accumulators)

        findings: List[Finding] = []
        for node in iter_scope(fn):
            if not (isinstance(node, ast.Call) and is_sink(node)):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    hit: Optional[str] = None
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Name) \
                            and sub.func.id in ("hash", "id"):
                        hit = f"builtin {sub.func.id}()"
                    elif isinstance(sub, ast.Name) and sub.id in tainted:
                        # no line number in the message: baseline keys
                        # hash the message and must survive line drift
                        hit = (f"'{sub.id}' (assigned from builtin "
                               "hash()/id() in this function)")
                    if hit is not None:
                        sink = terminal_name(node.func)
                        findings.append(Finding(
                            rule=self.name, path=module.path,
                            line=node.lineno, col=node.col_offset,
                            message=f"{hit} flows into sink "
                                    f"'{sink}(...)' in {fn.name}() — "
                                    "process-salted/address values must "
                                    "never reach a fingerprint"))
        return findings
