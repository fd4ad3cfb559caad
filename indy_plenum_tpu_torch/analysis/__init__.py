"""Determinism & hot-path hygiene analyzer (pure AST — never imports
torch, so it runs anywhere instantly).

Entry points: :func:`analyze_paths` (what the CLI calls),
:func:`analyze_source` (rule fixtures in tests), :data:`ALL_RULES` (the
shipped rule catalog) and :data:`DEFAULT_BASELINE` (the shipped — empty
— baseline, so new findings fail closed). The CLI:
``python -m indy_plenum_tpu_torch.analysis [paths]`` (default: the
``indy_plenum_tpu_torch`` package).

Copy of ``indy_plenum_tpu/analysis/__init__.py``; its device rules
(``rules_device.py``) are retargeted at the port's PyTorch idioms.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

from .core import (
    Analyzer,
    Finding,
    ModuleInfo,
    Project,
    Report,
    Rule,
)
from .pragmas import Pragma, load_baseline, write_baseline
from .rules_config import ConfigKnobRule
from .rules_determinism import HashIdFlowRule, NondeterminismSourceRule
from .rules_device import BufferDonationRule, DeviceSyncRule
from .rules_hotpath import TraceGuardRule
from .rules_ordering import UnorderedFingerprintRule

__all__ = [
    "Analyzer", "Finding", "ModuleInfo", "Project", "Report", "Rule",
    "Pragma", "ALL_RULES", "DEFAULT_BASELINE", "make_rules",
    "analyze_paths", "analyze_source", "load_baseline", "write_baseline",
]

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")


def make_rules() -> List[Rule]:
    """Fresh instances of the full shipped catalog (ConfigKnobRule is
    stateful across a run — never share instances between analyses)."""
    return [
        NondeterminismSourceRule(),
        HashIdFlowRule(),
        UnorderedFingerprintRule(),
        TraceGuardRule(),
        DeviceSyncRule(),
        BufferDonationRule(),
        ConfigKnobRule(),
    ]


ALL_RULES = tuple(r.name for r in make_rules()) + ("pragma",)


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Sequence[Rule]] = None,
                  baseline_path: Optional[str] = None) -> Report:
    """Analyze every .py file under ``paths`` with the shipped rules
    (or ``rules``), applying pragma suppression and the baseline at
    ``baseline_path`` (None -> the shipped empty default)."""
    analyzer = Analyzer(rules if rules is not None else make_rules())
    keys = load_baseline(baseline_path if baseline_path is not None
                         else DEFAULT_BASELINE)
    return analyzer.analyze_paths(paths, baseline_keys=keys)


def analyze_source(source: str, path: str = "fixture.py",
                   rules: Optional[Sequence[Rule]] = None) -> Report:
    """Analyze one in-memory module — the per-rule fixture entry point."""
    analyzer = Analyzer(rules if rules is not None else make_rules())
    return analyzer.analyze_modules(
        [ModuleInfo.from_source(source, path=path)])
