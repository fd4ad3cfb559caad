"""Chaos plane: deterministic fault injection + pool-wide invariants.

The correctness-tooling layer for the RBFT simulation: seeded
:class:`FaultPlan` generation (:mod:`.scenarios`), compilation onto the
virtual clock (:mod:`.scheduler`), PBFT safety/liveness assertions
(:mod:`.invariants`) and replayable JSON reports (:mod:`.report`,
:mod:`.runner`).

Copy of ``indy_plenum_tpu/chaos/__init__.py``, with its imports bound to
the port.
"""
from .faults import (  # noqa: F401
    ClockSkewFault,
    CorruptCatchupRepFault,
    CorruptOrderedLogFault,
    CrashFault,
    DelayFault,
    DropFault,
    DuplicateFault,
    EquivocateFault,
    Fault,
    FaultPlan,
    PartitionFault,
    ReorderFault,
    SilenceFault,
)
from .invariants import (  # noqa: F401
    AGREEMENT,
    LEDGER_ROOTS,
    LIVENESS,
    ORDERED_PREFIX,
    InvariantChecker,
    InvariantResult,
)
from .report import ChaosReport  # noqa: F401
from .runner import run_scenario  # noqa: F401
from .scenarios import SCENARIOS, Scenario, get_scenario  # noqa: F401
from .scheduler import FaultScheduler  # noqa: F401
