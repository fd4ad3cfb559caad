"""Consensus flight recorder: deterministic span traces for the 3PC
lifecycle and the dispatch plane, plus the causal tracing plane that
joins them into cross-node request journeys.

Copy of ``indy_plenum_tpu/observability/__init__.py``: the same exports.
"""
from .causal import (  # noqa: F401
    build_journeys,
    journey_for,
    journey_hash,
    journey_summary,
    merge_events,
    span_id,
    trace_id,
)
from .telemetry import (  # noqa: F401
    ResourceLedger,
    SizedResource,
    TelemetryPlane,
)
from .trace import (  # noqa: F401
    NULL_TRACE,
    NullTraceRecorder,
    TraceRecorder,
    critical_path,
    overlap_report,
    phase_durations,
    phase_percentiles,
    rollup_report,
    to_chrome_trace,
)
