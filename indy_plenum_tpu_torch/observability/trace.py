"""The span interface the vote plane calls, with its null recorder.

Copy of ``NullTraceRecorder``/``NULL_TRACE``/``_NO_SPAN`` from
``indy_plenum_tpu/observability/trace.py``. Call sites guard argument
construction behind ``trace.enabled`` and use
``with trace.span(...) if trace.enabled else _NO_SPAN:``, so a disabled
recorder costs one attribute load. The ring-buffer recorder itself comes
to the port with the consensus services.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

# disabled-trace fast path: a shared, reusable no-op context manager
_NO_SPAN = nullcontext()


class NullTraceRecorder:
    """Zero-cost sink: the default wherever tracing is not requested."""

    enabled = False

    def record(self, name, cat="3pc", node="", key=None, dur=None,
               args=None, ts=None) -> None:
        pass

    @contextmanager
    def span(self, name, cat="dispatch", node="", args=None):
        yield


NULL_TRACE = NullTraceRecorder()
