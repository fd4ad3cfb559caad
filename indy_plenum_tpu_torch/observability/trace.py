"""Consensus flight recorder: bounded, deterministic span traces.

A ring-buffer :class:`TraceRecorder` captures structured events for the
per-batch 3PC lifecycle (``3pc.preprepare`` ... ``3pc.executed``, keyed
``(view_no, pp_seq_no, digest)``), the per-request ingress marks
(``req.ingress`` -> ``req.finalised``), the per-tick dispatch plane (cat
``dispatch``: ``tick.drain``, ``flush.dispatch``, ``flush.readback``,
``tick.flush``, ``tick.eval``, ``tick.governor``) and flight events (cat
``flight``, each snapshotting the ring's tail).

Determinism contract: the clock is INJECTED. Simulation pools hand in
``MockTimer.get_current_time`` (logical time), so a seeded run produces a
bit-identical JSONL dump, checkable like ``SimPool.ordered_hash()``
(:meth:`TraceRecorder.trace_hash`). Recording costs ~nothing when
disabled: :data:`NULL_TRACE` is a :class:`NullTraceRecorder`, and every
hot-path call site guards argument construction behind ``trace.enabled``.

Copy of the recorder part of ``indy_plenum_tpu/observability/trace.py``
(``TraceRecorder``, ``NullTraceRecorder``, the JSONL dump format) and of
its nearest-rank ``percentile``, which the causal journeys use. The
other dump analytics (phase percentiles, critical path, overlap and
rollup reports, Chrome trace export) and the ordering lanes'
``LaneTraceView`` are not part of the port yet.
"""
from __future__ import annotations

import hashlib
import json
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# disabled-trace fast path: a shared no-op context manager (nullcontext
# is reentrant and reusable) so call-site span guards stay one branch:
# ``with trace.span(...) if trace.enabled else _NO_SPAN:``
_NO_SPAN = nullcontext()

DEFAULT_CAPACITY = 65536
# tail size snapshotted by a flight trigger, and how many triggered
# dumps the recorder retains (oldest evicted): a storm of stall votes
# must not grow memory without bound
FLIGHT_TAIL = 512
MAX_FLIGHT_DUMPS = 8


class TraceRecorder:
    """Bounded ring buffer of span events on an injected clock."""

    enabled = True

    def __init__(self, clock: Callable[[], float],
                 capacity: int = DEFAULT_CAPACITY, node: str = "",
                 flight_tail: int = FLIGHT_TAIL):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._clock = clock
        self.capacity = capacity
        self.node = node
        self.flight_tail = flight_tail
        # (seq, ts, name, cat, node, key, dur, args) — tuples, not dicts:
        # one append per event on the hot path, serialization is lazy
        self._events: "deque[tuple]" = deque(maxlen=capacity)
        self._seq = 0
        # triggered flight dumps: {"reason", "ts", "seq", "events"}
        self.dumps: "deque[dict]" = deque(maxlen=MAX_FLIGHT_DUMPS)

    # --- recording ------------------------------------------------------

    def record(self, name: str, cat: str = "3pc", node: str = "",
               key: Optional[Sequence] = None, dur: Optional[float] = None,
               args: Optional[Dict[str, Any]] = None,
               ts: Optional[float] = None) -> None:
        self._seq += 1
        self._events.append(
            (self._seq, self._clock() if ts is None else ts, name, cat,
             node or self.node, tuple(key) if key is not None else None,
             dur, args))

    @contextmanager
    def span(self, name: str, cat: str = "dispatch", node: str = "",
             args: Optional[Dict[str, Any]] = None):
        """Record a complete span (``dur`` = clock delta around the body).
        Under a virtual clock the duration is 0 unless the body advances
        the clock — the *sequence* is the deterministic signal; real
        durations come from ``perf_counter`` on deployed nodes."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(name, cat=cat, node=node, args=args, ts=t0,
                        dur=self._clock() - t0)

    # --- flight-recorder triggers --------------------------------------

    def trigger_dump(self, reason: str, node: str = "",
                     args: Optional[Dict[str, Any]] = None) -> dict:
        """The flight-recorder moment: record a ``flight.<reason>`` mark,
        then snapshot the ring's tail (mark included) into :attr:`dumps`.
        Returns the snapshot so callers (chaos reports) can attach it."""
        self.record("flight." + reason, cat="flight", node=node, args=args)
        snap = {"reason": reason, "ts": self._events[-1][1],
                "seq": self._seq, "events": self.tail(self.flight_tail)}
        self.dumps.append(snap)
        return snap

    # --- reading / dumping ---------------------------------------------

    @staticmethod
    def _as_dict(ev: tuple) -> Dict[str, Any]:
        seq, ts, name, cat, node, key, dur, args = ev
        out: Dict[str, Any] = {"seq": seq, "ts": ts, "name": name,
                               "cat": cat}
        if node:
            out["node"] = node
        if key is not None:
            out["key"] = list(key)
        if dur is not None:
            out["dur"] = dur
        if args:
            out["args"] = args
        return out

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        # a recorder is never falsy: with __len__ defined, an enabled
        # but still-empty ring would otherwise fail `trace or NULL_TRACE`
        # style guards and silently drop everything
        return True

    def events(self) -> List[Dict[str, Any]]:
        return [self._as_dict(ev) for ev in self._events]

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        if n is None or n >= len(self._events):
            return self.events()
        take = list(self._events)[len(self._events) - n:]
        return [self._as_dict(ev) for ev in take]

    def to_jsonl(self) -> str:
        return events_to_jsonl(self.events())

    def dump(self, path: str, tail: Optional[int] = None) -> str:
        with open(path, "w") as fh:
            fh.write(events_to_jsonl(self.tail(tail)))
        return path

    def trace_hash(self, exclude_cats: Sequence[str] = ()) -> str:
        """sha256 of the JSONL serialization — THE trace fingerprint
        (seeded runs must reproduce it bit-for-bit, like
        ``ordered_hash``). ``exclude_cats`` drops whole categories
        before hashing: the device-eval vs host-eval identity tests
        compare the protocol timeline (3pc/req/vc) while the dispatch
        category legitimately differs (``flush.readback`` carries the
        actual readback byte counts, which are the thing being
        changed)."""
        if not exclude_cats:
            return hashlib.sha256(self.to_jsonl().encode()).hexdigest()
        drop = set(exclude_cats)
        evs = [e for e in self.events() if e.get("cat") not in drop]
        # renumber seq within the retained stream: seq is a same-ts
        # tiebreaker over ALL events, so without this an excluded
        # category's event COUNT would leak into the fingerprint (a
        # rebalanced arm emits extra dispatch marks and every later
        # protocol event's seq shifts by one)
        for i, e in enumerate(evs):
            e["seq"] = i
        return hashlib.sha256(events_to_jsonl(evs).encode()).hexdigest()

    def clear(self) -> None:
        self._events.clear()
        self.dumps.clear()


class NullTraceRecorder(TraceRecorder):
    """Zero-cost sink: the default wherever tracing is not requested.
    Call sites additionally guard argument construction behind
    ``trace.enabled`` so a disabled recorder costs one attribute load
    and one no-op call."""

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0, capacity=1)

    def record(self, name, cat="3pc", node="", key=None, dur=None,
               args=None, ts=None) -> None:
        pass

    @contextmanager
    def span(self, name, cat="dispatch", node="", args=None):
        yield

    def trigger_dump(self, reason, node="", args=None) -> dict:
        return {"reason": reason, "ts": 0.0, "seq": 0, "events": []}


NULL_TRACE = NullTraceRecorder()


# ----------------------------------------------------------------------
# serialization
# ----------------------------------------------------------------------


def events_to_jsonl(events: List[Dict[str, Any]]) -> str:
    """One sorted-key JSON object per line: the canonical dump format
    (byte-stable for identical event sequences)."""
    return "".join(
        json.dumps(ev, sort_keys=True, separators=(",", ":")) + "\n"
        for ev in events)


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over a SORTED sample list (deterministic:
    no interpolation)."""
    if not samples:
        return 0.0
    rank = max(1, -(-len(samples) * q // 100))  # ceil without floats
    return samples[int(rank) - 1]
