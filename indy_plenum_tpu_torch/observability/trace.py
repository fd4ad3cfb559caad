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
(``TraceRecorder``, ``NullTraceRecorder``, ``LaneTraceView``, the JSONL
dump format), of its nearest-rank ``percentile``, which the causal
journeys use, and of its phase analytics (``phase_durations``,
``phase_percentiles``), which the RBFT monitor's snapshot reports. The
other dump analytics (critical path, overlap and rollup reports, Chrome
trace export) are not part of the port yet.
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

# canonical 3PC phase chain: each phase is the delta between two
# lifecycle marks for the same (node, key) group. ``commit_quorum`` is
# recorded when the service OBSERVES the quorum (in tick mode that is
# the tick instant), so ``order`` captures only the in-order delivery
# wait on top of it.
PHASES: Tuple[Tuple[str, str, str], ...] = (
    ("prepare", "3pc.preprepare", "3pc.prepare_quorum"),
    ("commit", "3pc.prepare_quorum", "3pc.commit_quorum"),
    ("order", "3pc.commit_quorum", "3pc.ordered"),
    ("execute", "3pc.ordered", "3pc.executed"),
    ("total_3pc", "3pc.preprepare", "3pc.executed"),
)
AUTH_PHASE = ("auth", "req.ingress", "req.finalised")
# state-proof plane: a checkpoint boundary batch's ordering → its
# window's pool proof becoming servable (CheckpointProofCache capture).
# Joined per node on (view_no, seq_no_end) — the window key IS the
# boundary batch's (view, pp_seq), so the sample measures exactly the
# stabilization wait a proved read pays before a root is servable.
PROOF_PHASE = ("proof", "3pc.ordered", "proof.window_signed")
# catchup plane: a leecher round's full recovery arc, joined per
# (node, round ordinal) — how long a lagging node took from detecting
# the gap to rejoining 3PC with every leeched batch proof-verified
# (``catchup.txns_leeched`` marks ride the same category, un-keyed).
CATCHUP_PHASE = ("catchup", "catchup.started", "catchup.completed")
# state-commit plane: a batch's execution (commit_batch returning its
# staged record) → its state root durably advanced (the executed→proof
# hop's first half). Joined per node on (view_no, pp_seq_no) — the
# ``state.commit`` mark also carries the node's cumulative tree-hash
# meter, so a dump shows hash cost alongside the latency chain.
STATE_PHASE = ("state_commit", "3pc.executed", "state.commit")


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

    def sized_resources(self, prefix: str = "trace."):
        """Resource-ledger registration (observability.telemetry): the
        ring and the flight-dump deque are the recorder's two bounded
        stores."""
        from .telemetry import SizedResource

        return (
            SizedResource(prefix + "ring", lambda: len(self._events),
                          bound=self._events.maxlen, entry_bytes=120,
                          ring=True),
            SizedResource(prefix + "dumps", lambda: len(self.dumps),
                          bound=self.dumps.maxlen, entry_bytes=16384,
                          ring=True),
        )


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


class LaneTraceView:
    """A lane's view onto the pool-shared recorder (ordering lanes).

    Every event recorded through the view carries ``args["lane"]``, so
    one merged dump still attributes each mark — request lifecycle, 3PC
    waves, net send/recv — to the ordering lane that produced it (the
    causal plane keys its wave joins on it: two lanes both at
    ``(view 0, seq 5)`` must never cross-pollute each other's latency
    samples). Everything else (ring, clock, dumps, journey-rollup cache)
    delegates to the wrapped recorder, so ``trace_hash``/``to_jsonl``
    cover the whole pool regardless of which view a caller holds."""

    def __init__(self, base: TraceRecorder, lane: int):
        self._base = base
        self.lane = lane
        self.enabled = base.enabled

    def _tag(self, args: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        tagged = {"lane": self.lane}
        if args:
            tagged.update(args)
        return tagged

    def record(self, name: str, cat: str = "3pc", node: str = "",
               key: Optional[Sequence] = None, dur: Optional[float] = None,
               args: Optional[Dict[str, Any]] = None,
               ts: Optional[float] = None) -> None:
        self._base.record(name, cat=cat, node=node, key=key, dur=dur,
                          args=self._tag(args), ts=ts)

    def span(self, name: str, cat: str = "dispatch", node: str = "",
             args: Optional[Dict[str, Any]] = None):
        return self._base.span(name, cat=cat, node=node,
                               args=self._tag(args))

    def trigger_dump(self, reason: str, node: str = "",
                     args: Optional[Dict[str, Any]] = None) -> dict:
        return self._base.trigger_dump(reason, node=node,
                                       args=self._tag(args))

    def __getattr__(self, item):
        return getattr(self._base, item)



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


# ----------------------------------------------------------------------
# phase analytics
# ----------------------------------------------------------------------

def _mark_times(events: List[Dict[str, Any]], cat: str,
                nodes: Optional[frozenset]
                ) -> Dict[tuple, Dict[str, float]]:
    """(node, key) -> {mark name -> earliest ts} for one category;
    ``nodes`` filters to that set (None = every node)."""
    groups: Dict[tuple, Dict[str, float]] = {}
    for ev in events:
        if ev.get("cat") != cat or ev.get("key") is None:
            continue
        ev_node = ev.get("node", "")
        if nodes is not None and ev_node not in nodes:
            continue
        marks = groups.setdefault((ev_node, tuple(ev["key"])), {})
        name = ev["name"]
        if name not in marks or ev["ts"] < marks[name]:
            marks[name] = ev["ts"]
    return groups


def phase_durations(events: List[Dict[str, Any]],
                    node: Optional[str] = None) -> Dict[str, List[float]]:
    """Per-phase duration samples from lifecycle marks. ``node=None``
    aggregates every node's samples (request marks recorded pool-level
    under node ``""`` are always included — the auth phase is a pool
    observation, not a per-replica one)."""
    out: Dict[str, List[float]] = {}
    for (_node, _key), marks in sorted(
            _mark_times(events, "3pc",
                        None if node is None
                        else frozenset((node,))).items()):
        # the primary's own batch has no applied mark; its send mark is
        # the honest phase start
        if "3pc.preprepare" not in marks \
                and "3pc.preprepare_sent" in marks:
            marks["3pc.preprepare"] = marks["3pc.preprepare_sent"]
        for phase, start, end in PHASES:
            if start in marks and end in marks:
                out.setdefault(phase, []).append(
                    marks[end] - marks[start])
    # auth phase: ingress happens on whichever node the client hit (or
    # pool-level under node ""), finalisation on EVERY node — so the
    # join runs per request digest across nodes: earliest ingress
    # anywhere → earliest finalisation on the filtered node
    ingress_ts: Dict[tuple, float] = {}
    finalised_ts: Dict[tuple, float] = {}
    for ev in events:
        if ev.get("cat") != "req" or ev.get("key") is None:
            continue
        k = tuple(ev["key"])
        if ev["name"] == AUTH_PHASE[1]:
            if k not in ingress_ts or ev["ts"] < ingress_ts[k]:
                ingress_ts[k] = ev["ts"]
        elif ev["name"] == AUTH_PHASE[2]:
            if node is not None and ev.get("node", "") not in (node, ""):
                continue
            if k not in finalised_ts or ev["ts"] < finalised_ts[k]:
                finalised_ts[k] = ev["ts"]
    for k in sorted(finalised_ts):
        if k in ingress_ts:
            out.setdefault(AUTH_PHASE[0], []).append(
                finalised_ts[k] - ingress_ts[k])
    # proof phase: per node, each proof.window_signed (key (view, seq))
    # joins the SAME node's earliest 3pc.ordered mark for the boundary
    # batch (key (view, seq, digest)) — the stabilization wait between
    # a window's last batch ordering and its pool proof being servable
    ordered_at: Dict[tuple, float] = {}
    for ev in events:
        if ev.get("cat") != "3pc" or ev["name"] != PROOF_PHASE[1] \
                or ev.get("key") is None or len(ev["key"]) < 2:
            continue
        if node is not None and ev.get("node", "") != node:
            continue
        k = (ev.get("node", ""), ev["key"][0], ev["key"][1])
        if k not in ordered_at or ev["ts"] < ordered_at[k]:
            ordered_at[k] = ev["ts"]
    for ev in events:
        if ev.get("cat") != "proof" or ev["name"] != PROOF_PHASE[2] \
                or ev.get("key") is None or len(ev["key"]) < 2:
            continue
        if node is not None and ev.get("node", "") != node:
            continue
        t0 = ordered_at.get(
            (ev.get("node", ""), ev["key"][0], ev["key"][1]))
        if t0 is not None:
            out.setdefault(PROOF_PHASE[0], []).append(ev["ts"] - t0)
    # state-commit phase: per node, each state.commit (key (view, seq))
    # joins the SAME node's earliest 3pc.executed mark for that batch
    # (key (view, seq, digest)) — how long after execution the state
    # root was durably advanced (same cross-category join as the proof
    # phase above)
    executed_at: Dict[tuple, float] = {}
    for ev in events:
        if ev.get("cat") != "3pc" or ev["name"] != STATE_PHASE[1] \
                or ev.get("key") is None or len(ev["key"]) < 2:
            continue
        if node is not None and ev.get("node", "") != node:
            continue
        k = (ev.get("node", ""), ev["key"][0], ev["key"][1])
        if k not in executed_at or ev["ts"] < executed_at[k]:
            executed_at[k] = ev["ts"]
    for ev in events:
        if ev.get("cat") != "state" or ev["name"] != STATE_PHASE[2] \
                or ev.get("key") is None or len(ev["key"]) < 2:
            continue
        if node is not None and ev.get("node", "") != node:
            continue
        t0 = executed_at.get(
            (ev.get("node", ""), ev["key"][0], ev["key"][1]))
        if t0 is not None:
            out.setdefault(STATE_PHASE[0], []).append(ev["ts"] - t0)
    # catchup phase: each leecher round's started -> completed arc,
    # joined per (node, round ordinal) like the 3PC lifecycle marks
    for (_node, _key), marks in sorted(
            _mark_times(events, "catchup",
                        None if node is None
                        else frozenset((node,))).items()):
        if CATCHUP_PHASE[1] in marks and CATCHUP_PHASE[2] in marks:
            out.setdefault(CATCHUP_PHASE[0], []).append(
                marks[CATCHUP_PHASE[2]] - marks[CATCHUP_PHASE[1]])
    return out


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over a SORTED sample list (deterministic:
    no interpolation)."""
    if not samples:
        return 0.0
    rank = max(1, -(-len(samples) * q // 100))  # ceil without floats
    return samples[int(rank) - 1]


def phase_percentiles(events: List[Dict[str, Any]],
                      node: Optional[str] = None,
                      ndigits: int = 6) -> Dict[str, Dict[str, float]]:
    """{phase: {count, p50, p90, p99, max}} — the ``phase_latency``
    block every surface reports (Monitor.snapshot, profile_rbft --json,
    bench ordered sub-benches, trace_tool)."""
    out: Dict[str, Dict[str, float]] = {}
    for phase, samples in phase_durations(events, node=node).items():
        s = sorted(samples)
        out[phase] = {
            "count": len(s),
            "p50": round(percentile(s, 50), ndigits),
            "p90": round(percentile(s, 90), ndigits),
            "p99": round(percentile(s, 99), ndigits),
            "max": round(s[-1], ndigits),
        }
    return out
