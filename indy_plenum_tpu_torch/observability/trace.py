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
journeys use, of its phase analytics (``phase_durations``,
``phase_percentiles``), which the RBFT monitor's snapshot reports, and of
its dump analytics: the critical path per ordered batch
(:func:`critical_path`), the per-tick host/device overlap and
readback-bytes report (:func:`overlap_report`), the telemetry plane's
windowed rollups (:func:`rollup_report`) and the Chrome trace-event export
(:func:`to_chrome_trace`, loadable in Perfetto). They are pure host
functions over event lists.
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


# breakdown phases only (no overlapping total) — critical-path shares
# must sum to ~1.0 over an ordered batch's life
_BREAKDOWN = ("prepare", "commit", "order", "execute")


def critical_path(events: List[Dict[str, Any]],
                  node: Optional[str] = None) -> Dict[str, Any]:
    """Per ordered batch: which phase dominated its latency. Returns
    ``batches`` (groups with a complete breakdown), ``dominant`` (phase
    -> how many batches it dominated) and ``phase_share`` (phase ->
    fraction of total attributed time pool-wide)."""
    dominant: Dict[str, int] = {}
    totals: Dict[str, float] = {}
    batches = 0
    for (_node, _key), marks in sorted(
            _mark_times(events, "3pc",
                        None if node is None
                        else frozenset((node,))).items()):
        if "3pc.preprepare" not in marks \
                and "3pc.preprepare_sent" in marks:
            marks["3pc.preprepare"] = marks["3pc.preprepare_sent"]
        durs = {}
        for phase, start, end in PHASES:
            if phase in _BREAKDOWN and start in marks and end in marks:
                durs[phase] = marks[end] - marks[start]
        if not durs:
            continue
        batches += 1
        # ties break on canonical phase order (deterministic)
        top, top_d = None, float("-inf")
        for phase in _BREAKDOWN:
            if phase in durs and durs[phase] > top_d:
                top, top_d = phase, durs[phase]
        dominant[top] = dominant.get(top, 0) + 1
        for phase, d in durs.items():
            totals[phase] = totals.get(phase, 0.0) + d
    whole = sum(totals.values())
    return {
        "batches": batches,
        "dominant": {p: dominant[p] for p in _BREAKDOWN if p in dominant},
        "phase_share": {p: round(totals[p] / whole, 4)
                        for p in _BREAKDOWN if p in totals} if whole
        else {},
    }


def overlap_report(events: List[Dict[str, Any]],
                   node: Optional[str] = None) -> Dict[str, Any]:
    """Per-tick host/device overlap + readback-bytes attribution (the
    ordering fast path's measured story — ``trace_tool.py --overlap``).

    A tick's dispatch events arrive in ring order as ``tick.drain``,
    ``flush.dispatch``*, ``flush.readback``, ``tick.flush``,
    ``tick.governor``, ``tick.eval`` — the report closes a tick at each
    ``tick.flush`` mark and joins the trailing eval/governor marks to
    it. ``overlapped`` on a ``flush.readback`` means the absorb consumed
    a step DISPATCHED by an earlier flush call: its device round-trip
    hid behind at least one full tick of host work (the pipelined
    contract). ``readback_bytes`` is what actually crossed the
    device->host boundary — O(newly certified + frontier) in device
    eval, the full event matrix under host_eval.

    Mesh runs (the scale-out quorum fabric) additionally carry per-shard
    columns: ``flush.readback`` events are per member shard (``shard``
    arg) and ``flush.dispatch`` splits its votes per occupancy-grid cell
    (``shard_votes``), so the ``per_shard`` block — readback bytes per
    member shard, votes/share per cell — makes a hot shard visible from
    a trace dump alone.

    Multi-tick residency runs stage votes with ``flush.enqueue`` spans
    (these carry the votes/shard_votes; the fused ``flush.dispatch``
    then covers several ticks via its ``ticks`` arg) and record
    ``flush.defer`` when a tick ends with the ring still accumulating.
    Such traces grow per-tick ``enqueues``/``resident_ticks``/
    ``deferred`` columns plus a ``residency`` summary; traces with no
    resident events are byte-identical to before. ``rebalance.planned``
    / ``rebalance.executed`` records surface as a ``rebalances`` block
    with their marks."""
    ticks: List[Dict[str, Any]] = []
    cur = {"dispatches": 0, "votes": 0, "readbacks": 0, "overlapped": 0,
           "readback_bytes": 0}
    rcur = {"enqueues": 0, "resident_ticks": 0, "deferred": 0}
    resident_seen = False
    rtotals = {"enqueues": 0, "resident_ticks_total": 0,
               "readbacks_deferred": 0}
    rebalance_marks: List[Dict[str, Any]] = []
    rebalances_executed = 0
    shard_bytes: Dict[int, int] = {}
    shard_readbacks: Dict[int, int] = {}
    cell_votes: List[int] = []
    # per-shard data stages per tick and commits at tick.flush, so the
    # per_shard block covers exactly the same closed-tick window as the
    # totals (a trailing partial tick is dropped from BOTH views)
    pend_shard_bytes: Dict[int, int] = {}
    pend_shard_readbacks: Dict[int, int] = {}
    pend_cell_votes: List[int] = []
    for ev in events:
        if ev.get("cat") != "dispatch":
            continue
        if node is not None and ev.get("node", "") not in (node, ""):
            continue
        name, args = ev["name"], ev.get("args") or {}
        if name == "flush.dispatch":
            cur["dispatches"] += 1
            cur["votes"] += args.get("votes", 0)
            if "resident" in args:
                resident_seen = True
                rcur["resident_ticks"] += args.get("ticks", 0)
                rtotals["resident_ticks_total"] += args.get("ticks", 0)
            sv = args.get("shard_votes")
            if sv:
                if len(pend_cell_votes) < len(sv):
                    pend_cell_votes.extend(
                        [0] * (len(sv) - len(pend_cell_votes)))
                for ci, v in enumerate(sv):
                    pend_cell_votes[ci] += v
        elif name == "flush.enqueue":
            # resident staging: votes counted HERE (the fused dispatch
            # carries none, so totals stay single-counted)
            resident_seen = True
            rcur["enqueues"] += 1
            rtotals["enqueues"] += 1
            cur["votes"] += args.get("votes", 0)
            sv = args.get("shard_votes")
            if sv:
                if len(pend_cell_votes) < len(sv):
                    pend_cell_votes.extend(
                        [0] * (len(sv) - len(pend_cell_votes)))
                for ci, v in enumerate(sv):
                    pend_cell_votes[ci] += v
        elif name == "flush.defer":
            resident_seen = True
            rcur["deferred"] += 1
            rtotals["readbacks_deferred"] += 1
        elif name in ("rebalance.planned", "rebalance.executed"):
            rebalance_marks.append({"name": name, "ts": ev["ts"],
                                    "args": dict(args)})
            if name == "rebalance.executed":
                rebalances_executed += 1
        elif name == "flush.readback":
            cur["readbacks"] += 1
            cur["readback_bytes"] += args.get("bytes", 0)
            if args.get("overlapped"):
                cur["overlapped"] += 1
            shard = args.get("shard")
            if shard is not None:
                pend_shard_bytes[shard] = (pend_shard_bytes.get(shard, 0)
                                           + args.get("bytes", 0))
                pend_shard_readbacks[shard] = \
                    pend_shard_readbacks.get(shard, 0) + 1
        elif name == "tick.flush":
            cur["ts"] = ev["ts"]
            if resident_seen:
                cur.update(rcur)
            ticks.append(cur)
            cur = {"dispatches": 0, "votes": 0, "readbacks": 0,
                   "overlapped": 0, "readback_bytes": 0}
            rcur = {"enqueues": 0, "resident_ticks": 0, "deferred": 0}
            for s, b in pend_shard_bytes.items():
                shard_bytes[s] = shard_bytes.get(s, 0) + b
            for s, n in pend_shard_readbacks.items():
                shard_readbacks[s] = shard_readbacks.get(s, 0) + n
            if len(cell_votes) < len(pend_cell_votes):
                cell_votes.extend(
                    [0] * (len(pend_cell_votes) - len(cell_votes)))
            for ci, v in enumerate(pend_cell_votes):
                cell_votes[ci] += v
            pend_shard_bytes = {}
            pend_shard_readbacks = {}
            pend_cell_votes = []
    byte_series = sorted(t["readback_bytes"] for t in ticks)
    readbacks = sum(t["readbacks"] for t in ticks)
    overlapped = sum(t["overlapped"] for t in ticks)
    out = {
        "ticks": len(ticks),
        "readbacks": readbacks,
        # host/device overlap fraction: readbacks whose round-trip hid
        # behind a full tick of host work / all readbacks
        "overlap_fraction": (round(overlapped / readbacks, 4)
                             if readbacks else 0.0),
        "readback_bytes_total": sum(byte_series),
        "readback_bytes_per_tick": {
            "p50": percentile(byte_series, 50),
            "max": byte_series[-1] if byte_series else 0,
        },
        "per_tick": ticks,
    }
    if resident_seen:
        out["residency"] = dict(rtotals)
    if rebalance_marks:
        out["rebalances"] = {"executed": rebalances_executed,
                             "marks": rebalance_marks}
    if shard_bytes or cell_votes:
        n_shards = max([s + 1 for s in shard_bytes] or [0])
        total_votes = sum(cell_votes)
        out["per_shard"] = {
            # member shards: what each shard's compact blocks cost to
            # read back (and how many blocks absorbed)
            "readback_bytes": [shard_bytes.get(s, 0)
                               for s in range(n_shards)],
            "readbacks": [shard_readbacks.get(s, 0)
                          for s in range(n_shards)],
            # occupancy-grid cells (member block x validator block,
            # flattened): each cell's vote count and share — the
            # dump-local analog of VotePlaneGroup.shard_occupancy
            "votes": list(cell_votes),
            "vote_share": [round(v / total_votes, 4) if total_votes
                           else 0.0 for v in cell_votes],
        }
    return out


def rollup_report(events: List[Dict[str, Any]],
                  node: Optional[str] = None) -> Dict[str, Any]:
    """The telemetry plane's windowed-rollup view from a flight dump
    alone (``trace_tool.py --rollups`` — the long-horizon sibling of
    ``--overlap``).

    An armed plane records one ``telemetry.roll`` mark per rolled
    window (ordered/shed/retry deltas, window p99, summed and largest
    per-resource high-water) and a ``flight.telemetry.<law>`` mark per
    fired anomaly (the drift detector's ``trigger_dump``). The report
    rebuilds the per-window table, joins each anomaly to its window,
    and totals anomalies per law — so a dump from a soak run answers
    "when did throughput drift, and what was growing" without the
    run's in-memory plane."""
    rows: List[Dict[str, Any]] = []
    by_window: Dict[int, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("name") != "telemetry.roll":
            continue
        if node is not None and ev.get("node", "") not in ("", node):
            continue
        row = dict(ev.get("args") or {})
        row["ts"] = ev.get("ts")
        row["anomalies"] = []
        rows.append(row)
        if row.get("window") is not None:
            by_window[int(row["window"])] = row
    anomalies: List[Dict[str, Any]] = []
    by_law: Dict[str, int] = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") != "flight" \
                or not name.startswith("flight.telemetry."):
            continue
        law = name[len("flight.telemetry."):]
        rec = dict(ev.get("args") or {})
        rec["law"] = law
        rec["ts"] = ev.get("ts")
        anomalies.append(rec)
        by_law[law] = by_law.get(law, 0) + 1
        w = rec.get("window")
        if w is not None and int(w) in by_window:
            by_window[int(w)]["anomalies"].append(law)
    ordered = [r.get("ordered") or 0 for r in rows]
    return {
        "windows": len(rows),
        "ordered_total": sum(ordered),
        "ordered_min": min(ordered) if ordered else 0,
        "ordered_max": max(ordered) if ordered else 0,
        "anomaly_count": len(anomalies),
        "anomalies_by_law": dict(sorted(by_law.items())),
        "anomalies": anomalies,
        "per_window": rows,
    }


# ----------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ----------------------------------------------------------------------

def to_chrome_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON: one pid per node (pool-level events ride
    pid "pool"), one tid per category; spans (events with ``dur``) become
    complete "X" events, marks become instant "i" events. Timestamps are
    microseconds per the format spec.

    Transport marks (cat ``net``, the causal tracing plane) additionally
    emit **flow events**: each matched ``net.send``/``net.recv`` pair
    becomes an "s"/"f" flow arc between the sender's and receiver's
    pids, so a request's PROPAGATE/3PC journey renders as arrows hopping
    across node tracks in Perfetto."""
    nodes = sorted({ev.get("node", "") for ev in events})
    cats = sorted({ev.get("cat", "") for ev in events})
    pid_of = {n: i + 1 for i, n in enumerate(nodes)}
    tid_of = {c: i + 1 for i, c in enumerate(cats)}
    out: List[Dict[str, Any]] = []
    for n in nodes:
        out.append({"ph": "M", "name": "process_name", "pid": pid_of[n],
                    "tid": 0, "args": {"name": n or "pool"}})
    for c in cats:
        for n in nodes:
            out.append({"ph": "M", "name": "thread_name",
                        "pid": pid_of[n], "tid": tid_of[c],
                        "args": {"name": c}})
    t0 = min((ev["ts"] for ev in events), default=0.0)
    for ev in events:
        args = dict(ev.get("args") or {})
        if ev.get("key") is not None:
            args["key"] = list(ev["key"])
        rec: Dict[str, Any] = {
            "name": ev["name"],
            "cat": ev.get("cat", ""),
            "pid": pid_of[ev.get("node", "")],
            "tid": tid_of[ev.get("cat", "")],
            "ts": round((ev["ts"] - t0) * 1e6, 3),
        }
        if args:
            rec["args"] = args
        is_net_mark = (ev.get("cat") == "net"
                       and ev["name"] in ("net.send", "net.recv"))
        # cross-lane checkpoint barrier (ordering lanes): each lane's
        # readiness mark flows into the seal mark, so Perfetto draws the
        # K-way barrier join as arrows converging on barrier.sealed
        is_barrier_mark = (ev.get("cat") == "lanes"
                           and ev["name"] in ("barrier.ready",
                                              "barrier.sealed"))
        if ev.get("dur") is not None:
            rec["ph"] = "X"
            rec["dur"] = round(ev["dur"] * 1e6, 3)
        elif is_net_mark or is_barrier_mark:
            # flow ends must bind to an ENCLOSING duration slice per the
            # trace-event spec — an instant can't anchor an arrow — so
            # transport marks render as 1µs slices
            rec["ph"] = "X"
            rec["dur"] = 1.0
        else:
            rec["ph"] = "i"
            rec["s"] = "p"
        out.append(rec)
        # flow arcs: a send/recv pair shares args["id"]; the send is the
        # flow start ("s") on the sender's pid, the recv binds the end
        # ("f", enclosing slice) on the receiver's — Perfetto draws the
        # cross-node arrow
        if is_net_mark:
            flow_id = (ev.get("args") or {}).get("id")
            if flow_id is not None:
                out.append({
                    "ph": "s" if ev["name"] == "net.send" else "f",
                    "bp": "e",
                    "id": str(flow_id),
                    "name": "net." + str((ev.get("args") or {})
                                         .get("m", "msg")),
                    "cat": "net",
                    "pid": rec["pid"],
                    "tid": rec["tid"],
                    "ts": rec["ts"],
                })
        elif is_barrier_mark and ev.get("key"):
            window = ev["key"][0]
            bargs = ev.get("args") or {}
            if ev["name"] == "barrier.ready":
                flow_ids = ["barrier-%s-%s" % (window, bargs.get("lane"))]
            else:
                # sealed: close one arc per lane that actually emitted a
                # readiness mark for this window — idle/skipped lanes
                # have no flow start, and a dangling end renders broken
                ready = bargs.get("ready_lanes")
                if ready is None:  # older dumps: best-effort all lanes
                    ready = range(int(bargs.get("lanes", 0)))
                flow_ids = ["barrier-%s-%s" % (window, lane)
                            for lane in ready]
            for fid in flow_ids:
                out.append({
                    "ph": "s" if ev["name"] == "barrier.ready" else "f",
                    "bp": "e",
                    "id": fid,
                    "name": "barrier.window",
                    "cat": "lanes",
                    "pid": rec["pid"],
                    "tid": rec["tid"],
                    "ts": rec["ts"],
                })
    return {"traceEvents": out, "displayTimeUnit": "ms"}
