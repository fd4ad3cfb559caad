"""Causal request journeys: cross-node joins over flight-recorder dumps.

RBFT judges the master instance on *observed* end-to-end latency (Aublin
et al., ICDCS 2013), but the flight recorder's per-node timelines
(:mod:`.trace`) only let phase analytics join request phases
heuristically.  This module is the ground-truth layer: it reconstructs
each request's full **journey** across the pool — client ingress →
admission wait → auth batch → PROPAGATE fan-out → PRE-PREPARE / PREPARE
/ COMMIT → ordered → executed (→ window proof) — from the SAME JSONL
dumps, joining per-node lifecycle marks with the transport-level
``net.send``/``net.recv`` marks both transports stamp
(:class:`~indy_plenum_tpu_torch.simulation.sim_network.SimNetwork` on the
virtual clock; the reference's deployed ``ZStack`` by piggybacking a
``~trc`` context on the serialized envelope).

Determinism contract (the ``latency_gate``): journeys are a pure
function of the event list, the trace context is a pure function of the
request digest (:func:`trace_id`) and span ids a pure function of
``(trace_id, node, hop)`` (:func:`span_id`) — so a seeded virtual-clock
run produces a byte-identical journey table, fingerprinted by
:func:`journey_hash` exactly like ``ordered_hash``/``trace_hash``.

Attribution semantics (per hop, deterministic by construction):

- **network** — min(hop duration, median in-flight latency of the
  message wave that closes the hop), from matched send/recv marks;
- **compute** — the auth device batch and execution hops;
- **device** — the dispatch-tick quantization wait (commit-quorum
  observation → in-order delivery) when the dump shows a tick-batched
  dispatch plane (``tick.flush`` marks present), else it folds into
- **queue** — everything else: admission wait, batching wait, and each
  hop's residual after its network share.

Copy of ``indy_plenum_tpu/observability/causal.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .trace import events_to_jsonl, percentile

# message types whose deliveries the transports stamp with
# ``net.send``/``net.recv`` marks (cat ``net``). Key shapes join the
# lifecycle marks: 3PC waves by (viewNo, ppSeqNo) — master instance
# only, backups don't trace — PROPAGATE by the "identifier|reqId" pair
# the ingress mark carries (the wire never sees the digest), catchup
# slices by ledger id.
NET_TRACED_OPS = ("PROPAGATE", "PREPREPARE", "PREPARE", "COMMIT",
                  "CATCHUP_REQ", "CATCHUP_REP")


def net_join_key(op: str, get: Callable[[str], Any]) -> Optional[tuple]:
    """The journey-joinable key for one wire message (``get`` reads a
    field off the message object or its dict form). None = untraced."""
    if op == "PROPAGATE":
        req = get("request") or {}
        if not isinstance(req, dict):
            return None
        return ("%s|%s" % (req.get("identifier"), req.get("reqId")),)
    if op in ("PREPREPARE", "PREPARE", "COMMIT"):
        if get("instId"):
            return None  # only the master instance executes / is judged
        return (get("viewNo"), get("ppSeqNo"))
    if op in ("CATCHUP_REQ", "CATCHUP_REP"):
        return (get("ledgerId"),)
    return None


def trace_id(digest: str) -> str:
    """The request's deterministic trace context: derived from the
    digest every honest node independently computes — no allocator, no
    coordination, identical across the pool by construction."""
    return hashlib.sha256(b"journey|" + digest.encode()).hexdigest()[:16]


def span_id(tid: str, node: str, hop: str) -> str:
    """Span identity as a pure function of (trace_id, node, hop): two
    nodes (or two runs) derive the identical id for the same hop."""
    return hashlib.sha256(
        ("%s|%s|%s" % (tid, node, hop)).encode()).hexdigest()[:16]


def merge_events(*event_lists: Sequence[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Merge N per-node dumps into one deterministic timeline. Within a
    pool-shared dump the ring order is already causal; across dumps the
    only shared clock is the timestamp, so ties break on (node, cat,
    name, seq) — a pure function of the inputs."""
    merged = [ev for evs in event_lists for ev in evs]
    merged.sort(key=lambda ev: (ev["ts"], ev.get("node", ""),
                                ev.get("cat", ""), ev["name"],
                                ev.get("seq", 0)))
    return merged


# ----------------------------------------------------------------------
# extraction
# ----------------------------------------------------------------------

def _r(x: Optional[float]) -> Optional[float]:
    return None if x is None else round(x, 9)


def _earliest(d: Dict, k, ts: float) -> None:
    if k not in d or ts < d[k]:
        d[k] = ts


class _Extract:
    """One pass over the merged event list; everything journeys need."""

    _LIFECYCLE = ("3pc.preprepare_sent", "3pc.preprepare",
                  "3pc.prepare_quorum", "3pc.commit_quorum",
                  "3pc.ordered", "3pc.executed")

    def __init__(self, events: List[Dict[str, Any]]):
        self.req: Dict[str, Dict[str, float]] = {}   # digest -> marks
        self.rid_of: Dict[str, str] = {}             # digest -> ident|reqId
        # closed-loop retry (overload robustness plane): re-offer count
        # per digest — the retry hop spans from the first shed to the
        # eventual admission (``marks`` carries both instants)
        self.retry_count: Dict[str, int] = {}
        # ordering lanes: every mark a laned pool records carries
        # args["lane"] (LaneTraceView), and the cross-lane barrier
        # stamps barrier.ready/barrier.sealed marks (cat "lanes") —
        # net-wave joins key on the lane so two lanes both at
        # (view 0, seq 5) never cross-pollute, and the seal instant
        # becomes each journey's "barrier" hop
        self.req_lane: Dict[str, int] = {}           # digest -> lane
        # geo plane: marks submitted with a home region carry
        # args["region"] — journeys inherit it (mirrors lane), and the
        # read FIFO pairs it through so read e2e segregates per region
        self.req_region: Dict[str, int] = {}         # digest -> region
        self.read_e2e_by_region: Dict[int, List[float]] = {}
        self._barrier_ready: Dict[tuple, int] = {}   # (lane, win) -> seq
        self.barrier_sealed: Dict[int, float] = {}   # window -> seal ts
        # batch digest -> {"keys": set[(v, s)], "reqIdr": [...],
        #                  "marks": {name: earliest ts},
        #                  "executed_by": set[node]}
        self.batches: Dict[str, Dict[str, Any]] = {}
        self.net: Dict[tuple, List[float]] = {}      # (op, key) -> lats
        self.net_drops: Dict[tuple, int] = {}
        self._send_at: Dict[Any, Tuple[float, str, tuple]] = {}
        self.catchup: Dict[str, List[Tuple[float, float]]] = {}
        self._catchup_open: Dict[tuple, float] = {}
        self.proof_at: Dict[tuple, float] = {}       # (view, seq) -> ts
        self.tick_mode = False
        self.read_e2e: List[float] = []
        # read FIFO windows are PER SERVICE (the mark's node field):
        # two ReadServices sharing a recorder — or N merged per-node
        # dumps — must never cross-pair each other's reads
        self._read_pending: Dict[str, List[float]] = {}
        self.fault_windows: List[Tuple[float, float]] = []
        self._fault_open: Dict[str, float] = {}
        for ev in events:
            self._feed(ev)
        # unclosed fault windows extend to the end of the dump
        if self._fault_open and events:
            end = max(ev["ts"] for ev in events)
            for t0 in self._fault_open.values():
                self.fault_windows.append((t0, end))
        self.fault_windows.sort()

    def _feed(self, ev: Dict[str, Any]) -> None:
        cat, name, ts = ev.get("cat", ""), ev["name"], ev["ts"]
        key = ev.get("key")
        args = ev.get("args") or {}
        if cat == "req" and key:
            marks = self.req.setdefault(key[0], {})
            _earliest(marks, name, ts)
            if name == "req.ingress" and args.get("rid"):
                self.rid_of[key[0]] = args["rid"]
            if name == "req.retry":
                self.retry_count[key[0]] = \
                    self.retry_count.get(key[0], 0) + 1
            if "lane" in args and key[0] not in self.req_lane:
                self.req_lane[key[0]] = args["lane"]
            if "region" in args and key[0] not in self.req_region:
                self.req_region[key[0]] = args["region"]
        elif cat == "3pc" and key and len(key) >= 3 \
                and name in self._LIFECYCLE:
            b = self.batches.setdefault(
                key[2], {"keys": set(), "reqIdr": None, "marks": {},
                         "executed_by": set(), "lane": None})
            b["keys"].add((key[0], key[1]))
            _earliest(b["marks"], name, ts)
            if name == "3pc.executed":
                b["executed_by"].add(ev.get("node", ""))
            if args.get("reqIdr") and b["reqIdr"] is None:
                b["reqIdr"] = list(args["reqIdr"])
            if "lane" in args and b["lane"] is None:
                b["lane"] = args["lane"]
        elif cat == "lanes" and key:
            if name == "barrier.ready" and args.get("seq") is not None:
                rkey = (args.get("lane"), key[0])
                if rkey not in self._barrier_ready:
                    self._barrier_ready[rkey] = args["seq"]
            elif name == "barrier.sealed":
                _earliest(self.barrier_sealed, key[0], ts)
        elif cat == "net":
            op, nid = args.get("m"), args.get("id")
            lane = args.get("lane")
            # ids are per-network sequences and each lane runs its own
            # network, so the send/recv join MUST key on (lane, id) —
            # bare ids collide across lanes in a merged laned dump
            if name == "net.send":
                self._send_at[(lane, nid)] = (
                    ts, op, (lane,) + tuple(key or ()))
            elif name == "net.recv":
                sent = self._send_at.pop((lane, nid), None)
                if sent is not None:
                    lat = ts - sent[0]
                    if lat >= 0.0:
                        self.net.setdefault((op, sent[2]), []).append(lat)
                elif args.get("sent") is not None:
                    # cross-process dump (ZStack): the context carries
                    # the SENDER's clock reading. perf_counter epochs
                    # are process-local, so this only yields a usable
                    # sample when both processes share a timebase (same
                    # host); negative/implausible deltas from unrelated
                    # clocks are dropped rather than poisoning the
                    # attribution
                    lat = ts - args["sent"]
                    if lat >= 0.0:
                        self.net.setdefault(
                            (op, (lane,) + tuple(key or ())),
                            []).append(lat)
            elif name == "net.drop":
                k = (op, (lane,) + tuple(key or ()))
                self.net_drops[k] = self.net_drops.get(k, 0) + 1
        elif cat == "catchup" and key:
            node = ev.get("node", "")
            if name == "catchup.started":
                self._catchup_open[(node, key[0])] = ts
            elif name in ("catchup.completed", "catchup.failed"):
                t0 = self._catchup_open.pop((node, key[0]), ts)
                if name == "catchup.completed":
                    self.catchup.setdefault(node, []).append((t0, ts))
        elif cat == "proof" and name == "proof.window_signed" \
                and key and len(key) >= 2:
            _earliest(self.proof_at, (key[0], key[1]), ts)
        elif cat == "dispatch" and name == "tick.flush":
            self.tick_mode = True
        elif cat == "read":
            svc = ev.get("node", "")
            if name == "read.submitted":
                self._read_pending.setdefault(svc, []).append(
                    (ts, args.get("region")))
            elif name == "read.served":
                n = int(args.get("n", 0))
                pending = self._read_pending.get(svc, [])
                take = pending[:n]
                del pending[:n]
                for t0, region in take:
                    self.read_e2e.append(ts - t0)
                    if region is not None:
                        self.read_e2e_by_region.setdefault(
                            region, []).append(ts - t0)
        elif cat == "chaos":
            if name.startswith("begin "):
                self._fault_open[name[6:]] = ts
            elif name.startswith("end "):
                t0 = self._fault_open.pop(name[4:], None)
                if t0 is not None:
                    self.fault_windows.append((t0, ts))

    def net_median(self, op: str, key: tuple) -> Optional[float]:
        lats = self.net.get((op, key))
        if not lats:
            return None
        return percentile(sorted(lats), 50)

    def barrier_seal_ts(self, lane: Optional[int],
                        seq: int) -> Optional[float]:
        """Seal instant of the cross-lane window covering lane-local
        batch ``seq`` (the smallest window whose boundary reaches it),
        or None when the dump never sealed that far."""
        if lane is None:
            return None
        windows = sorted(
            window for (ready_lane, window), seq_end
            in self._barrier_ready.items()
            if ready_lane == lane and seq_end >= seq)
        if not windows:
            return None
        return self.barrier_sealed.get(windows[0])


# ----------------------------------------------------------------------
# journeys
# ----------------------------------------------------------------------

# hop -> which attribution bucket its residual (after the network share)
# lands in; the ``order`` hop is the dispatch-tick / in-order wait and
# charges to ``device`` when the dump shows a tick-batched plane. The
# ``barrier`` hop (ordering lanes: executed -> the cross-lane seal of
# the batch's checkpoint window) exists only in laned dumps, and the
# ``retry`` hop (overload robustness plane: first shed -> the eventual
# admission of the backoff chain) only for requests the closed loop
# actually retried — both, like ``admission``, are skipped rather than
# counted incomplete when absent.
_HOPS = ("admission", "retry", "auth", "batching", "preprepare",
         "prepare", "commit", "order", "execute", "barrier")
_OPTIONAL_HOPS = ("admission", "retry", "barrier")
_RESIDUAL_OF = {"admission": "queue", "retry": "queue",
                "auth": "compute",
                "batching": "queue", "preprepare": "queue",
                "prepare": "queue", "commit": "queue",
                "order": "queue", "execute": "compute",
                "barrier": "queue"}
_WAVE_OF = {"preprepare": "PREPREPARE", "prepare": "PREPARE",
            "commit": "COMMIT"}


def build_journeys(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reconstruct every request journey from a merged event list.

    Returns ``{"journeys": [...], "pending": [...], "shed": [...],
    "read_e2e": [...], "fault_windows": [...]}`` — one journey per
    request that reached an executed batch, each with per-hop
    network/queue/compute/device attribution, completeness, and the
    catchup annotation (nodes that received it by leeching rather than
    ordering)."""
    return _build_journeys(events)[0]


def _build_journeys(events: List[Dict[str, Any]]
                    ) -> Tuple[Dict[str, Any], "_Extract"]:
    """One extraction pass shared by :func:`build_journeys` and
    :func:`journey_for` (which also needs the raw wave samples)."""
    x = _Extract(events)
    journeys: List[Dict[str, Any]] = []
    ordered_digests = set()
    for bd in sorted(x.batches):
        b = x.batches[bd]
        marks = b["marks"]
        if "3pc.executed" not in marks or not b["reqIdr"]:
            continue
        # the primary's own batch never gets an applied mark (existing
        # phase-analytics convention): its send mark starts the phase
        t_sent = marks.get("3pc.preprepare_sent")
        t_pp = marks.get("3pc.preprepare", t_sent)
        batch_key = min(b["keys"])
        lane = b.get("lane")
        # net-wave samples are keyed (lane, view, seq): an unlaned dump
        # stores lane None on both sides, so the join shape is uniform
        wave_med = {hop: x.net_median(op, (lane,) + batch_key)
                    for hop, op in _WAVE_OF.items()}
        t_ord = marks.get("3pc.ordered")
        t_exe = marks["3pc.executed"]
        t_seal = x.barrier_seal_ts(lane, batch_key[1])
        leeched_by = sorted(
            node for node, rounds in x.catchup.items()
            if node not in b["executed_by"]
            and t_ord is not None
            and any(t1 > t_ord for _t0, t1 in rounds))
        proof_ts = min((x.proof_at[k] for k in b["keys"]
                        if k in x.proof_at), default=None)
        for digest in b["reqIdr"]:
            if digest in ordered_digests:
                continue  # first executed batch wins (VC re-proposal)
            ordered_digests.add(digest)
            rmarks = x.req.get(digest, {})
            t_ing = rmarks.get("req.ingress")
            t_adm = rmarks.get("req.admitted")
            t_fin = rmarks.get("req.finalised")
            # closed-loop retry: a retried-then-ordered request's wait
            # splits at its FIRST shed — admission covers the first
            # attempt, the retry hop the whole backoff chain through to
            # the eventual admission (contiguous, so attribution never
            # double-counts); unretried requests keep the exact
            # pre-overload-plane chain
            t_shed1 = rmarks.get("req.shed")
            retried = digest in x.retry_count \
                and t_shed1 is not None and t_adm is not None
            # hop chain: each entry (t0, t1); None timestamps leave the
            # hop out (and mark the journey incomplete below)
            chain = {
                "admission": ((t_ing, t_shed1) if retried
                              else (t_ing, t_adm) if t_adm is not None
                              else None),
                "retry": (t_shed1, t_adm) if retried else None,
                "auth": (t_adm if t_adm is not None else t_ing, t_fin),
                "batching": (t_fin, t_sent),
                "preprepare": (t_sent, t_pp),
                "prepare": (t_pp, marks.get("3pc.prepare_quorum")),
                "commit": (marks.get("3pc.prepare_quorum"),
                           marks.get("3pc.commit_quorum")),
                "order": (marks.get("3pc.commit_quorum"), t_ord),
                "execute": (t_ord, t_exe),
                # cross-lane barrier (ordering lanes): executed -> the
                # seal of the batch's checkpoint window across ALL
                # lanes; absent in single-lane dumps and for windows
                # the dump never sealed
                "barrier": ((t_exe, t_seal) if t_seal is not None
                            else None),
            }
            rid = x.rid_of.get(digest)
            prop_med = (x.net_median("PROPAGATE", (lane, rid))
                        if rid else None)
            tid = trace_id(digest)
            hops = []
            attrib = {"network": 0.0, "queue": 0.0, "compute": 0.0,
                      "device": 0.0}
            complete = True
            for hop in _HOPS:
                span = chain[hop]
                if hop in _OPTIONAL_HOPS and span is None:
                    continue  # plane off in this dump: no wait to split
                if span is None or span[0] is None or span[1] is None:
                    complete = False
                    continue
                dur = max(0.0, span[1] - span[0])
                net = wave_med.get(hop)
                if hop == "auth" and prop_med is not None:
                    net = prop_med  # the PROPAGATE fan-out rides the
                    # finalisation wait (f+1 quorum of propagates)
                net = min(dur, max(0.0, net)) if net is not None else 0.0
                residual = _RESIDUAL_OF[hop]
                if hop == "order" and x.tick_mode:
                    residual = "device"
                rec = {"hop": hop, "span_id": span_id(tid, "", hop),
                       "t0": _r(span[0]), "dur": _r(dur),
                       "network": _r(net),
                       residual: _r(dur - net)}
                hops.append(rec)
                attrib["network"] += net
                attrib[residual] += dur - net
            journey = {
                "digest": digest,
                "trace_id": tid,
                "class": "write",
                "batch": [batch_key[0], batch_key[1], bd],
                # ordering lanes: which lane ordered it (absent in
                # single-lane dumps — existing tables stay byte-stable)
                **({"lane": lane} if lane is not None else {}),
                # geo plane: the submitting client's home region (absent
                # in single-region dumps — tables stay byte-stable)
                **({"region": x.req_region[digest]}
                   if digest in x.req_region else {}),
                # closed-loop retry: how many re-offers it took (absent
                # for first-attempt requests — retry-free tables stay
                # byte-stable)
                **({"retries": x.retry_count[digest]}
                   if digest in x.retry_count else {}),
                "t_ingress": _r(t_ing),
                "e2e": _r(t_exe - t_ing) if complete else None,
                "hops": hops,
                "attribution": {k: _r(v) for k, v in attrib.items()},
                "complete": complete,
            }
            if proof_ts is not None:
                journey["proof_after"] = _r(proof_ts - t_exe)
            if leeched_by:
                journey["catchup"] = leeched_by
            journeys.append(journey)
    journeys.sort(key=lambda j: (j["t_ingress"] is None,
                                 j["t_ingress"] or 0.0, j["digest"]))
    # a retried request is a journey (ordered) or still PENDING (its
    # backoff chain alive at dump time), never a shed: ``shed`` means
    # TERMINALLY shed — the closed loop gave up (req.retry_exhausted) or
    # never ran. Whether the loop ran is a DUMP-level fact (a shed whose
    # first re-offer is still on the timer has no per-request retry mark
    # yet), so any retry activity anywhere in the dump marks the loop
    # armed and unexhausted sheds count as pending. Retry-free dumps are
    # exactly the old "has a req.shed mark" set.
    loop_armed = bool(x.retry_count) or any(
        "req.retry_exhausted" in m for m in x.req.values())
    shed = sorted(
        d for d, m in x.req.items()
        if "req.shed" in m and d not in ordered_digests
        and ("req.retry_exhausted" in m or not loop_armed))
    pending = sorted(
        d for d, m in x.req.items()
        if d not in ordered_digests
        and ("req.shed" not in m
             or (loop_armed and "req.retry_exhausted" not in m)))
    built = {"journeys": journeys, "pending": pending, "shed": shed,
             "read_e2e": x.read_e2e,
             "fault_windows": [[_r(a), _r(b)]
                               for a, b in x.fault_windows]}
    if x.read_e2e_by_region:
        # geo plane only — single-region dumps stay byte-compatible
        built["read_e2e_by_region"] = dict(
            sorted(x.read_e2e_by_region.items()))
    return built, x


def journey_hash(journeys: List[Dict[str, Any]]) -> str:
    """sha256 over the canonical JSONL journey table — THE cross-node
    latency fingerprint (byte-identical per seed on virtual-clock
    pools, like ``ordered_hash``/``trace_hash``)."""
    return hashlib.sha256(events_to_jsonl(journeys).encode()).hexdigest()


def _pct_block(samples: List[float], ndigits: int = 6) -> Dict[str, Any]:
    s = sorted(samples)
    return {"count": len(s),
            "p50": round(percentile(s, 50), ndigits),
            "p90": round(percentile(s, 90), ndigits),
            "p99": round(percentile(s, 99), ndigits),
            "max": round(s[-1], ndigits) if s else 0.0}


def journey_summary(events: List[Dict[str, Any]],
                    built: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The pool-rollup block every surface reports (Monitor.snapshot,
    bench records, ChaosReport, the ``latency_gate``): journey counts +
    completeness, the table fingerprint, e2e percentiles per request
    class, per-hop percentiles, attribution shares, and — when the dump
    carries chaos fault windows — the measured latency cost of running
    through one."""
    built = built if built is not None else build_journeys(events)
    journeys = built["journeys"]
    complete = [j for j in journeys if j["complete"]]
    e2e = [j["e2e"] for j in complete]
    hop_samples: Dict[str, List[float]] = {}
    attrib_totals: Dict[str, float] = {}
    for j in complete:
        for h in j["hops"]:
            hop_samples.setdefault(h["hop"], []).append(h["dur"])
        for k, v in j["attribution"].items():
            attrib_totals[k] = attrib_totals.get(k, 0.0) + v
    whole = sum(attrib_totals.values())
    # dominant hop per journey (ties break on canonical hop order)
    dominant: Dict[str, int] = {}
    for j in complete:
        durs = {h["hop"]: h["dur"] for h in j["hops"]}
        top, top_d = None, float("-inf")
        for hop in _HOPS:
            if hop in durs and durs[hop] > top_d:
                top, top_d = hop, durs[hop]
        if top is not None:
            dominant[top] = dominant.get(top, 0) + 1
    out = {
        "count": len(journeys),
        "complete": len(complete),
        "orphan_spans": len(journeys) - len(complete),
        "pending": len(built["pending"]),
        "shed": len(built["shed"]),
        "catchup_journeys": sum(1 for j in journeys if j.get("catchup")),
        # closed-loop retry: journeys that got in only after >= 1
        # seeded-backoff re-offer (their tables carry the retry hop)
        "retried": sum(1 for j in journeys if j.get("retries")),
        "journey_hash": journey_hash(journeys),
        "e2e": {"write": _pct_block(e2e),
                "read": _pct_block(built["read_e2e"])},
        "hop_percentiles": {h: _pct_block(s)
                            for h, s in sorted(hop_samples.items())},
        "attribution_share": {
            k: round(v / whole, 4) for k, v in sorted(
                attrib_totals.items())} if whole else {},
        "critical_path": {h: dominant[h] for h in _HOPS
                          if h in dominant},
    }
    # ordering lanes: per-lane e2e percentiles + barrier-hop coverage
    # (absent for single-lane dumps — existing rollups stay byte-stable)
    lane_ids = sorted({j["lane"] for j in journeys if "lane" in j})
    if lane_ids:
        out["lanes"] = {
            "count": len(lane_ids),
            "journeys_per_lane": {
                str(l): sum(1 for j in journeys if j.get("lane") == l)
                for l in lane_ids},
            "e2e_per_lane": {
                str(l): _pct_block([j["e2e"] for j in complete
                                    if j.get("lane") == l])
                for l in lane_ids},
            "with_lane": sum(1 for j in journeys if "lane" in j),
            "with_barrier_hop": sum(
                1 for j in journeys
                if any(h["hop"] == "barrier" for h in j["hops"])),
        }
    # geo plane: per-region e2e percentiles for writes (journeys whose
    # marks carried a home region) and reads (region-tagged read FIFO
    # pairs) — absent for single-region dumps, so existing rollups stay
    # byte-stable
    region_ids = sorted({j["region"] for j in journeys if "region" in j})
    read_regions = built.get("read_e2e_by_region") or {}
    if region_ids or read_regions:
        regions = {
            "count": len(set(region_ids) | set(read_regions)),
            "with_region": sum(1 for j in journeys if "region" in j),
        }
        if region_ids:
            regions["journeys_per_region"] = {
                str(r): sum(1 for j in journeys if j.get("region") == r)
                for r in region_ids}
            regions["e2e_per_region"] = {
                str(r): _pct_block([j["e2e"] for j in complete
                                    if j.get("region") == r])
                for r in region_ids}
        if read_regions:
            regions["read_e2e_per_region"] = {
                str(r): _pct_block(s)
                for r, s in sorted(read_regions.items())}
        out["regions"] = regions
    windows = built["fault_windows"]
    if windows:
        def _in_fault(j):
            t0 = j["t_ingress"]
            t1 = t0 + j["e2e"]
            return any(a <= t1 and t0 <= b for a, b in windows)

        hit = [j["e2e"] for j in complete if _in_fault(j)]
        clear = [j["e2e"] for j in complete if not _in_fault(j)]
        out["fault_window"] = {
            "windows": len(windows),
            "through_fault": _pct_block(hit),
            "clear": _pct_block(clear),
            # the fault's direct latency cost on the requests that
            # crossed it (sim seconds at p50)
            "p50_cost": round(
                _pct_block(hit)["p50"] - _pct_block(clear)["p50"], 6)
            if hit and clear else None,
        }
    return out


def journey_for(events: List[Dict[str, Any]],
                digest_prefix: str) -> Optional[Dict[str, Any]]:
    """One request's full cross-node record (``trace_tool --journey``):
    the journey, plus every per-node lifecycle mark and the per-wave
    network latency samples behind its attribution."""
    built, x = _build_journeys(events)
    journey = next((j for j in built["journeys"]
                    if j["digest"].startswith(digest_prefix)), None)
    if journey is None:
        return None
    digest = journey["digest"]
    batch_digest = journey["batch"][2]
    tid = journey["trace_id"]
    lane = journey.get("lane")
    per_node: List[Dict[str, Any]] = []
    waves: Dict[str, List[float]] = {}
    batch_key = tuple(journey["batch"][:2])
    # wave samples are keyed (lane, view, seq) — None lane for unlaned
    wave_key = (lane,) + batch_key
    for ev in events:
        key = ev.get("key")
        cat = ev.get("cat", "")
        if cat == "3pc" and key and len(key) >= 3 \
                and key[2] == batch_digest:
            node = ev.get("node", "")
            per_node.append({
                "node": node, "name": ev["name"], "ts": _r(ev["ts"]),
                "span_id": span_id(tid, node, ev["name"])})
        elif cat == "req" and key and key[0] == digest:
            node = ev.get("node", "")
            per_node.append({
                "node": node, "name": ev["name"], "ts": _r(ev["ts"]),
                "span_id": span_id(tid, node, ev["name"])})
        elif cat == "net" and key and tuple(key) == batch_key:
            args = ev.get("args") or {}
            if ev["name"] == "net.recv":
                waves.setdefault(args.get("m", "?"), [])
    for op in list(waves) + ["PREPREPARE", "PREPARE", "COMMIT"]:
        lats = x.net.get((op, wave_key))
        if lats:
            waves[op] = [_r(v) for v in lats]
    # the PROPAGATE wave is keyed by the ingress rid, not the batch key
    # — it feeds the auth hop's network share, so it belongs here too
    rid = x.rid_of.get(digest)
    if rid is not None:
        lats = x.net.get(("PROPAGATE", (lane, rid)))
        if lats:
            waves["PROPAGATE"] = [_r(v) for v in lats]
    per_node.sort(key=lambda r: (r["ts"], r["node"], r["name"]))
    return {"journey": journey, "marks": per_node,
            "net_waves": {k: v for k, v in sorted(waves.items()) if v}}
