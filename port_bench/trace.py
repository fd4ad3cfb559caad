"""The traced run's instruments: host spans around the calls into each
layer, the shapes each timed kernel was launched with, and one
``torch.profiler`` session over the measured window.

Spans and shape records are installed by wrapping the program's entry
points in this process only (the program's files are not touched); they
cost a ``record_function`` or a list append a call, and only a traced run
installs them. From the profiler's trace come the device's busy seconds
(the union of every operation's interval on the card inside the window),
each kernel's device seconds by name, and the idle gaps, each put down to
the innermost host span that covers its middle.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Dict, List, Tuple

# kernel family -> the name its CUDA kernel carries in the trace
KERNELS = {
    "kc": "ed25519_verify_kernel",
    "k7": "quorum_step_kernel",
    "k10": "audit_fold_kernel",
}

WINDOW_SPAN = "bench.window"
# the harness's own spans around its calls into the pool
HARNESS_SPANS = (WINDOW_SPAN, "pool.step", "client.pump", "client.send")


def _wrap_span(owner, attr: str, span: str) -> None:
    import torch

    inner = getattr(owner, attr)

    @functools.wraps(inner)
    def traced(*args, **kwargs):
        with torch.profiler.record_function(span):
            return inner(*args, **kwargs)

    setattr(owner, attr, traced)


class Tracer:
    """``install()`` before the pool runs; ``start()`` and ``stop()`` around
    the window; then :meth:`reduce`."""

    def __init__(self):
        self.shapes: Dict[str, list] = defaultdict(list)
        self.recording = False
        self._prof = None
        self.spans = set()

    # --- instruments ---------------------------------------------------

    def span(self, owner, attr: str, name: str) -> None:
        _wrap_span(owner, attr, name)
        self.spans.add(name)

    def install(self) -> None:
        from indy_plenum_tpu_torch.bls.bls_bft_replica import BlsBftReplica
        from indy_plenum_tpu_torch.ingress.read_service import ReadService
        from indy_plenum_tpu_torch.server import client_authn
        from indy_plenum_tpu_torch.server.catchup import catchup_rep_service
        from indy_plenum_tpu_torch.server.node import Node
        from indy_plenum_tpu_torch.tpu import quorum
        from indy_plenum_tpu_torch.tpu.vote_plane import VotePlaneGroup

        self.span(Node, "_flush_auth_queue", "node.auth_drain")
        self.span(Node, "_on_ordered", "node.execute_reply")
        self.span(VotePlaneGroup, "flush", "quorum.flush")
        self.span(BlsBftReplica, "update_commit", "bls.sign")
        self.span(BlsBftReplica, "process_order", "bls.aggregate")
        self.span(BlsBftReplica, "flush", "bls.verify")
        self.span(ReadService, "drain", "read.drain")
        shapes, tracer = self.shapes, self

        # the shapes each launch needs, for readers.roofline: K-c counts
        # the drain's real signatures (not the launch's padding rows); K7
        # counts no vote hits, which a device read per step would cost
        # (1 byte a hit: leaving them out lowers the bound a little)
        verify = client_authn.CoreAuthNr._verify_entries

        def verify_entries(authnr, pks, msgs, sigs):
            if tracer.recording:
                shapes["kc"].append((len(pks),))
            return verify(authnr, pks, msgs, sigs)

        client_authn.CoreAuthNr._verify_entries = verify_entries

        step = quorum._step_kernel

        def step_kernel(state, words, n_validators, delta_cap, compact):
            if tracer.recording:
                m, n, s = state.prepare_votes.shape
                shapes["k7"].append(
                    (m, n, s, state.checkpoint_votes.shape[-1],
                     words.numel(), min(int(delta_cap), int(s))))
            return step(state, words, n_validators, delta_cap, compact)

        quorum._step_kernel = step_kernel

        pack = catchup_rep_service.pack_audit_batch

        def pack_audit_batch(*args, **kwargs):
            packed = pack(*args, **kwargs)
            if tracer.recording and packed is not None:
                leaf, _, table, path_idx, path_len = packed[:5]
                shapes["k10"].append(
                    (leaf.shape[0], path_idx.shape[1], table.shape[0],
                     int(path_len.sum())))
            return packed

        catchup_rep_service.pack_audit_batch = pack_audit_batch

    # --- the profiler window -------------------------------------------

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.recording = True

    def stop(self) -> None:
        self.recording = False
        self._prof.stop()

    def reduce(self) -> "Trace":
        return Trace.from_events(self._prof.profiler.kineto_results.events(),
                                 self.spans | set(HARNESS_SPANS), self.shapes)


def _ns(evt, what: str) -> int:
    fn = getattr(evt, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, what + "_us")() * 1000)


class Trace:
    """What the metric readers take from a traced window."""

    def __init__(self, kernel_s: Dict[str, float], busy_s: float,
                 window_s: float, idle_gaps: Dict[str, float],
                 shapes: Dict[str, list]):
        self.kernel_s = kernel_s  # device seconds by kernel name
        self.busy_s = busy_s
        self.window_s = window_s
        self.idle_gaps = idle_gaps  # idle seconds by covering host span
        self.shapes = shapes

    def family_s(self, family: str) -> float:
        key = KERNELS[family]
        return sum(s for name, s in self.kernel_s.items() if key in name)

    @classmethod
    def from_events(cls, events, span_names, shapes) -> "Trace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device: List[Tuple[int, int]] = []
        kernel_s: Dict[str, float] = defaultdict(float)
        spans: List[Tuple[int, int, str]] = []
        for evt in events:
            start, dur = _ns(evt, "start"), _ns(evt, "duration")
            name = evt.name()
            if name in span_names:
                # a host span; kineto mirrors each on the device's
                # timeline as an annotation, which is no device work
                if evt.device_type() != cuda:
                    spans.append((start, start + dur, name))
            elif evt.device_type() == cuda:
                device.append((start, start + dur))
                kernel_s[name] += dur * 1e-9
        window = [s for s in spans if s[2] == WINDOW_SPAN]
        if not window:
            raise RuntimeError("the traced window's span is missing")
        w0, w1, _ = window[0]
        busy_ns, gaps = 0, []
        cursor = w0
        for start, end in sorted(device):
            start, end = max(start, w0), min(end, w1)
            if end <= cursor:
                continue
            if start > cursor:
                gaps.append((cursor, start))
            busy_ns += end - max(start, cursor)
            cursor = end
        if cursor < w1:
            gaps.append((cursor, w1))
        return cls(dict(kernel_s), busy_ns * 1e-9, (w1 - w0) * 1e-9,
                   _attribute(gaps, spans), dict(shapes))


def _attribute(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost span covering each gap's middle, in
    one sweep: spans of one thread nest, so a stack of the open spans
    holds the innermost on top. ``host.other`` where only the window
    covers it. ``gaps`` come in time order."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else WINDOW_SPAN
        out["host.other" if name == WINDOW_SPAN else name] += (g1 - g0) * 1e-9
    return dict(out)
