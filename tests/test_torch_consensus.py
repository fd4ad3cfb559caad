"""The port's host-side consensus modules against the JAX package's, on the
same seeded inputs: the dispatch governor's interval trajectory, the
admission controller's shed set, the quorum thresholds, the wire message
schemas, the virtual timer's firing order and the flight recorder's
fingerprints. These modules are copies; the tests pin that the copies
still decide exactly as the reference does."""
import random

import numpy as np
import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.common.messages import node_messages as jmsg  # noqa: E402,E501
from indy_plenum_tpu.common.messages.message_base import (  # noqa: E402
    node_message_registry as jax_registry,
)
from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.ingress import admission as jadm  # noqa: E402
from indy_plenum_tpu.observability.trace import (  # noqa: E402
    TraceRecorder as JaxTrace,
)
from indy_plenum_tpu.server.quorums import Quorums as JaxQuorums  # noqa: E402
from indy_plenum_tpu.simulation.mock_timer import (  # noqa: E402
    MockTimer as JaxTimer,
)
from indy_plenum_tpu.tpu.governor import (  # noqa: E402
    DispatchGovernor as JaxGovernor,
)
from indy_plenum_tpu_torch.common.messages import (  # noqa: E402
    node_messages as tmsg,
)
from indy_plenum_tpu_torch.common.messages.message_base import (  # noqa: E402,E501
    node_message_registry as port_registry,
)
from indy_plenum_tpu_torch.common.timer import RepeatingTimer  # noqa: E402
from indy_plenum_tpu_torch.config import getConfig as port_config  # noqa: E402,E501
from indy_plenum_tpu_torch.ingress import admission as tadm  # noqa: E402
from indy_plenum_tpu_torch.observability.trace import (  # noqa: E402
    TraceRecorder as PortTrace,
)
from indy_plenum_tpu_torch.server.quorums import (  # noqa: E402
    Quorums as PortQuorums,
)
from indy_plenum_tpu_torch.simulation.mock_timer import (  # noqa: E402
    MockTimer as PortTimer,
)
from indy_plenum_tpu_torch.tpu.governor import (  # noqa: E402
    DispatchGovernor as PortGovernor,
)


def _observations(seed, shards, ticks=300):
    """Per tick: votes and capacity per shard, dispatches, in-flight flag,
    and (every few ticks) an ingress backpressure signal."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(ticks):
        phase = (t // 40) % 3  # idle, trickle, burst
        cap = [int(rng.choice([16, 128, 256])) * 8 for _ in range(shards)]
        hi = (0.01, 0.3, 1.0)[phase]
        votes = [int(c * rng.uniform(0, hi)) for c in cap]
        signal = None
        if t % 5 == 0:
            signal = dict(queue_depth=int(rng.randint(0, 40)), capacity=32,
                          shed_delta=int(rng.randint(0, 3)),
                          leeching=bool(rng.rand() < 0.1),
                          retry_pressure=int(rng.randint(0, 2)))
        out.append((votes, cap, 1 + int(phase == 2 and rng.rand() < 0.5),
                    bool(rng.rand() < 0.4), signal))
    return out


@pytest.mark.parametrize("seed,shards", [(1, 1), (2, 1), (3, 4)])
def test_governor_follows_the_reference_trajectory(seed, shards):
    knobs = {"QuorumTickInterval": 0.05, "QuorumTickAdaptive": True}
    jgov = JaxGovernor.from_config(jax_config(dict(knobs)))
    tgov = PortGovernor.from_config(port_config(dict(knobs)))
    jints, tints = [], []
    for votes, cap, disp, inflight, signal in _observations(seed, shards):
        if signal is not None:
            jgov.feed_backpressure(jadm.BackpressureSignal(**signal))
            tgov.feed_backpressure(tadm.BackpressureSignal(**signal))
        jints.append(jgov.observe_shards(votes, cap, disp, inflight))
        tints.append(tgov.observe_shards(votes, cap, disp, inflight))
    assert tints == jints
    assert list(tgov.trajectory) == list(jgov.trajectory)
    assert tgov.trajectory_summary() == jgov.trajectory_summary()
    assert len(set(tints)) > 2  # the law actually moved


class _Req:
    def __init__(self, digest):
        self.digest = digest


@pytest.mark.parametrize("capacity,per_client", [(8, 0), (16, 3), (5, 2)])
def test_admission_sheds_the_reference_set(capacity, per_client):
    rng = random.Random(capacity * 31 + per_client)
    now = [0.0]
    jctl = jadm.AdmissionController(capacity, per_client, seed=7,
                                    clock=lambda: now[0])
    tctl = tadm.AdmissionController(capacity, per_client, seed=7,
                                    clock=lambda: now[0])
    for tick in range(40):
        for i in range(rng.randint(0, 3 * capacity)):
            req = _Req("%d-%d-%x" % (tick, i, rng.getrandbits(64)))
            client = rng.choice([None, "a", "b", "c"])
            assert tctl.offer(req, client) == jctl.offer(req, client)
        if tick % 3 != 2:
            jb, js = jctl.drain()
            tb, ts = tctl.drain()
            assert [r.digest for r in tb] == [r.digest for r in jb]
            assert [(r.digest, c, why) for r, c, why in ts] == \
                [(r.digest, c, why) for r, c, why in js]
        now[0] += 0.05
    assert tctl.shed_total > 0
    assert tctl.shed_hash() == jctl.shed_hash()
    assert tctl.counters() == jctl.counters()


def test_quorums_match_the_reference():
    for n in range(1, 70):
        j, t = JaxQuorums(n), PortQuorums(n)
        for name in ("f", "weak", "strong", "propagate", "prepare",
                     "commit", "checkpoint"):
            jv, tv = getattr(j, name), getattr(t, name)
            assert getattr(tv, "value", tv) == getattr(jv, "value", jv), \
                (n, name)


def test_message_schemas_match_the_reference():
    assert sorted(port_registry._by_name) == sorted(jax_registry._by_name)
    for name, jcls in jax_registry._by_name.items():
        tcls = port_registry.get(name)
        assert [(f, type(v).__name__) for f, v in tcls.schema] == \
            [(f, type(v).__name__) for f, v in jcls.schema], name
    pp = dict(instId=0, viewNo=2, ppSeqNo=7, ppTime=1_700_000_000,
              reqIdr=["d1", "d2"], discarded=0, digest="x" * 64,
              ledgerId=1, stateRootHash=None, txnRootHash=None,
              sub_seq_no=0, final=False)
    assert tmsg.PrePrepare(**pp).as_dict() == jmsg.PrePrepare(**pp).as_dict()


def test_virtual_timer_fires_in_the_reference_order():
    """Plain and barrier events, cancellations and a repeating timer whose
    interval changes: both timers fire the same callbacks at the same
    virtual instants."""
    from indy_plenum_tpu.common.timer import RepeatingTimer as JaxRepeating

    def drive(timer_cls, repeating_cls):
        timer = timer_cls(start_time=100.0)
        fired = []

        def cb(tag):
            return lambda: fired.append((tag, timer.get_current_time()))

        cbs = {i: cb(i) for i in range(12)}
        for i in range(12):
            timer.schedule((i % 4) * 0.25, cbs[i], barrier=i % 3 == 0)
        timer.cancel(cbs[5])
        rep = repeating_cls(timer, 0.3, cb("tick"), barrier=True)
        timer.advance(1.0)
        rep.update_interval(0.1)
        timer.advance(0.5)
        rep.stop()
        timer.advance(1.0)
        return fired

    assert drive(PortTimer, RepeatingTimer) == drive(JaxTimer, JaxRepeating)


def test_trace_recorder_fingerprints_match_the_reference():
    now = [5.0]
    jrec = JaxTrace(lambda: now[0], capacity=64)
    trec = PortTrace(lambda: now[0], capacity=64)
    for i in range(100):  # wraps the ring
        for rec in (jrec, trec):
            rec.record("3pc.ordered", node=f"node{i % 4}",
                       key=(0, i, "d%d" % i), args={"n": i})
            with rec.span("flush.dispatch", args={"votes": i}):
                pass
        now[0] += 0.01
    assert trec.to_jsonl() == jrec.to_jsonl()
    assert trec.trace_hash() == jrec.trace_hash()
    assert trec.trace_hash(exclude_cats=("dispatch",)) == \
        jrec.trace_hash(exclude_cats=("dispatch",))
