"""The slice as a whole: a same-seed JAX SimPool's signed write path
replayed into the port.

A JAX ``SimPool(device_quorum=True, sign_requests=True)`` runs at n=4 and
n=7 through a view change. The test records (1) every request batch its
ingress authenticated, with the verdicts, and (2) every call the pool's
nodes and tick driver make on the grouped vote plane and its member
views, with the answers - through a test-local recording wrapper handed in
by monkeypatching ``simulation.quorum_driver.make_vote_group``. Both are
replayed into the port's ``CoreAuthNr`` and ``VotePlaneGroup`` (on the
CPU): every verdict, every ``poll_deltas`` result, every quorum answer and
the group counters after every flush must be equal.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.config import getConfig  # noqa: E402
from indy_plenum_tpu.simulation import quorum_driver  # noqa: E402
from indy_plenum_tpu.simulation.pool import SimPool  # noqa: E402
from indy_plenum_tpu_torch.common.request import Request  # noqa: E402
from indy_plenum_tpu_torch.server.client_authn import CoreAuthNr  # noqa: E402,E501
from indy_plenum_tpu_torch.tpu.vote_plane import VotePlaneGroup  # noqa: E402

COUNTERS = ("flushes", "flush_votes_total", "flush_capacity_total",
            "readback_bytes_total", "readbacks", "readbacks_overlapped")
# results not compared: the quorum-event handle and the owning group
_OPAQUE = {"events", "_group"}


def _norm(value):
    if hasattr(value, "prepared") and hasattr(value, "frontier"):
        return (list(value.prepared), list(value.committed),
                int(value.frontier))
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    return value


class _Log:
    def __init__(self):
        self.calls = []
        self.depth = 0  # > 0 while a recorded call runs (skip inner ones)


class _PlaneProxy:
    """Forwards to a member view, logging each external call/read/write."""

    def __init__(self, target, idx, log):
        object.__setattr__(self, "_t", target)
        object.__setattr__(self, "_i", idx)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, name):
        value = getattr(self._t, name)
        log, idx = self._log, self._i
        if not callable(value):
            log.calls.append((idx, "get", name, (), _norm(value)))
            return value

        def call(*args, **kwargs):
            log.depth += 1
            try:
                res = value(*args, **kwargs)
            finally:
                log.depth -= 1
            log.calls.append((idx, "call", name, (args, kwargs),
                              None if name in _OPAQUE else _norm(res)))
            return res

        return call

    def __setattr__(self, name, value):
        self._log.calls.append((self._i, "set", name, (value,), None))
        setattr(self._t, name, value)


def _recording_factory(log, made):
    orig = quorum_driver.make_vote_group

    def make(*args, **kwargs):
        group = orig(*args, **kwargs)
        made.append(group)
        proxies = [_PlaneProxy(m, i, log)
                   for i, m in enumerate(group._members)]
        group.view = lambda i: proxies[i]
        real_flush = group.flush

        def flush():
            outer = log.depth == 0
            real_flush()
            if outer:
                log.calls.append(("group", "call", "flush", (),
                                  tuple(getattr(group, c)
                                        for c in COUNTERS)))

        group.flush = flush
        return group

    return make


def _run_jax_pool(n, seed, monkeypatch):
    log, made, ingress = _Log(), [], []
    monkeypatch.setattr(quorum_driver, "make_vote_group",
                        _recording_factory(log, made))
    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 2,
                     "QuorumTickInterval": 0.05})
    pool = SimPool(n, seed=seed, config=cfg, device_quorum=True,
                   sign_requests=True, shadow_check=False)
    real_auth = pool.authnr.authenticate_batch

    def auth(batch):
        verdicts = real_auth(batch)
        ingress.append(([r.as_dict() for r in batch], verdicts.tolist()))
        return verdicts

    pool.authnr.authenticate_batch = auth
    primary = pool.nodes[0].data.primaries[0]
    for i in range(6):
        pool.submit_request(i)
    pool.submit_tampered_request(6)
    pool.run_for(10)
    pool.network.disconnect(primary)
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 104):
        pool.submit_request(i)
    pool.submit_tampered_request(104)
    pool.run_for(12)
    assert pool.honest_nodes_agree()
    return pool, made[0], log, ingress


@pytest.mark.parametrize("n,seed", [(4, 37), (7, 41)])
def test_jax_pool_replays_into_port(n, seed, monkeypatch):
    pool, jgroup, log, ingress = _run_jax_pool(n, seed, monkeypatch)

    # (1) ingress: every authenticated batch, same verdicts
    authnr = CoreAuthNr(seed_keys={pool.trustee.identifier:
                                   pool.trustee.verkey}, device="cpu")
    verdicts = []
    for batch, expect in ingress:
        got = authnr.authenticate_batch(
            [Request.from_dict(d) for d in batch]).tolist()
        assert got == expect
        verdicts += got
    assert True in verdicts and False in verdicts

    # (2) the quorum plane: the same call sequence, the same answers
    members = jgroup._members
    group = VotePlaneGroup(
        len(members), list(members[0]._validators), jgroup._log_size,
        jgroup._n_chk, pipelined=jgroup.pipelined,
        adaptive_ladder=jgroup._ladder is not None,
        host_eval=jgroup.host_eval, device="cpu")
    polls = 0
    for idx, what, name, args, expect in log.calls:
        if idx == "group":
            getattr(group, name)(*args)
            assert tuple(getattr(group, c) for c in COUNTERS) == expect
            continue
        view = group.view(idx)
        if what == "set":
            setattr(view, name, *args)
            continue
        if what == "get":
            assert _norm(getattr(view, name)) == expect, (idx, name)
            continue
        got = getattr(view, name)(*args[0], **args[1])
        if name not in _OPAQUE:
            assert _norm(got) == expect, (idx, name, args)
        polls += name == "poll_deltas" and got is not None
    assert polls > 0
    assert any(c[2] == "reset" for c in log.calls)  # the view change
    assert tuple(getattr(group, c) for c in COUNTERS) \
        == tuple(getattr(jgroup, c) for c in COUNTERS)
