"""The rebalance law and the group's plane rotation in the port, against
the JAX package.

- The unit tests of ``tests/test_residency.py:204-305`` run against the
  port's ``RebalancePolicy``, and one seeded EWMA series fed to both
  classes gives the same plans, skews and counts.
- A ``VotePlaneGroup`` on the (2, 2) fabric, in both packages, rotates its
  planes at a barrier between votes: the same quorum answers, counters,
  ``row_shift`` and ``rebalances``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu import vote_plane as jvp  # noqa: E402
from indy_plenum_tpu.tpu.rebalance import RebalancePolicy as JaxPolicy  # noqa: E402,E501
from indy_plenum_tpu_torch.config import getConfig  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import vote_plane as tvp  # noqa: E402
from indy_plenum_tpu_torch.tpu.rebalance import RebalancePolicy  # noqa: E402


def test_rebalance_skew_even_count_median():
    assert RebalancePolicy.skew([8.0, 1.0, 1.0, 1.0]) == 8.0
    assert RebalancePolicy.skew([4.0, 2.0]) == pytest.approx(4.0 / 3.0)
    assert RebalancePolicy.skew([1.0, 1.0, 1.0]) == 1.0


def test_rebalance_dwell_counting_and_reset():
    hot = [8.0, 1.0, 1.0, 1.0]
    cool = [1.0, 1.0, 1.0, 1.0]
    p = RebalancePolicy(4, 2, threshold=2.0, dwell=3)
    assert p.observe(hot) == 0
    assert p.observe(hot) == 0
    assert p.observe(cool) == 0  # dip resets the dwell counter
    assert p.observe(hot) == 0
    assert p.observe(hot) == 0
    rows = p.observe(hot)  # third consecutive over-threshold tick
    assert rows > 0 and p.planned == 1
    assert p.last_skew == 8.0


def test_rebalance_cooldown_mutes_the_law():
    hot = [8.0, 1.0, 1.0, 1.0]
    p = RebalancePolicy(4, 2, threshold=2.0, dwell=2, cooldown=5)
    assert [p.observe(hot) for _ in range(2)][-1] > 0
    assert all(p.observe(hot) == 0 for _ in range(5))  # muted
    out = [p.observe(hot) for _ in range(2)]
    assert out[-1] > 0 and p.planned == 2


def test_rebalance_plan_minimizes_predicted_hot_block():
    p = RebalancePolicy(4, 2)
    assert p.plan([8.0, 1.0, 1.0, 1.0]) == 1
    assert p.plan([3.0, 3.0, 3.0, 3.0]) == 0
    assert RebalancePolicy(4, 1).plan([8.0, 1.0, 1.0, 1.0]) == 0


def test_rebalance_policy_determinism():
    rng = np.random.RandomState(5)
    series = [list(rng.uniform(0.0, 8.0, size=4)) for _ in range(64)]
    a = RebalancePolicy(4, 2, threshold=1.5, dwell=3)
    b = RebalancePolicy(4, 2, threshold=1.5, dwell=3)
    assert [a.observe(s) for s in series] == [b.observe(s) for s in series]
    assert a.last_skew == b.last_skew and a.planned == b.planned


def test_rebalance_from_config_gating():
    class FakeGroup:
        _m_shards = 4
        _shard_rows = 2
        _v_shards = 1

    armed = getConfig({"RebalanceSkewThreshold": 2.0})
    assert RebalancePolicy.from_config(armed, None) is None
    assert RebalancePolicy.from_config(getConfig({}), FakeGroup()) is None
    policy = RebalancePolicy.from_config(armed, FakeGroup())
    assert policy is not None and policy.threshold == 2.0
    assert policy.dwell == armed.RebalanceDwellTicks
    forced = getConfig({"RebalanceForceTick": 7})
    assert RebalancePolicy.from_config(forced, FakeGroup()) is not None


def test_rebalance_forced_rotation_unskews_hot_block():
    p = RebalancePolicy(4, 2, threshold=2.0, dwell=2)
    hot = [8.0, 1.0, 1.0, 1.0]
    rows = 0
    for _ in range(4):
        rows = rows or p.observe(hot)
    assert rows == 1
    b0, r = divmod(rows, 2)
    predicted = [
        (2 - r) / 2 * hot[(k - b0) % 4] + r / 2 * hot[(k - b0 - 1) % 4]
        for k in range(4)]
    assert RebalancePolicy.skew(predicted) < min(
        RebalancePolicy.skew(hot), p.threshold)


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_seeded_series_plans_as_jax(grid):
    """One seeded EWMA series (hot spells that move between cells, cool
    stretches, a forced tick) into both classes: the same plan every
    tick, the same skew and counts."""
    m, v = grid
    rng = np.random.RandomState(9)
    series = []
    for t in range(240):
        cells = rng.uniform(0.0, 1.0, m * v)
        if (t // 30) % 2 == 0:
            cells[(t // 60) % (m * v)] += rng.uniform(3.0, 8.0)
        series.append([float(x) for x in cells])
    kw = dict(threshold=1.4, dwell=4, force_tick=100)
    port = RebalancePolicy(m, 3, v, **kw)
    ref = JaxPolicy(m, 3, v, **kw)
    got = [port.observe(s) for s in series]
    want = [ref.observe(s) for s in series]
    assert got == want
    assert (port.planned, port.last_skew) == (ref.planned, ref.last_skew)
    assert port.planned >= 2 and any(got)
    for cfg in ({"RebalanceSkewThreshold": 1.5},
                {"RebalanceForceTick": 5}):
        class Group:
            _m_shards, _shard_rows, _v_shards = m, 3, v

        a = RebalancePolicy.from_config(getConfig(cfg), Group())
        b = JaxPolicy.from_config(jax_config(cfg), Group())
        assert [a.observe(s) for s in series[:60]] \
            == [b.observe(s) for s in series[:60]]


def _rotating_group(vp, mesh, **kw):
    """Votes, a scheduled rotation executed at the barrier, more votes:
    the answers members read before and after."""
    validators = [f"n{i}" for i in range(4)]
    group = vp.VotePlaneGroup(6, validators, log_size=8, n_checkpoints=2,
                              mesh=mesh, **kw)
    log = []
    for tick in range(4):
        for mi in range(6):
            view = group.view(mi)
            slot = tick + 1 + mi % 2
            view.record_preprepare(slot)
            for sender in validators[: 2 + (mi + tick) % 3]:
                view.record_prepare(sender, slot)
                view.record_commit(sender, slot)
        group.flush()
        log.append([(group.view(mi).prepare_count(tick + 1),
                     group.view(mi).has_commit_quorum(tick + 1),
                     group.view(mi).has_prepare_quorum(tick + 2))
                    for mi in range(6)])
        if tick == 1:
            group.schedule_rebalance(3)
            group.rebalance_at_barrier()
            log.append((group.row_shift, group.rebalances))
    return log, (group.flushes, group.readbacks, group.readback_bytes_total,
                 group.readback_bytes_per_shard, group.flush_votes_per_shard,
                 group.shard_occupancy)


def test_group_rotation_matches_jax():
    jmesh = jq.make_fabric_mesh(jax.devices()[:8], (2, 2))
    tmesh = tq.make_fabric_mesh(["cpu"] * 8, (2, 2))
    want = _rotating_group(jvp, jmesh)
    got = _rotating_group(tvp, tmesh, device="cpu")
    assert got == want
    assert got[0][2] == (3, 1)
