"""Multi-tick device residency in the port (K9 and the ring), on the CPU
against the JAX package.

- ``resident_plan_for(None, ...)``: the port's step (K9's plain version)
  and JAX's on the same seeded vote state, slides and words, bit-equal in
  every state leaf, event and compact record; slides mix 0, 1, a
  checkpoint interval, S - 1, S and 2S, with an all-empty slot and a
  member whose frontier is below its delta.
- ``VotePlaneGroup(resident_depth=4)``: the port's group and JAX's, driven
  by ``test_torch_vote_plane``'s recorded call sequence with window
  slides, sync and pipelined, per query and tick-batched: the same log and
  counters.
- The residency barrier: a view reset drains the ring (the twin of
  ``tests/test_residency.py::test_ring_drains_on_view_reset``).

The JAX group stages every word block in one reused numpy buffer per
width and hands it to ``jnp.array``, whose host-to-device transfer may
still read the buffer after the call returns: when ring slots queue up
under CPU load, a later slot's words can land in an earlier slot and the
JAX pool orders differently (ROADMAP Queue 3). :func:`copy_staging` gives
the JAX group a fresh buffer per block for these comparisons, which is
what its staging means to do; nothing of the JAX package changes.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu import vote_plane as jvp  # noqa: E402
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import vote_plane as tvp  # noqa: E402
from test_torch_vote_plane import GROUP_COUNTERS, _drive  # noqa: E402

M, W, CHK = 6, 64, 5
RESIDENT_COUNTERS = GROUP_COUNTERS + ("resident_ticks",
                                      "readbacks_deferred")


def copy_staging(monkeypatch):
    """Give the JAX group a fresh host staging buffer per word block."""
    stage = jvp.VotePlaneGroup._stage_scatter

    def fresh(self, chunks, shape, interleave=None):
        self._scatter_bufs.pop(shape, None)
        return stage(self, chunks, shape, interleave)

    monkeypatch.setattr(jvp.VotePlaneGroup, "_stage_scatter", fresh)


def _random_state(rng, n, s, c):
    def bits(*shape):
        return (rng.rand(*shape) < 0.4).astype(np.uint8)

    return [bits(M, s), bits(M, n, s), bits(M, n, s), bits(M, n, c),
            bits(M, s), bits(M, s), rng.randint(0, s + 1, M).astype(np.int32)]


def _random_words(rng, n, s, c):
    kind = rng.randint(0, 4, (M, W))
    sender = rng.randint(0, n + 2, (M, W))
    hi = np.where(kind == jq.CHECKPOINT, c + 2, s + 4)
    slot = (rng.rand(M, W) * hi).astype(np.int64)
    valid = rng.rand(M, W) < 0.85
    return ((valid.astype(np.uint64) << 31) | (kind.astype(np.uint64) << 29)
            | (sender.astype(np.uint64) << 16)
            | slot.astype(np.uint64)).astype(np.uint32)


def _slides(rng, k, s):
    """(k, M) deltas from the edge mix; the last member's frontier is set
    below its delta by the caller."""
    mix = np.array([0, 1, CHK, s - 1, s, 2 * s], np.int32)
    out = mix[rng.randint(0, len(mix), (k, M))]
    out[0, M - 1] = s - 1
    out[:, 0] = 0  # one member never slides: a strict identity
    return out


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("s", [8, 30])
@pytest.mark.parametrize("n", [4, 16])
def test_resident_plan_matches_jax(n, s, k):
    c = 3
    rng = np.random.RandomState(100 * n + 10 * s + k)
    leaves = _random_state(rng, n, s, c)
    leaves[-1][M - 1] = 2  # frontier below its delta
    slides = _slides(rng, k, s)
    words = [_random_words(rng, n, s, c) for _ in range(k)]
    words[k // 2][:] = 0  # an all-empty slot: a no-op scatter
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    jstep = jcp.resident_plan_for(None, n, n, jq.ORDER_DELTA_CAP, k, W)
    jstate, jev, jcomp = jstep(jstate, jnp.asarray(slides),
                               *[jnp.asarray(w) for w in words])
    tstate = tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves])
    tstep = tcp.resident_plan_for(None, n, n, tq.ORDER_DELTA_CAP, k, W,
                                  "cpu")
    tstate, tev, tcomp = tstep(
        tstate, torch.from_numpy(slides),
        *[tq.words_tensor(w) for w in words])
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev),
                                 (tq.CompactEvents._fields, jcomp, tcomp)):
        for name, a, b in zip(fields, a_all, b_all):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, name
            assert np.array_equal(a, b.numpy()), name
    # the slides really moved windows and the scatters really landed
    assert (slides > 0).any() and int(np.asarray(jev.prepare_counts).sum())


def test_one_zero_slide_slot_is_the_per_tick_step():
    rng = np.random.RandomState(3)
    leaves = _random_state(rng, 7, 30, 2)
    words = tq.words_tensor(_random_words(rng, 7, 30, 2))
    a = tq.VoteState(*[torch.from_numpy(x.copy()) for x in leaves])
    b = tq.clone_state(a)
    ev_a, comp_a = tq.resident_step(a, torch.zeros((1, M), dtype=torch.int32),
                                    words[None], 7)
    ev_b, comp_b = tq.step_compact(b, words, 7)
    for x, y in zip(list(a) + list(ev_a) + list(comp_a),
                    list(b) + list(ev_b) + list(comp_b)):
        assert torch.equal(x, y)


def _resident_run(mod, n, pipelined, defer, device_kw):
    validators = [f"n{i}" for i in range(n)]
    group = mod.VotePlaneGroup(n, validators, log_size=40, n_checkpoints=2,
                               pipelined=pipelined, resident_depth=4,
                               **device_kw)
    for i in range(n):
        group.view(i).defer_flush_on_query = defer
    log = _drive(group.view, n, validators, 40, 20, 14, seed=n,
                 flush=group.flush)
    return log, {c: getattr(group, c) for c in RESIDENT_COUNTERS}


@pytest.mark.parametrize("defer", [False, True],
                         ids=["per_query", "tick_batched"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_resident_group_matches_jax(pipelined, defer, monkeypatch):
    copy_staging(monkeypatch)
    jlog, jcount = _resident_run(jvp, 4, pipelined, defer, {})
    tlog, tcount = _resident_run(tvp, 4, pipelined, defer,
                                 {"device": "cpu"})
    assert tlog == jlog
    assert tcount == jcount
    assert any(e[0] == "slide" for e in tlog)
    assert tcount["resident_ticks"] > 0
    if defer:
        assert tcount["readbacks_deferred"] > 0


def test_ring_drains_on_view_reset():
    validators = [f"n{i}" for i in range(4)]
    group = tvp.VotePlaneGroup(4, validators, log_size=8, n_checkpoints=2,
                               resident_depth=4, device="cpu")
    # cold start: the first flush consumes synchronously
    group.view(0).record_preprepare(1)
    group.view(0).record_prepare("n1", 1)
    group.flush()
    assert not group._ring
    # the second tick enqueues and DEFERS (ring_ticks 1 < depth 4)
    group.view(1).record_prepare("n0", 2)
    group.view(1).record_prepare("n2", 2)
    group.flush()
    assert group._ring
    assert group.readbacks_deferred == 1
    assert group.lagging  # staged slots count as in-flight work
    # a view reset of ANY member drains the whole ring first
    group.reset_member(3)
    assert not group._ring
    assert not group._pending_slide.any()
    assert not group.lagging
    assert group.view(1).prepare_count(2) == 2
    assert group.view(0).prepare_count(1) == 1


def test_rebalance_and_mesh_wait_for_their_slices():
    # the rotation, the one-device fabric and the per-tile layout are in;
    # a mesh naming a card this process lacks raises
    group = tvp.VotePlaneGroup(4, ["a", "b", "c", "d"], 8, 2,
                               resident_depth=4, device="cpu")
    group.rebalance_at_barrier()  # nothing scheduled: a no-op
    assert group.rebalances == 0
    group.schedule_rebalance(1)
    group.rebalance_at_barrier()
    assert (group.rebalances, group.row_shift) == (1, 1)
    with pytest.raises((RuntimeError, ValueError)):
        tcp.resident_plan_for(tq.make_fabric_mesh(["cpu", "cuda:0"], (2,)),
                              4, 4, 16, 1, 16, "cpu")
    split = tq.make_fabric_mesh(["cpu"] * 2, (2,), split=True)
    assert callable(tcp.resident_plan_for(split, 4, 4, 16, 1, 16, "cpu"))
