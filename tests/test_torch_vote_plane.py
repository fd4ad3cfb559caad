"""The port's DeviceVotePlane and VotePlaneGroup (on the CPU) driven by the
same recorded call sequence as the JAX classes, in sync and pipelined mode
and in device and host eval: identical PlaneDeltas, quorum answers,
frontiers and counters."""
import random

import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.tpu import vote_plane as jvp  # noqa: E402
from indy_plenum_tpu_torch.tpu import vote_plane as tvp  # noqa: E402

COUNTERS = ("flushes", "flush_votes_total", "flush_capacity_total",
            "readback_bytes_total", "readbacks")
GROUP_COUNTERS = COUNTERS + ("readbacks_overlapped",)


def _deltas(d):
    return None if d is None else (list(d.prepared), list(d.committed),
                                   int(d.frontier))


def _record_wave(view, validators, pp, rng, drop_commit=False,
                 silent=0):
    """One slot's 3PC votes as a member sees them: the PRE-PREPARE, the
    PREPAREs of the non-primaries and the COMMITs, minus ``silent``
    validators (and one more COMMIT when ``drop_commit``)."""
    live = validators[:len(validators) - silent]
    view.record_preprepare(pp)
    senders = list(live[1:])
    rng.shuffle(senders)
    for v in senders:
        view.record_prepare(v, pp)
    for v in live[:len(live) - (1 if drop_commit else 0)]:
        view.record_commit(v, pp)


def _drive(plane_of, n_members, validators, log_size, chk_freq, ticks,
           seed, flush):
    """The recorded call sequence: waves of votes per tick (some slots
    silent up to f, one held a COMMIT short, a burst that orders more
    than 16 slots in one step), checkpoint votes and window slides, one
    member reset, and a query after every tick. Returns the log."""
    rng = random.Random(seed)
    n = len(validators)
    f = (n - 1) // 3
    log = []
    h = [0] * n_members
    next_pp = [1] * n_members
    held = {}  # member -> pp held one COMMIT short
    for tick in range(ticks):
        for mi in range(n_members):
            view = plane_of(mi)
            burst = 18 if tick == 3 else rng.randint(1, 3)
            for _ in range(burst):
                pp = next_pp[mi]
                if pp - h[mi] > log_size - 2:
                    break
                next_pp[mi] += 1
                short = tick == 1 and mi == 0 and mi not in held
                if short:
                    held[mi] = pp
                _record_wave(view, validators, pp, rng, drop_commit=short,
                             silent=f if pp % 5 == 0 else 0)
            if tick == 6 and mi in held:
                view.record_commit(validators[-1], held.pop(mi))
            # junk: out-of-window slots and unknown senders are dropped
            view.record_prepare("nobody", next_pp[mi])
            view.record_commit(validators[0], h[mi] + log_size + 3)
            boundary = h[mi] + chk_freq
            if next_pp[mi] > boundary + 1:
                for v in validators:
                    view.record_checkpoint_vote(v, boundary, chk_freq)
        flush()
        for mi in range(n_members):
            view = plane_of(mi)
            log.append(("deltas", tick, mi, _deltas(view.poll_deltas())))
            pp = rng.randint(h[mi] + 1, max(h[mi] + 1, next_pp[mi] - 1))
            log.append(("q", tick, mi, view.has_prepare_quorum(pp),
                        view.has_commit_quorum(pp),
                        view.has_buffered_votes))
            boundary = h[mi] + chk_freq
            if view.has_checkpoint_quorum(boundary, chk_freq):
                log.append(("slide", tick, mi, boundary))
                view.slide_to(boundary)
                h[mi] = boundary
        if tick == 8 and n_members > 1:
            view = plane_of(n_members - 1)
            view.reset(h[n_members - 1])
            next_pp[n_members - 1] = h[n_members - 1] + 1
            log.append(("reset", tick))
    return log


def _group_run(mod, n, pipelined, host_eval, device_kw):
    validators = [f"n{i}" for i in range(n)]
    group = mod.VotePlaneGroup(n, validators, log_size=40, n_checkpoints=2,
                               pipelined=pipelined, host_eval=host_eval,
                               **device_kw)
    log = _drive(group.view, n, validators, 40, 20, 14, seed=n,
                 flush=group.flush)
    return log, {c: getattr(group, c) for c in GROUP_COUNTERS}


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("host_eval", [False, True])
@pytest.mark.parametrize("n", [4, 7])
def test_group_matches_jax(n, pipelined, host_eval):
    jlog, jcount = _group_run(jvp, n, pipelined, host_eval, {})
    tlog, tcount = _group_run(tvp, n, pipelined, host_eval,
                              {"device": "cpu"})
    assert tlog == jlog
    assert tcount == jcount
    if not host_eval:
        frontiers = [e[3][2] for e in tlog if e[0] == "deltas" and e[3]]
        assert frontiers and max(frontiers) > 16
        assert any(e[0] == "slide" for e in tlog)
        assert tcount["readback_bytes_total"] > 0


@pytest.mark.parametrize("host_eval", [False, True])
def test_standalone_plane_matches_jax(host_eval):
    validators = ["n0", "n1", "n2", "n3"]
    runs = []
    for mod, kw in ((jvp, {}), (tvp, {"device": "cpu"})):
        plane = mod.DeviceVotePlane(validators, log_size=40,
                                    n_checkpoints=2, host_eval=host_eval,
                                    **kw)
        log = _drive(lambda mi: plane, 1, validators, 40, 20, 10, seed=11,
                     flush=plane.sync)
        log.append(("count", plane.prepare_count(plane.h + 1)))
        runs.append((log, {c: getattr(plane, c) for c in COUNTERS}))
    assert runs[0] == runs[1]


def test_mesh_raises():
    import torch

    from indy_plenum_tpu_torch.tpu import quorum as tq

    # a mesh naming a card this process lacks raises; one naming distinct
    # devices (or split) runs the group in the per-tile layout; a mesh
    # that is not the port's FabricMesh, or whose first home is another
    # device than the group's, is refused
    with pytest.raises((RuntimeError, ValueError)):
        tvp.VotePlaneGroup(4, ["a", "b", "c", "d"], 40,
                           mesh=tq.make_fabric_mesh(["cpu", "cuda:0"], (2,)),
                           device="cpu")
    group = tvp.VotePlaneGroup(
        4, ["a", "b", "c", "d"], 40, device="cpu",
        mesh=tq.make_fabric_mesh(["cpu"] * 2, (2,), split=True))
    assert isinstance(group._states, tq.TileState)
    assert group.compile_strategy["step"] == "k13_split"
    with pytest.raises(TypeError):
        tvp.VotePlaneGroup(4, ["a", "b", "c", "d"], 40, mesh=object(),
                           device="cpu")
    meta = tq.FabricMesh((2,), ("members",), torch.device("meta"))
    with pytest.raises(ValueError):
        tvp.VotePlaneGroup(4, ["a", "b", "c", "d"], 40, mesh=meta,
                           device="cpu")


def test_residency_builds_and_flushes():
    group = tvp.VotePlaneGroup(4, ["a", "b", "c", "d"], 40,
                               resident_depth=2, device="cpu")
    view = group.view(0)
    view.record_preprepare(1)
    for v in ("b", "c", "d"):
        view.record_prepare(v, 1)
    group.flush()
    assert group.resident_depth == 2 and group.resident_ticks == 1
    assert view.has_prepare_quorum(1)
