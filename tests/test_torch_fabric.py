"""The member x validator quorum fabric in the port, on the CPU against the
JAX package on the conftest's 8 virtual CPU devices.

- The mesh builder (``make_fabric_mesh``, ``parse_mesh_shape``) behaves as
  the reference's; a list naming distinct devices builds the per-tile
  layout, and one naming a card this process lacks raises.
- K13's plain version (``plan_for(mesh).step``) against JAX's
  ``step_compact_local`` under ``plan_for(mesh)`` on (4, 2), (2, 2) and N
  = 5 on v = 2; at v = 1 it equals K7's plain version.
- ``make_sharded_step`` and ``make_sharded_fused_step`` against JAX's.
- The tiled resident plan against JAX's ``resident_plan_for(mesh)``.
- ``VotePlaneGroup(mesh=...)`` in both packages on the reference's group
  cases: padding, the occupancy grid, slide and reset against unsharded,
  and the per-shard pipelined readback.

Every comparison is exact: the outputs are integers and bools.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.observability.trace import TraceRecorder as JTrace  # noqa: E402,E501
from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu import step as jstep  # noqa: E402
from indy_plenum_tpu.tpu import vote_plane as jvp  # noqa: E402
from indy_plenum_tpu.utils.jax_env import parse_mesh_shape as jparse  # noqa: E402,E501
from indy_plenum_tpu_torch.crypto import ed25519 as ed  # noqa: E402
from indy_plenum_tpu_torch.observability.trace import TraceRecorder as TTrace  # noqa: E402,E501
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as ted  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import step as tstep  # noqa: E402
from indy_plenum_tpu_torch.tpu import vote_plane as tvp  # noqa: E402
from indy_plenum_tpu_torch.utils.torch_env import (  # noqa: E402
    mesh_devices,
    parse_mesh_shape,
)

CPU8 = ["cpu"] * 8


def jmesh(shape):
    return jq.make_fabric_mesh(jax.devices()[:8], shape)


def tmesh(shape):
    return tq.make_fabric_mesh(CPU8, shape)


# --- the mesh builder --------------------------------------------------------


def test_parse_mesh_shape():
    for spec in ("8", "4x2", "4X2", "1"):
        assert parse_mesh_shape(spec) == jparse(spec)
    assert mesh_devices((4, 2)) == 8
    for bad in ("0", "4x0", "2x2x2", "x", "fast"):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)


def test_fabric_mesh_builder():
    one = tmesh((4,))
    assert one.axis_names == ("members",) == jmesh((4,)).axis_names
    two = tmesh((4, 2))
    assert two.axis_names == ("members", "validators") \
        == jmesh((4, 2)).axis_names
    assert (two.m_shards, two.v_shards) == (4, 2)
    assert two.device == torch.device("cpu")
    for shape in ((4, 3), (2, 2, 2), (0,)):
        with pytest.raises(ValueError):
            tq.make_fabric_mesh(CPU8, shape)
        with pytest.raises(ValueError):
            jq.make_fabric_mesh(jax.devices()[:8], shape)
    # a list naming a card this process does not have raises (here: no
    # CUDA at all; with cards, the CPU and a card in one fabric), never a
    # fallback to the CPU or to one device
    with pytest.raises((RuntimeError, ValueError)):
        tq.make_fabric_mesh(["cpu", "cuda:0"] + ["cpu"] * 6, (4, 2))
    with pytest.raises(TypeError):
        tcp.plan_for(jmesh((4,)), 4, 4, 16)


def test_fabric_mesh_over_distinct_devices_is_per_tile(monkeypatch):
    """A list naming distinct devices builds the per-tile layout, tile
    (i, j) on ``devices[i * v + j]`` (the cards are named only: the
    process is made to see eight, with peer access between them); one
    card without peer access to another raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    cards = [f"cuda:{i}" for i in range(8)]
    mesh = tq.make_fabric_mesh(cards, (4, 2))
    assert mesh.split and mesh.device == torch.device("cuda", 0)
    assert [mesh.tile_device(i, j).index for i in range(4)
            for j in range(2)] == list(range(8))
    assert mesh.home(2) == torch.device("cuda", 4)
    assert not tq.make_fabric_mesh(["cuda:3"] * 8, (4, 2)).split
    assert tq.make_fabric_mesh(["cuda:3"] * 8, (4, 2), split=True).split
    with pytest.raises(ValueError):
        tq.make_fabric_mesh(["cuda:8"] * 8, (4, 2))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {1, 6})
    with pytest.raises(RuntimeError, match="peer"):
        tq.make_fabric_mesh(cards, (4, 2))


def test_compile_plan_strategies():
    flat = tcp.plan_for(None, 4, 4, 16)
    assert flat.strategy == {"step": "k7", "slide": "k8", "zero": "k8"}
    assert flat.mesh_shape == jcp.plan_for(None, 4, 4, 16).mesh_shape == ()
    for shape in ((4,), (2, 2)):
        plan = tcp.plan_for(tmesh(shape), 4, 4, 16)
        assert plan.strategy == {"step": "k13", "slide": "k8", "zero": "k8"}
        assert plan.mesh_shape == shape \
            == jcp.plan_for(jmesh(shape), 4, 4, 16).mesh_shape
    assert tcp.plan_for(None, 4, 4, 16) is flat


# --- K13 ---------------------------------------------------------------------


def _state(rng, m, n, s, c, pad_from=None):
    """Random 0/1 planes and frontiers; validator rows from ``pad_from``
    stay empty (pad rows)."""
    def bits(*shape):
        return (rng.rand(*shape) < 0.4).astype(np.uint8)

    leaves = [bits(m, s), bits(m, n, s), bits(m, n, s), bits(m, n, c),
              bits(m, s), bits(m, s),
              rng.randint(0, s + 1, m).astype(np.int32)]
    if pad_from is not None:
        for i in (1, 2, 3):
            leaves[i][:, pad_from:] = 0
    return leaves


def _words(rng, m, w, n_senders, s, c):
    kind = rng.randint(0, 4, (m, w))
    sender = rng.randint(0, n_senders, (m, w))
    hi = np.where(kind == jq.CHECKPOINT, c + 2, s + 4)
    slot = (rng.rand(m, w) * hi).astype(np.int64)
    valid = rng.rand(m, w) < 0.85
    return ((valid.astype(np.uint64) << 31) | (kind.astype(np.uint64) << 29)
            | (sender.astype(np.uint64) << 16)
            | slot.astype(np.uint64)).astype(np.uint32)


def _wave(m, w, n, slot):
    """Full 3PC votes of ``slot`` for every member (so quorums fire)."""
    row = [jq.pack_vote(jq.PREPREPARE, 0, slot)]
    row += [jq.pack_vote(jq.PREPARE, v, slot) for v in range(1, n)]
    row += [jq.pack_vote(jq.COMMIT, v, slot) for v in range(n)]
    out = np.zeros((m, w), np.uint32)
    out[:, :len(row)] = row[:w]
    return out


def _assert_same(jax_out, port_out):
    for fields, a_all, b_all in zip(
            (tq.VoteState._fields, tq.QuorumEvents._fields,
             tq.CompactEvents._fields), jax_out, port_out):
        for name, a, b in zip(fields, a_all, b_all):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, name
            assert np.array_equal(a, b.numpy()), name


@pytest.mark.parametrize("shape,m,n,real", [
    ((4, 2), 8, 8, 8), ((2, 2), 4, 8, 8), ((2, 2), 4, 6, 5)],
    ids=["4x2", "2x2", "n5_v2"])
def test_fabric_step_matches_jax(shape, m, n, real):
    """K13's plain version against JAX's shard_map step on the same mesh
    shape: two steps (random words, then a full wave), every state leaf,
    event and compact record equal. ``n`` is the padded row count."""
    s, c, w = 24, 3, 32
    rng = np.random.RandomState(sum(shape) * 10 + real)
    leaves = _state(rng, m, n, s, c, pad_from=real)
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    tstate = tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves])
    jplan = jcp.plan_for(jmesh(shape), real, n, jq.ORDER_DELTA_CAP)
    tplan = tcp.plan_for(tmesh(shape), real, n, tq.ORDER_DELTA_CAP)
    for words in (_words(rng, m, w, real, s, c), _wave(m, w, real, 5)):
        jout = jplan.step(jstate, jnp.asarray(words))
        tout = tplan.step(tstate, tq.words_tensor(words))
        _assert_same(jout, tout)
        jstate = jout[0]
    assert int(np.asarray(jout[1].ordered).sum()) > 0


def test_fabric_step_at_one_tile_is_k7():
    rng = np.random.RandomState(7)
    leaves = _state(rng, 6, 7, 30, 2)
    words = tq.words_tensor(_words(rng, 6, 64, 9, 30, 2))
    a = tq.VoteState(*[torch.from_numpy(x.copy()) for x in leaves])
    b = tq.clone_state(a)
    ev_a, comp_a = tq.fabric_step(a, words, 7, 1)
    ev_b, comp_b = tq.step_compact(b, words, 7)
    for x, y in zip(list(a) + list(ev_a) + list(comp_a),
                    list(b) + list(ev_b) + list(comp_b)):
        assert torch.equal(x, y)


def test_sharded_step_matches_jax():
    """``make_sharded_step`` on test_quorum_plane's shapes (N = 16, S = 32,
    C = 4, a wave and 300 random entries in 512 words) over an 8-tile
    validator axis."""
    from jax.sharding import Mesh

    n, s, c = 16, 32, 4
    rng = np.random.RandomState(1)
    # one full 3PC wave (slot 3), so quorums fire, then random votes
    entries = [(jq.PREPREPARE, 0, 3)] + [(jq.PREPARE, v, 3)
                                         for v in range(1, n)]
    entries += [(jq.COMMIT, v, 3) for v in range(n)]
    for _ in range(300):
        k = int(rng.randint(0, 4))
        entries.append((k, 0 if k == jq.PREPREPARE else int(rng.randint(n)),
                        int(rng.randint(c if k == jq.CHECKPOINT else s))))
    jfn = jq.make_sharded_step(Mesh(np.array(jax.devices()[:8]),
                                    ("validators",)), n)
    jstate, jev = jfn(jq.init_state(n, s, c), jq.pack_messages(entries, 512))
    tfn = tq.make_sharded_step(
        tq.make_fabric_mesh(CPU8, (8,), ("validators",)), n)
    tstate, tev = tfn(tq.init_state(n, s, c),
                      tq.words_tensor(tq.pack_words(entries, 512)[None]))
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev)):
        for name, a, b in zip(fields, a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
    assert bool(np.asarray(jev.ordered).any())


def test_sharded_fused_step_matches_jax():
    """``make_sharded_fused_step`` on a 4-tile validator axis: 16 signed
    votes (n = 8, S = 8), two of them planted bad."""
    from jax.sharding import Mesh

    n, s, c, batch = 8, 8, 2, 16
    rng = np.random.RandomState(46)
    seeds = [rng.bytes(32) for _ in range(n)]
    keys = [ed.public_key(sd) for sd in seeds]
    entries, pks, msgs, sigs = [], [], [], []
    for b in range(batch):
        kind = jq.PREPREPARE if b % 8 == 0 else (
            jq.PREPARE if b % 2 else jq.COMMIT)
        sender = 0 if kind == jq.PREPREPARE else b % n
        entries.append((kind, sender, b % 3))
        msg = jq.pack_vote(kind, sender, b % 3).to_bytes(4, "little")
        sig = ed.sign(seeds[sender], msg)
        if b in (5, 12):  # planted: a flipped signature bit
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        pks.append(keys[sender])
        msgs.append(msg)
        sigs.append(sig)
    pk, rb, sg, h, pre = ted.prepare_batch(pks, msgs, sigs)
    assert pre.all()
    jfn = jstep.make_sharded_fused_step(
        Mesh(np.array(jax.devices()[:4]), ("validators",)), n)
    jstate, jev, jok = jfn(jq.init_state(n, s, c),
                           jq.pack_messages(entries, batch),
                           *[jnp.asarray(a) for a in (pk, rb, sg, h)])
    tfn = tstep.make_sharded_fused_step(
        tq.make_fabric_mesh(["cpu"] * 4, (4,), ("validators",)), n)
    tstate, tev, tok = tfn(
        tq.init_state(n, s, c),
        tq.words_tensor(tq.pack_words(entries, batch)[None]),
        *[torch.from_numpy(a) for a in (pk, rb, sg, h)])
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev)):
        for name, a, b in zip(fields, a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
    assert np.array_equal(np.asarray(jok), tok.numpy())
    assert int(tok.sum()) == batch - 2


# --- the tiled resident plan ------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_resident_tile_plan_matches_jax(k):
    """The tiled K9's plain version against JAX's ``resident_plan_for``
    on a (2, 2) fabric: slides of 0, 1, the checkpoint interval, S - 1
    and S, an empty slot, a full wave; every output equal."""
    m, n, s, c, w = 4, 6, 20, 3, 32
    rng = np.random.RandomState(60 + k)
    leaves = _state(rng, m, n, s, c)
    mix = np.array([0, 1, 5, s - 1, s], np.int32)
    slides = mix[rng.randint(0, len(mix), (k, m))]
    slides[:, 0] = 0
    words = [_words(rng, m, w, n, s, c) for _ in range(k)]
    words[0] = _wave(m, w, n, 3)
    words[k // 2][:] = 0
    jstep_fn = jcp.resident_plan_for(jmesh((2, 2)), n, n,
                                     jq.ORDER_DELTA_CAP, k, w)
    jout = jstep_fn(jq.VoteState(*[jnp.asarray(a) for a in leaves]),
                    jnp.asarray(slides), *[jnp.asarray(x) for x in words])
    tstep_fn = tcp.resident_plan_for(tmesh((2, 2)), n, n,
                                     tq.ORDER_DELTA_CAP, k, w, "cpu")
    tout = tstep_fn(tq.VoteState(*[torch.from_numpy(a.copy())
                                   for a in leaves]),
                    torch.from_numpy(slides),
                    *[tq.words_tensor(x) for x in words])
    _assert_same(jout, tout)
    assert (slides > 0).any()


# --- the group ---------------------------------------------------------------


class _Pkg:
    def __init__(self, vp, mesh, trace):
        self.vp, self.mesh, self.trace = vp, mesh, trace

    def group(self, *args, shape=None, **kw):
        mesh = None if shape is None else self.mesh(shape)
        if self.vp is tvp:
            kw["device"] = "cpu"
        return self.vp.VotePlaneGroup(*args, mesh=mesh, **kw)


PKGS = {"jax": _Pkg(jvp, jmesh, JTrace), "port": _Pkg(tvp, tmesh, TTrace)}
GROUP_COUNTERS = ("flushes", "flush_votes_total", "flush_capacity_total",
                  "flush_votes_per_shard", "flush_capacity_per_shard",
                  "readback_bytes_total", "readbacks",
                  "readbacks_overlapped", "readback_bytes_per_shard",
                  "shard_occupancy", "shards", "mesh_shape")


def _counters(group):
    return {c: getattr(group, c) for c in GROUP_COUNTERS}


def _padding_case(pkg):
    """tests/test_mesh_dispatch.py:80-104 and test_quorum_fabric.py:
    127-148: M = 6 on 4 member blocks, N = 5 on 2 validator blocks."""
    out = {}
    validators = [f"n{i}" for i in range(4)]
    group = pkg.group(6, validators, log_size=8, n_checkpoints=2,
                      shape=(4,))
    group.view(0).record_preprepare(1)
    for sender in validators[1:]:
        group.view(0).record_prepare(sender, 1)
    group.view(5).record_prepare("n1", 2)
    group.flush()
    out["members"] = (group._m_pad, group._shard_rows, group._real_rows,
                      group.view(0).prepare_count(1),
                      group.view(5).prepare_count(2), _counters(group))
    validators = [f"n{i}" for i in range(5)]
    group = pkg.group(4, validators, log_size=8, n_checkpoints=2,
                      shape=(2, 2))
    group.view(0).record_preprepare(1)
    for sender in validators[1:]:
        group.view(0).record_prepare(sender, 1)
    group.flush()
    out["validators"] = (group._n_pad, group._v_rows, group._v_real,
                         group.view(0).prepare_count(1),
                         group.view(0).has_prepare_quorum(1),
                         _counters(group))
    return out


def _grid_case(pkg):
    """test_quorum_fabric.py:151-172: votes attributed by sender block."""
    validators = [f"n{i}" for i in range(4)]
    group = pkg.group(4, validators, log_size=8, n_checkpoints=2,
                      shape=(2, 2))
    for m in (0, 2):
        for sender in ("n0", "n1"):
            group.view(m).record_prepare(sender, 1)
    group.flush()
    return _counters(group)


def _slide_reset_case(pkg, shape):
    """test_quorum_fabric.py:175-198 (and test_mesh_dispatch.py:107-129)."""
    validators = [f"n{i}" for i in range(4)]
    group = pkg.group(4, validators, log_size=8, n_checkpoints=2,
                      shape=shape)
    for m in range(4):
        group.view(m).record_preprepare(2)
        for sender in validators:
            group.view(m).record_prepare(sender, 2)
            group.view(m).record_commit(sender, 2)
    group.flush()
    group.view(1).slide_to(1)
    group.view(2).reset()
    group.flush()
    return ([np.asarray(group._host_prepared)[m].tolist() for m in range(4)],
            _counters(group))


def _pipelined_case(pkg):
    """test_quorum_fabric.py:201-236: per-shard pipelined readback."""
    validators = [f"n{i}" for i in range(4)]
    group = pkg.group(4, validators, log_size=8, n_checkpoints=2,
                      shape=(2, 2), pipelined=True)
    clock = [0.0]
    group.trace = pkg.trace(lambda: clock[0])
    for tick in range(3):
        for m in range(4):
            group.view(m).record_preprepare(tick + 1)
            for sender in validators:
                group.view(m).record_prepare(sender, tick + 1)
        group.flush()
        clock[0] += 1.0
    group._sync_inflight()
    spans = [(ev["name"], ev["args"]) for ev in group.trace.events()
             if ev["name"] in ("flush.readback", "flush.dispatch")]
    return _counters(group), spans, [group.view(m).prepare_count(3)
                                     for m in range(4)]


def test_group_padding_matches_jax():
    got, want = _padding_case(PKGS["port"]), _padding_case(PKGS["jax"])
    assert got == want
    assert got["members"][2] == [2, 2, 2, 0]
    assert got["validators"][:5] == (6, 3, [3, 2], 4, True)


def test_group_occupancy_grid_matches_jax():
    got = _grid_case(PKGS["port"])
    assert got == _grid_case(PKGS["jax"])
    assert got["flush_votes_per_shard"] == [2, 0, 2, 0]
    assert sum(got["flush_capacity_per_shard"]) == pytest.approx(
        got["flush_capacity_total"])


@pytest.mark.parametrize("shape", [(4,), (2, 2), (4, 2)])
def test_group_slide_and_reset_match_jax_and_unsharded(shape):
    got = _slide_reset_case(PKGS["port"], shape)
    assert got == _slide_reset_case(PKGS["jax"], shape)
    assert got[0] == _slide_reset_case(PKGS["port"], None)[0]


def test_group_per_shard_pipelined_readback_matches_jax():
    got = _pipelined_case(PKGS["port"])
    assert got == _pipelined_case(PKGS["jax"])
    counters, spans, _ = got
    assert sum(counters["readback_bytes_per_shard"]) \
        == counters["readback_bytes_total"] > 0
    assert counters["readbacks_overlapped"] > 0
    assert {a["shard"] for name, a in spans if name == "flush.readback"} \
        == {0, 1}
