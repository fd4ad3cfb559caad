"""The fabric's per-tile layout in the port (every tile its own tensors on
its own device), on the CPU against the JAX package's mesh on the
conftest's 8 virtual CPU devices. The port's mesh is
``make_fabric_mesh(["cpu"] * 8, shape, split=True)``: the same per-tile
code a mesh over several cards runs, each tile's kernels in their plain
versions and each cross-device move a copy.

- The per-tile step (``plan_for(mesh).step``: the non-home tiles'
  partials stored on each home, the home form's sum and decide) against
  JAX's ``plan_for`` on (8,), (4, 2) and (2, 4), and
  ``make_sharded_step`` against JAX's on an 8-tile validator axis.
- The per-tile resident plan at k = 2 and 4 against ``resident_plan_for``.
- Both on (4, 2) and (2, 4) with the non-home tiles' partials stored into
  the home's buffer rows in reverse and rotated order (the home form sums
  every row, whichever tile wrote it).
- ``ring_shift_planes`` (K1's peer form) against ``ring_shift_reference``
  for every shift, and ``rotate_planes`` (two shifts and K15's merge on
  every tile) against the reference's for rows that are and are not a
  multiple of the block.
- The per-tile sharded fused step against ``make_sharded_fused_step``.
- ``VotePlaneGroup`` on per-tile meshes, in device and host eval, on
  test_torch_fabric's group cases against the JAX group.
- An n = 16 ``SimPool`` on a (4, 2) per-tile mesh at depth 1 and 4
  against the JAX mesh pool: ``ordered_hash``, the dispatch-free
  ``trace_hash`` and the per-block readbacks.
- ``lane_meshes`` with a device list, slice for slice against the
  reference's, and a 2-lane pool on (2,) per-tile fabrics against the JAX
  lane pool.

Every comparison is exact: the outputs are integers and bools.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_fabric as fab  # noqa: E402
from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.lanes import pool as jlanes  # noqa: E402
from indy_plenum_tpu.observability.trace import TraceRecorder as JTrace  # noqa: E402,E501
from indy_plenum_tpu.simulation.pool import SimPool as JaxPool  # noqa: E402
from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu import rebalance as jrb  # noqa: E402
from indy_plenum_tpu.tpu import ring_exchange as jrx  # noqa: E402
from indy_plenum_tpu.tpu import vote_plane as jvp  # noqa: E402
from indy_plenum_tpu_torch.config import getConfig as port_config  # noqa: E402,E501
from indy_plenum_tpu_torch.lanes import pool as tlanes  # noqa: E402
from indy_plenum_tpu_torch.observability.trace import TraceRecorder as TTrace  # noqa: E402,E501
from indy_plenum_tpu_torch.simulation.pool import SimPool as PortPool  # noqa: E402,E501
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import rebalance as trb  # noqa: E402
from indy_plenum_tpu_torch.tpu import ring_exchange as trx  # noqa: E402
from indy_plenum_tpu_torch.tpu import step as tstep  # noqa: E402
from indy_plenum_tpu_torch.tpu import vote_plane as tvp  # noqa: E402
from indy_plenum_tpu_torch.utils import torch_env  # noqa: E402
from test_torch_fabric import _assert_same, _state, _wave, _words  # noqa: E402,E501
from test_torch_resident import copy_staging  # noqa: E402

CPU8 = ["cpu"] * 8


def jmesh(shape, names=None):
    if names is not None:
        return Mesh(np.array(jax.devices()[:shape[0]]), names)
    return jq.make_fabric_mesh(jax.devices()[:8], shape)


def smesh(shape, names=None):
    """The per-tile layout over the CPU: one tile a device of the list."""
    return tq.make_fabric_mesh(CPU8, shape, names, split=True)


def _tiles(leaves, mesh):
    return tq.TileState.split(
        tq.VoteState(*[torch.from_numpy(a.copy()) for a in leaves]), mesh)


def _port_out(tiles, events, compact):
    """A per-tile step's outputs as the one-state step's: the joined
    state, every block's events and compact record joined."""
    return (tq.VoteState(*[torch.from_numpy(a) for a in tiles.to_numpy()]),
            tq.join_blocks(events), tq.join_blocks(compact))


# --- the mesh ----------------------------------------------------------------


def test_split_mesh_names_one_device_a_tile():
    mesh = smesh((4, 2))
    assert mesh.split and mesh.grid == (4, 2)
    assert mesh.tile_devices == (torch.device("cpu"),) * 8
    assert mesh.home(3) == mesh.tile_device(3, 0) == torch.device("cpu")
    assert not tq.make_fabric_mesh(CPU8, (4, 2)).split
    assert smesh((8,), ("validators",)).grid == (1, 8)
    assert torch_env.device_list("cpu", 8) == [torch.device("cpu")] * 8
    plan = tcp.plan_for(mesh, 8, 8, 16)
    assert plan.strategy == {"step": "k13_split", "slide": "k8_tiles",
                             "zero": "k8_tiles"}
    assert plan.mesh_shape == (4, 2)
    with pytest.raises(TypeError):
        plan.step(tq.init_state(8, 8, 2, 8), tq.words_tensor(
            np.zeros((8, 16), np.uint32)))


# --- the per-tile step -------------------------------------------------------


@pytest.mark.parametrize("shape", [(8,), (4, 2), (2, 4)],
                         ids=["8", "4x2", "2x4"])
def test_split_step_matches_jax(shape):
    """Two steps (random words, then a full wave) through the per-tile
    plan and JAX's ``plan_for`` on the same mesh shape: every state leaf,
    event and compact record equal."""
    _check_split_step(shape)


def _check_split_step(shape):
    m, n, s, c, w = 8, 8, 24, 3, 32
    rng = np.random.RandomState(sum(shape) * 7)
    leaves = _state(rng, m, n, s, c)
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    tiles = _tiles(leaves, smesh(shape))
    jplan = jcp.plan_for(jmesh(shape), n, n, jq.ORDER_DELTA_CAP)
    tplan = tcp.plan_for(smesh(shape), n, n, tq.ORDER_DELTA_CAP)
    for words in (_words(rng, m, w, n, s, c), _wave(m, w, n, 5)):
        jout = jplan.step(jstate, jnp.asarray(words))
        tiles, events, compact = tplan.step(tiles, tq.words_tensor(words))
        assert len(events) == len(compact) == shape[0]
        _assert_same(jout, _port_out(tiles, events, compact))
        jstate = jout[0]
    assert int(np.asarray(jout[1].ordered).sum()) > 0


def test_split_sharded_step_matches_jax():
    """``make_sharded_step`` over 8 validator tiles, each its own tensors:
    a wave and 300 random entries in 512 words (test_fabric's case)."""
    n, s, c = 16, 32, 4
    rng = np.random.RandomState(1)
    entries = [(jq.PREPREPARE, 0, 3)] + [(jq.PREPARE, v, 3)
                                         for v in range(1, n)]
    entries += [(jq.COMMIT, v, 3) for v in range(n)]
    for _ in range(300):
        k = int(rng.randint(0, 4))
        entries.append((k, 0 if k == jq.PREPREPARE else int(rng.randint(n)),
                        int(rng.randint(c if k == jq.CHECKPOINT else s))))
    jfn = jq.make_sharded_step(jmesh((8,), ("validators",)), n)
    jstate, jev = jfn(jq.init_state(n, s, c), jq.pack_messages(entries, 512))
    mesh = smesh((8,), ("validators",))
    tiles = tq.TileState.split(tq.init_state(n, s, c), mesh)
    tiles, tev = tq.make_sharded_step(mesh, n)(
        tiles, tq.words_tensor(tq.pack_words(entries, 512)[None]))
    tstate = tiles.join()
    for fields, a_all, b_all in ((tq.VoteState._fields, jstate, tstate),
                                 (tq.QuorumEvents._fields, jev, tev)):
        for name, a, b in zip(fields, a_all, b_all):
            assert np.array_equal(np.asarray(a), b.numpy()[0]), name
    assert bool(np.asarray(jev.ordered).any())


@pytest.mark.parametrize("k", [2, 4])
def test_split_resident_plan_matches_jax(k):
    """The per-tile resident plan on (4, 2) against JAX's: slides of 0, 1,
    the checkpoint interval, S - 1 and S, an empty slot, a full wave."""
    _check_split_resident((4, 2), k, 6)


def _check_split_resident(shape, k, n):
    m, s, c, w = 8, 20, 3, 32
    rng = np.random.RandomState(70 + k)
    leaves = _state(rng, m, n, s, c)
    mix = np.array([0, 1, 5, s - 1, s], np.int32)
    slides = mix[rng.randint(0, len(mix), (k, m))]
    slides[:, 0] = 0
    words = [_words(rng, m, w, n, s, c) for _ in range(k)]
    words[0] = _wave(m, w, n, 3)
    words[k // 2][:] = 0
    jfn = jcp.resident_plan_for(jmesh(shape), n, n, jq.ORDER_DELTA_CAP, k,
                                w)
    jout = jfn(jq.VoteState(*[jnp.asarray(a) for a in leaves]),
               jnp.asarray(slides), *[jnp.asarray(x) for x in words])
    tfn = tcp.resident_plan_for(smesh(shape), n, n, tq.ORDER_DELTA_CAP, k,
                                w, "cpu")
    tiles, events, compact = tfn(_tiles(leaves, smesh(shape)),
                                 torch.from_numpy(slides),
                                 *[tq.words_tensor(x) for x in words])
    _assert_same(jout, _port_out(tiles, events, compact))
    assert (slides > 0).any()


SLOT_ORDERS = {"reverse": lambda j, v: v - 1 - j,
               "rotate": lambda j, v: j % (v - 1)}


@pytest.mark.parametrize("order", sorted(SLOT_ORDERS))
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_split_partials_slot_order_matches_jax(shape, order, monkeypatch):
    """The home form's sum does not depend on which row of the home's
    partials buffer a non-home tile stored into: the per-tile step (two
    steps) and the resident plan at k = 2 with the tiles' partials handed
    to the home in reverse and rotated row order, against JAX's
    ``plan_for`` and ``resident_plan_for`` on the same mesh shape."""
    used = set()

    def slot(j, v):
        used.add((j, SLOT_ORDERS[order](j, v)))
        return SLOT_ORDERS[order](j, v)

    monkeypatch.setattr(tq, "partials_slot", slot)
    _check_split_step(shape)
    v = shape[1]
    _check_split_resident(shape, 2, 3 * v)
    assert sorted(r for _, r in used) == list(range(v - 1))
    assert v == 2 or any(j - 1 != r for j, r in used)


# --- the ring and the rotation -----------------------------------------------


@pytest.mark.parametrize("shape", [(8,), (4, 2)], ids=["8", "4x2"])
def test_split_ring_and_rotation_match_jax(shape):
    """K1's peer form for every shift 0 .. m + 1, and the rotation (two
    shifts, K15 on every tile) for rows that are a multiple of the block
    R and rows that are not, against the reference on the same mesh."""
    m_pad, r = 16, 16 // shape[0]
    rng = np.random.RandomState(11 * shape[0])
    leaves = _state(rng, m_pad, 4, 6, 2)
    jm, tm = jmesh(shape), smesh(shape)
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    for shift in range(shape[0] + 2):
        want = jrx.ring_shift_reference(jstate, jm, shift)
        got = trx.ring_shift_planes(_tiles(leaves, tm), tm, shift)
        assert isinstance(got, tq.TileState)
        for name, a, b in zip(tq.VoteState._fields, want, got.to_numpy()):
            assert np.array_equal(np.asarray(a), b), (shift, name)
    for rows in (r, 2 * r + 1, r - 1, 3 * r + r // 2, m_pad - 1):
        want = jrb.rotate_planes(jstate, jm, rows, r)
        got = trb.rotate_planes(_tiles(leaves, tm), tm, rows, r)
        for name, a, b in zip(tq.VoteState._fields, want, got.to_numpy()):
            assert np.array_equal(np.asarray(a), b), (rows, name)


def test_split_sharded_fused_step_matches_jax(monkeypatch):
    """``make_sharded_fused_step`` over 4 validator tiles each its own
    tensors: each tile verifies its quarter of 16 signed votes (two
    planted bad), the verdicts gathered to every tile, the tiles' counts
    decided on the home (test_fabric's case)."""
    real = tstep.make_sharded_fused_step

    def split(mesh, n, axis="validators"):
        mesh = tq.make_fabric_mesh(["cpu"] * mesh.shape[0], mesh.shape,
                                   mesh.axis_names, split=True)
        fn = real(mesh, n, axis)

        def on_tiles(state, *operands):
            tiles = tq.TileState.split(state, mesh)
            tiles, events, ok = fn(tiles, *operands)
            return tiles.join(), events, ok

        return on_tiles

    monkeypatch.setattr(tstep, "make_sharded_fused_step", split)
    fab.test_sharded_fused_step_matches_jax()


# --- the vote group on the per-tile layout -----------------------------------


class _Pkg(fab._Pkg):
    """test_torch_fabric's group driver, with ``extra`` group kwargs."""

    def __init__(self, vp, mesh, trace, **extra):
        super().__init__(vp, mesh, trace)
        self.extra = extra

    def group(self, *args, **kw):
        return super().group(*args, **kw, **self.extra)


GROUP_CASES = {
    "padding": fab._padding_case, "grid": fab._grid_case,
    "slide_reset_4": lambda pkg: fab._slide_reset_case(pkg, (4,)),
    "slide_reset_4x2": lambda pkg: fab._slide_reset_case(pkg, (4, 2)),
    "pipelined": fab._pipelined_case}


@pytest.mark.parametrize("host_eval", [False, True],
                         ids=["device_eval", "host_eval"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_split_group_matches_jax(case, host_eval):
    """test_torch_fabric's group cases (padding, the occupancy grid, a
    slide and a reset, the per-shard pipelined readback) with the port's
    group on per-tile meshes, in device and host eval, against the JAX
    group on its mesh."""
    port = _Pkg(tvp, smesh, TTrace, host_eval=host_eval)
    ref = _Pkg(jvp, jmesh, JTrace, host_eval=host_eval)
    assert GROUP_CASES[case](port) == GROUP_CASES[case](ref)


# --- a pool on the per-tile layout -------------------------------------------


POOL = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
        "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True}


def _pool(pool_cls, make_config, mesh, depth, **extra):
    pool = pool_cls(16, seed=41,
                    config=make_config(dict(POOL, ResidentTickDepth=depth)),
                    device_quorum=True, shadow_check=False, trace=True,
                    mesh=mesh, **extra)
    for i in range(30):
        pool.submit_request(i)
    pool.run_for(8)
    assert pool.honest_nodes_agree()
    group = pool.vote_group
    return {"ordered_hash": pool.ordered_hash(),
            "ordered": min(len(nd.ordered_digests) for nd in pool.nodes),
            "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
            "readbacks": group.readbacks,
            "readback_bytes_per_shard": group.readback_bytes_per_shard,
            "shards": group.shards, "flushes": group.flushes}


@pytest.mark.parametrize("depth", [1, 4])
def test_split_pool_matches_jax_mesh_pool(depth, monkeypatch):
    if depth > 1:
        copy_staging(monkeypatch)  # the JAX ring's staging race
    want = _pool(JaxPool, jax_config, jmesh((4, 2)), depth)
    got = _pool(PortPool, port_config, smesh((4, 2)), depth, device="cpu")
    assert got == want
    assert got["ordered"] >= 30 and got["shards"] == 8
    assert len(got["readback_bytes_per_shard"]) == 4


# --- lanes -------------------------------------------------------------------


def test_lane_meshes_slice_a_device_list_as_jax(monkeypatch):
    """Lane l takes the slice [2 l, 2 l + 2) of the list, as the
    reference's lanes take of ``jax.devices()``; a short list raises. The
    cards are named only (no tensor is made): the process is made to see
    eight with peer access."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    cards = [torch.device("cuda", i) for i in range(8)]
    want = jlanes.lane_meshes(4, (2,))
    got = tlanes.lane_meshes(4, (2,), devices=cards)
    for jm, tm in zip(want, got):
        assert tm.split and tm.shape == tuple(jm.devices.shape)
        assert [d.index for d in tm.tile_devices] \
            == [d.id for d in jm.devices.flat]
    with pytest.raises(ValueError):
        tlanes.lane_meshes(5, (2,), devices=cards)
    assert [m.split for m in tlanes.lane_meshes(2, (2,), device="cpu")] \
        == [False, False]


def _laned(side, lanes_mod, meshes, **kw):
    cfg = side({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
                "CHK_FREQ": 2, "LOG_SIZE": 6, "QuorumTickInterval": 0.05,
                "QuorumTickAdaptive": True})
    pool = lanes_mod.LanedPool(lanes=2, n_nodes=4, seed=7, config=cfg,
                               device_quorum=True, meshes=meshes, **kw)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(30)
    pool.seal_flush()
    return pool.ordered_hashes(), pool.sealed_fingerprint


def test_laned_pool_on_split_fabrics_matches_jax():
    """Two lanes, each a (2,) per-tile fabric on its slice of a device
    list, order as the reference's lanes on their disjoint meshes."""
    meshes = tlanes.lane_meshes(2, (2,), devices=torch_env.device_list(
        "cpu", 4), split=True)
    assert all(m.split for m in meshes)
    want = _laned(jax_config, jlanes, jlanes.lane_meshes(2, (2,)))
    got = _laned(port_config, tlanes, meshes, device="cpu")
    assert got == want
