"""The ring shift (K1) and the plane rotation (K15) in the port, on the CPU
against the JAX package on the conftest's 8 virtual CPU devices.

- ``ring_shift_plain`` / ``ring_shift_planes`` against JAX's
  ``ring_shift_reference`` on (4,) and (2, 2), for every shift 0 .. m + 1,
  on a float32 (8, 128) array and on a member-stacked VoteState
  (``tests/test_quorum_fabric.py:276-305``); a full-circle shift is the
  identity and returns its input.
- ``rotate_planes`` against JAX's and ``rotate_planes_plain`` (the
  reference's arms and merge) for every ``rows`` in [0, M_pad), without a
  mesh, on (4,) and on (2, 2); with the merge made to raise, the port's
  rotation still gives the same planes, through one roll.
- K1's kernel (``csrc/ring.cu`` ``ring_shift_launch`` and
  ``ring_shift_kernel``), modelled: granules, the two segments a leaf,
  one row of blocks a segment walking its tiles, on leaves of granule 16,
  4 and 1.

Every comparison is exact (the ring moves bytes).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu.tpu import rebalance as jrb  # noqa: E402
from indy_plenum_tpu.tpu import ring_exchange as jrx  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402
from indy_plenum_tpu_torch.tpu import rebalance as trb  # noqa: E402
from indy_plenum_tpu_torch.tpu import ring_exchange as trx  # noqa: E402

SHAPES = [(4,), (2, 2)]


def _meshes(shape):
    return (jq.make_fabric_mesh(jax.devices()[:8], shape),
            tq.make_fabric_mesh(["cpu"] * 8, shape))


def _stack(rng, m=8, n=4, s=6, c=2):
    """A member-stacked VoteState of random leaves (numpy)."""
    def bits(*shape):
        return (rng.rand(*shape) < 0.5).astype(np.uint8)

    return [bits(m, s), bits(m, n, s), bits(m, n, s), bits(m, n, c),
            bits(m, s), bits(m, s), rng.randint(0, 99, m).astype(np.int32)]


def _same(jout, tout):
    jl = jout if isinstance(jout, tuple) else (jout,)
    tl = tout if isinstance(tout, tuple) else (tout,)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=["4", "2x2"])
def test_ring_shift_matches_jax(shape):
    jmesh, tmesh = _meshes(shape)
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(8, 128).astype(np.float32)
    leaves = _stack(rng)
    for shift in range(shape[0] + 2):
        want = jrx.ring_shift_reference(jnp.asarray(x), jmesh, shift)
        _same(want, trx.ring_shift_plain(torch.from_numpy(x), tmesh, shift))
        _same(want, trx.ring_shift_planes(torch.from_numpy(x), tmesh,
                                          shift))
        jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
        tstate = tq.VoteState(*[torch.from_numpy(a) for a in leaves])
        want = jrx.ring_shift_reference(jstate, jmesh, shift)
        got = trx.ring_shift_planes(tstate, tmesh, shift)
        assert isinstance(got, tq.VoteState)
        _same(tuple(want), tuple(got))
    # the reference's own check: the frontier's blocks move right
    frontier = torch.arange(4, dtype=torch.int32)
    state = tq.VoteState(*[torch.from_numpy(a[:4]) for a in leaves[:6]],
                         frontier)
    if shape == (2, 2):
        moved = trx.ring_shift_planes(state, tmesh, 1)
        assert moved.frontier.tolist() == [2, 3, 0, 1]
    # a full circle is the identity and returns its input
    assert trx.ring_shift_planes(state, tmesh, shape[0]) is state


@pytest.mark.parametrize("shape", [None] + SHAPES,
                         ids=["no_mesh", "4", "2x2"])
def test_rotate_planes_matches_jax(shape):
    rng = np.random.RandomState(31)
    leaves = _stack(rng)
    if shape is None:
        jmesh = tmesh = None
        shard_rows = 8
    else:
        jmesh, tmesh = _meshes(shape)
        shard_rows = 8 // shape[0]
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    tstate = tq.VoteState(*[torch.from_numpy(a) for a in leaves])
    for rows in range(8):
        want = jrb.rotate_planes(jstate, jmesh, rows, shard_rows)
        got = trb.rotate_planes(tstate, tmesh, rows, shard_rows)
        _same(tuple(want), tuple(got))
        _same(tuple(want), tuple(trb.rotate_planes_plain(
            tstate, tmesh, rows, shard_rows)))
        # row r's plane moved to row (r + rows) mod M
        assert np.array_equal(got.frontier.numpy(),
                              np.roll(leaves[-1], rows))
    assert trb.rotate_planes(tstate, tmesh, 0, shard_rows) is tstate
    assert trb.rotate_planes(tstate, tmesh, 8, shard_rows) is tstate


@pytest.mark.parametrize("shape", [None] + SHAPES,
                         ids=["no_mesh", "4", "2x2"])
def test_rotate_planes_takes_no_merge(shape, monkeypatch):
    """Every tile of a port mesh is on one card, so the rotation is ONE
    roll of every leaf (``ring_shift_rows``) and no merge: with both
    merges made to raise, ``rotate_planes`` still returns JAX's planes."""
    rng = np.random.RandomState(37)
    leaves = _stack(rng)
    if shape is None:
        jmesh = tmesh = None
        shard_rows = 8
    else:
        jmesh, tmesh = _meshes(shape)
        shard_rows = 8 // shape[0]

    def refuse(*args, **kwargs):
        raise AssertionError("the one-card rotation merged")

    rolls = []
    roll = trb.ring_shift_rows

    def spy(states, rows):
        rolls.append(rows)
        return roll(states, rows)

    monkeypatch.setattr(trb, "rotate_merge", refuse)
    monkeypatch.setattr(trb, "rotate_merge_plain", refuse)
    monkeypatch.setattr(trb, "ring_shift_rows", spy)
    jstate = jq.VoteState(*[jnp.asarray(a) for a in leaves])
    tstate = tq.VoteState(*[torch.from_numpy(a) for a in leaves])
    for rows in range(1, 8):
        want = jrb.rotate_planes(jstate, jmesh, rows, shard_rows)
        got = trb.rotate_planes(tstate, tmesh, rows, shard_rows)
        _same(tuple(want), tuple(got))
    assert rolls == list(range(1, 8))


def test_rotate_merge_takes_the_arms_rows():
    """K15's plain version on its own: shard-local rows r >= s from arm A
    shifted down by s, rows r < s from arm B's row r - s + R."""
    a = torch.arange(8, dtype=torch.int32) * 10
    b = torch.arange(8, dtype=torch.int32) * 100
    out = trb.rotate_merge_plain(a, b, 1, 4)
    assert out.tolist() == [300, 0, 10, 20, 700, 40, 50, 60]
    with pytest.raises(ValueError):
        trb.rotate_merge_plain(a, b, 1, 3)


def test_ring_refuses_other_devices():
    mesh = tq.make_fabric_mesh(["cpu"] * 4, (4,))
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        trx.ring_shift_planes(meta, mesh, 1)
    with pytest.raises(ValueError):
        trb.rotate_merge(meta, meta, 1, 2)


# --- K1's kernel (csrc/ring.cu), modelled ------------------------------------

RING_THREADS = 256  # csrc/ring.cu kRingThreads
RING_LOADS = 2  # csrc/ring.cu kRingLoads
RING_TILE = RING_THREADS * RING_LOADS
MAX_BLOCKS = 1024  # csrc/ring.cu kMaxBlocks


def granule_of(values):
    """``granule_of``: the widest of 16, 4 and 1 that divides them all."""
    for g in (16, 4):
        if all(v % g == 0 for v in values):
            return g
    return 1


def ring_table(leaves, rows, shift_rows):
    """``ring_shift_launch``'s table and grid: per leaf (src address, dst
    address, row bytes), its two segments ``dst[offset:] <- src[:total -
    offset]`` and ``dst[:offset] <- src[total - offset:]`` in its granule,
    empty ones dropped, and the grid (blocks a row, one row a segment).
    A segment is (leaf, src byte, dst byte, units, granule)."""
    sr = shift_rows % rows
    segments = []
    for leaf, (src, dst, row_bytes) in enumerate(leaves):
        total, offset = row_bytes * rows, row_bytes * sr
        g = granule_of((src, dst, total, offset))
        for s_at, d_at, nbytes in ((0, offset, total - offset),
                                   (total - offset, 0, offset)):
            units = nbytes // g
            if units > 0:
                segments.append((leaf, s_at, d_at, units, g))
    most = max((units for *_, units, _ in segments), default=0)
    tiles = -(-most // RING_TILE)
    per_block = max(-(-tiles // MAX_BLOCKS), 1)
    return segments, (-(-tiles // per_block) if tiles else 1, len(segments))


def model_ring(leaves, data, rows, shift_rows, grid_x=None):
    """``ring_shift_kernel`` on its grid (or on ``grid_x`` blocks a row):
    row y copies segment y, block x walks tiles x, x + grid_x, ... of it,
    and each thread copies units threadIdx + j x THREADS (j < LOADS) of
    the tile that lie below the segment's end. Returns the outputs and
    per-leaf write counts."""
    segments, grid = ring_table(leaves, rows, shift_rows)
    grid_x = grid[0] if grid_x is None else grid_x
    outs = [np.zeros_like(x) for x in data]
    counts = [np.zeros(x.size, np.int64) for x in data]
    for leaf, s_at, d_at, units, g in segments:
        tiles = -(-units // RING_TILE)
        for block in range(grid_x):
            for tile in range(block, tiles, grid_x):
                base = tile * RING_TILE
                left = min(units - base, RING_TILE)
                assert 0 < left <= RING_TILE
                for j in range(RING_LOADS):
                    i = np.arange(RING_THREADS) + j * RING_THREADS
                    i = i[i < left]
                    for byte in range(g):
                        src = s_at + (base + i) * g + byte
                        dst = d_at + (base + i) * g + byte
                        outs[leaf][dst] = data[leaf][src]
                        np.add.at(counts[leaf], dst, 1)
    return outs, counts


# leaves of (row bytes, source address mod 16): granule 16 where rows of
# 48 bytes rotate by whole rows from aligned addresses, 4 for the int32
# frontier and an address 4 past a boundary, 1 for odd rows
RING_LEAVES = {
    "granule16": [(48, 0), (160, 0)],
    "granule4": [(4, 0), (48, 4)],
    "granule1": [(15, 0), (3, 0), (48, 1)],
}


@pytest.mark.parametrize("kind", sorted(RING_LEAVES))
@pytest.mark.parametrize("shift", [0, 1, 63, 64])
def test_ring_kernel_model_rolls_each_byte_once(kind, shift):
    """K1's split at 64 member rows, shifts 0, 1, n - 1 and n (n = 64), on
    its own grid and on rows of 1 and 2 blocks a segment (each block then
    walks several tiles): every byte of every leaf written exactly once,
    the result ``np.roll`` of the rows, each leaf moved in the granule its
    addresses, size and offset allow."""
    rows = 64
    rng = np.random.RandomState(len(kind) + shift)
    specs = RING_LEAVES[kind]
    data = [rng.randint(0, 256, rows * rb).astype(np.uint8)
            for rb, _ in specs]
    leaves = [(4096 * (i + 1) + at, 65536 * (i + 1) + at, rb)
              for i, (rb, at) in enumerate(specs)]
    segments, _ = ring_table(leaves, rows, shift)
    want_g = {"granule16": 16, "granule4": 4, "granule1": 1}[kind]
    assert min(g for *_, g in segments) == want_g or shift % rows == 0
    for grid_x in (None, 1, 2):
        outs, counts = model_ring(leaves, data, rows, shift, grid_x)
        for (rb, _), x, out, cnt in zip(specs, data, outs, counts):
            assert (cnt == 1).all()
            want = np.roll(x.reshape(rows, rb), shift, axis=0)
            assert np.array_equal(out.reshape(rows, rb), want)


def state_leaves(m, n, s, c):
    """(src, dst, row bytes) of a member-stacked VoteState's leaves at
    16-byte aligned addresses, as the caching allocator gives them."""
    row_bytes = [s, n * s, n * s, n * c, s, s, 4]
    return [((1 << 20) * (i + 1), (1 << 30) + (1 << 20) * (i + 1), rb)
            for i, rb in enumerate(row_bytes)]


def test_ring_table_matches_the_shapes_the_path_gives():
    """At phase H's state (M = N = 256, S = 300, C = 3) every plane rolled
    by a ring step of (8,), the int32 frontier too, moves in 16-byte
    granules, 14 segments covering every byte once; the longest segment
    has more tiles than a row's kMaxBlocks, so its blocks stride, each
    over the same count of tiles (2,100 tiles, 700 blocks of 3); an
    identity roll is one segment a leaf. At phase R's state (M = N = 64,
    S = 15, C = 3 on (4, 2)) a row's blocks are one a tile, none
    striding."""
    m = 256
    leaves = state_leaves(m, 256, 300, 3)
    segments, grid = ring_table(leaves, m, m // 8)
    assert [g for *_, g in segments] == [16] * 14
    assert sum(units * g for _, _, _, units, g in segments) == sum(
        rb * m for _, _, rb in leaves)
    tiles = -(-max(units for *_, units, _ in segments) // RING_TILE)
    assert tiles == 2100 > MAX_BLOCKS and grid == (700, 14)
    assert tiles % grid[0] == 0
    same, grid = ring_table(leaves, m, 0)
    assert len(same) == len(leaves) and grid[1] == len(leaves)
    r_leaves = state_leaves(64, 64, 15, 3)
    for shift in (16, 8):
        segments, (grid_x, rows) = ring_table(r_leaves, 64, shift)
        assert rows == len(segments) == 14
        assert grid_x == max(-(-units // RING_TILE)
                             for *_, units, _ in segments) < MAX_BLOCKS
