"""The ring shift (K1) and the plane rotation (K15) in the port, on the CPU
against the JAX package on the conftest's 8 virtual CPU devices.

- ``ring_shift_plain`` / ``ring_shift_planes`` against JAX's
  ``ring_shift_reference`` on (4,) and (2, 2), for every shift 0 .. m + 1,
  on a float32 (8, 128) array and on a member-stacked VoteState
  (``tests/test_quorum_fabric.py:276-305``); a full-circle shift is the
  identity and returns its input.
- ``rotate_planes`` against JAX's for every ``rows`` in [0, M_pad),
  without a mesh, on (4,) and on (2, 2).

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
        # row r's plane moved to row (r + rows) mod M
        assert np.array_equal(got.frontier.numpy(),
                              np.roll(leaves[-1], rows))


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
