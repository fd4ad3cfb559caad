"""K8, the window's rare-path ops: the port's slide and zero against the
JAX package's ``slide_state`` (vmapped as ``compile_plan._slide_body``) and
``compile_plan._zero_body`` on seeded random vote states, bit-equal.

Deltas cover the edges the kernel must handle (0, 1, S-1, S, > S), the
pool's pattern (one sliding member, every other delta 0) and all members
sliding; masks are random. On the CPU the wrappers run their plain
versions; ``test_torch_cuda.py`` holds the ``csrc/window.cu`` kernels
against those plain versions on a card.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import compile_plan as jcp  # noqa: E402
from indy_plenum_tpu.tpu import quorum as jq  # noqa: E402
from indy_plenum_tpu_torch.tpu import compile_plan as tcp  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402

M, N, S, C = 8, 7, 24, 3


def _random_state(seed, m=M, n=N, s=S, c=C):
    """numpy leaves by field name: random 0/1 votes, frontiers in [0, S]."""
    rng = np.random.RandomState(seed)

    def bits(*shape):
        return (rng.rand(*shape) < 0.4).astype(np.uint8)

    return {"preprepare_seen": bits(m, s), "prepare_votes": bits(m, n, s),
            "commit_votes": bits(m, n, s), "checkpoint_votes": bits(m, n, c),
            "ordered": bits(m, s), "prepared_acked": bits(m, s),
            "frontier": rng.randint(0, s + 1, m).astype(np.int32)}


def _jax_state(leaves):
    return jq.VoteState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def _torch_state(leaves, device="cpu"):
    return tq.VoteState(**{k: torch.from_numpy(v.copy()).to(device)
                           for k, v in leaves.items()})


def _assert_equal(jstate, tstate):
    for name in tq.VoteState._fields:
        got = getattr(tstate, name).cpu().numpy()
        want = np.asarray(getattr(jstate, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


DELTAS = {
    "edges": [0, 1, S - 1, S, S + 5, 0, 3, 2 * S],
    "one_member": [0, 0, 0, 5, 0, 0, 0, 0],
    "all_members": [1, 2, 3, 5, 8, 13, 21, 4],
    "none": [0] * M,
}


@pytest.mark.parametrize("case", sorted(DELTAS))
@pytest.mark.parametrize("seed", [3, 17])
def test_slide_matches_jax(case, seed):
    leaves = _random_state(seed)
    deltas = np.asarray(DELTAS[case], np.int32)
    want = jcp._slide_body(_jax_state(leaves), jnp.asarray(deltas))
    tstate = _torch_state(leaves)
    tq.slide_state(tstate, torch.from_numpy(deltas))
    _assert_equal(want, tstate)
    # the grouped plan's slide is the same op
    plan_state = tcp.plan_for(None, N, N, tq.ORDER_DELTA_CAP).slide(
        _torch_state(leaves), torch.from_numpy(deltas))
    _assert_equal(want, plan_state)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_zero_matches_jax(seed):
    leaves = _random_state(seed)
    mask = (np.random.RandomState(seed + 100).rand(M) < 0.5).astype(np.uint8)
    mask[seed % M] = 1
    want = jcp._zero_body(_jax_state(leaves), jnp.asarray(mask))
    tstate = _torch_state(leaves)
    tq.zero_members(tstate, torch.from_numpy(mask))
    _assert_equal(want, tstate)
    untouched = _torch_state(leaves)
    tq.zero_members(untouched, torch.zeros(M, dtype=torch.bool))
    _assert_equal(_jax_state(leaves), untouched)


def test_standalone_plane_slide_matches_jax():
    """The single plane's slide (``DeviceVotePlane.slide_to``) shifts its
    one member by the window delta, as the reference's ``_slide``."""
    leaves = _random_state(9, m=1)
    for delta in (1, S - 1, S, S + 2):
        want = jq.slide_state(_jax_state({k: v[0] for k, v in
                                          leaves.items()}), delta)
        tstate = _torch_state(leaves)
        tq.slide_state(tstate, torch.tensor([delta], dtype=torch.int32))
        for name in tq.VoteState._fields:
            np.testing.assert_array_equal(
                getattr(tstate, name)[0].numpy(),
                np.asarray(getattr(want, name)), err_msg=name)
