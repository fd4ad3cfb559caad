"""K8, the window's rare-path ops: the port's slide and zero against the
JAX package's ``slide_state`` (vmapped as ``compile_plan._slide_body``) and
``compile_plan._zero_body`` on seeded random vote states, bit-equal.

Deltas cover the edges the kernel must handle (0, 1, S-1, S, > S), the
pool's pattern (one sliding member, every other delta 0) and all members
sliding; masks are random. On the CPU the wrappers run their plain
versions; ``test_torch_cuda.py`` holds the ``csrc/window.cu`` kernels
against those plain versions on a card. The zero's kernel is modelled
here too: its grid over (reset member, chunk of its bytes) and
``zero_run``'s head bytes, 16-byte body and tail bytes must write each
reset member's six runs and frontier once and nothing else; the rows a
host mask passes in the launch (``zero_row_chunks``) are checked. The
slide's grid is modelled in ``test_torch_tile_cluster.py``, beside the
``slide_run`` model it uses.
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


# --- the zero's kernel (csrc/window.cu zero_rows_kernel), modelled --------

THREADS = 256  # quorum_common.cuh kThreads
ZERO_CHUNK = 16 * THREADS  # csrc/window.cu kZeroChunk
LEAVES = ("preprepare_seen", "ordered", "prepared_acked", "prepare_votes",
          "commit_votes", "checkpoint_votes")


def zero_run(counts, addr, start, length, stores):
    """``qc::zero_run`` on the ``length`` bytes at ``start`` of an
    allocation whose byte 0 sits at address ``addr``: each thread t < head
    stores byte t before the first 16-byte boundary, the body goes in
    16-byte stores, each thread t < tail stores byte t after the last
    whole word. Adds one to ``counts`` for every byte written; appends
    each 16-byte store's offset to ``stores``."""
    head = min((16 - (addr + start) % 16) % 16, length)
    body = (length - head) // 16
    tail = (length - head) % 16
    assert head < THREADS and tail < THREADS
    for t in range(head):
        counts[start + t] += 1
    for i in range(body):
        at = start + head + 16 * i
        counts[at:at + 16] += 1
        stores.append(at)
    end = start + head + 16 * body
    for t in range(tail):
        counts[end + t] += 1


def model_zero(m, n, s, c, rows, addrs):
    """The kernel's grid over (reset member, chunk of its bytes): block y
    of member r zeroes bytes [y ZERO_CHUNK, (y + 1) ZERO_CHUNK) of the six
    runs laid end to end (each run of r at r x its length in its leaf),
    block 0 also the frontier. Returns the write counts per leaf byte and
    per frontier, and the 16-byte stores' (leaf, offset)s."""
    lens = [s, s, s, n * s, n * s, n * c]
    counts = {name: np.zeros(m * ln, np.int64)
              for name, ln in zip(LEAVES, lens)}
    front = np.zeros(m, np.int64)
    stores = {name: [] for name in LEAVES}
    chunks = max(1, -(-sum(lens) // ZERO_CHUNK))
    for r in rows:
        for y in range(chunks):
            lo, hi, at = y * ZERO_CHUNK, (y + 1) * ZERO_CHUNK, 0
            for name, ln in zip(LEAVES, lens):
                a, b = max(lo, at), min(hi, at + ln)
                if a < b:
                    zero_run(counts[name], addrs[name], r * ln + a - at,
                             b - a, stores[name])
                at += ln
            if y == 0:
                front[r] += 1
    return counts, front, stores


def test_zero_run_head_body_tail():
    """``zero_run`` at every start address mod 16 and lengths 1 to 80 and
    a few long runs: every byte of the run written once, none outside,
    16-byte stores only on 16-byte boundaries and wholly inside."""
    for addr in range(16):
        for length in list(range(1, 81)) + [255, 256, 300, 4096, 4111]:
            counts = np.zeros(length + 64, np.int64)
            stores = []
            zero_run(counts, addr, 24, length, stores)
            assert (counts[24:24 + length] == 1).all(), (addr, length)
            assert counts[:24].sum() == 0 and counts[24 + length:].sum() == 0
            for at in stores:
                assert (addr + at) % 16 == 0
                assert 24 <= at and at + 16 <= 24 + length
            assert len(stores) >= (length - 30) // 16


ZERO_SHAPES = {  # (M, N, S, C): the main path's, phase B's, odd ones
    "64x64x300": (64, 64, 300, 3),
    "96x16x30": (96, 16, 30, 6),
    "5x7x13": (5, 7, 13, 2),
    "3x70x300": (3, 70, 300, 4),
}


@pytest.mark.parametrize("shape", sorted(ZERO_SHAPES))
@pytest.mark.parametrize("aligned", [True, False])
def test_zero_kernel_model_writes_each_byte_once(shape, aligned):
    """The zero's grid, modelled: each reset member's six runs and its
    frontier written exactly once, no byte of another member touched;
    leaves on 16-byte aligned addresses (the caching allocator's) and
    not. The zeroed state equals ``zero_plain``'s and JAX's
    ``_zero_body``'s."""
    m, n, s, c = ZERO_SHAPES[shape]
    rng = np.random.RandomState(sum(ZERO_SHAPES[shape]))
    mask = (rng.rand(m) < 0.4).astype(np.uint8)
    mask[[0, m - 1]] = [1, 0]
    rows = tq.zero_row_chunks(mask)[0]
    addrs = {name: 0 if aligned else 1 + 3 * i
             for i, name in enumerate(LEAVES)}
    counts, front, _ = model_zero(m, n, s, c, rows, addrs)
    leaves = _random_state(len(rows), m, n, s, c)
    for name in LEAVES:
        per = counts[name].reshape(m, -1)
        assert (per[mask == 1] == 1).all(), name
        assert (per[mask == 0] == 0).all(), name
        leaves[name].reshape(m, -1)[per.astype(bool)] = 0
    assert np.array_equal(front, mask)
    leaves["frontier"][front == 1] = 0
    plain = _torch_state(_random_state(len(rows), m, n, s, c))
    tq.zero_plain(plain, torch.from_numpy(mask))
    _assert_equal(_jax_state(leaves), plain)
    want = jcp._zero_body(_jax_state(_random_state(len(rows), m, n, s, c)),
                          jnp.asarray(mask))
    _assert_equal(want, _torch_state(leaves))


def test_zero_row_chunks():
    """The reset members' rows in row order, at most ``per_launch`` a
    launch; no chunk (no launch) for an empty mask."""
    mask = np.array([0, 1, 0, 0, 1, 1, 0, 1], np.uint8)
    for per in (1, 3, tq.ZERO_ROWS_PER_LAUNCH):
        chunks = tq.zero_row_chunks(mask, per)
        assert all(ch.dtype == np.int32 and 1 <= len(ch) <= per
                   for ch in chunks)
        assert np.concatenate(chunks).tolist() == [1, 4, 5, 7]
        assert len(chunks) == -(-4 // per)
    assert tq.zero_row_chunks(np.zeros(64, np.uint8)) == []
    assert tq.zero_row_chunks(torch.zeros(8, dtype=torch.bool)) == []
    wide = tq.zero_row_chunks(np.ones(2 * tq.ZERO_ROWS_PER_LAUNCH + 8, bool))
    assert [len(ch) for ch in wide] == [tq.ZERO_ROWS_PER_LAUNCH] * 2 + [8]
    assert np.concatenate(wide).tolist() == list(
        range(2 * tq.ZERO_ROWS_PER_LAUNCH + 8))


@pytest.mark.parametrize("members", [1, 2, 7, 96])
def test_zero_matches_jax_at_phase_b_shape(members):
    """Phase B's group (96 members, N = 16, S = 30: rows not 16-byte
    aligned, C = 6) with ``members`` members reset: the port's zero
    equals JAX's ``_zero_body``."""
    m, n, s, c = ZERO_SHAPES["96x16x30"]
    rng = np.random.RandomState(members)
    leaves = _random_state(members + 40, m, n, s, c)
    mask = np.zeros(m, np.uint8)
    mask[rng.permutation(m)[:members]] = 1
    want = jcp._zero_body(_jax_state(leaves), jnp.asarray(mask))
    tstate = _torch_state(leaves)
    tq.zero_members(tstate, torch.from_numpy(mask))
    _assert_equal(want, tstate)
    plan_state = tcp.plan_for(None, n, n, tq.ORDER_DELTA_CAP).zero(
        _torch_state(leaves), torch.from_numpy(mask.astype(bool)))
    _assert_equal(want, plan_state)
