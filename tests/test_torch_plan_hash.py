"""K11 as commit plans: the port's ``merkle_plan_hash_plain`` (the plan
kernel's plain version) and the sparse-Merkle state's device commit plans
against the JAX package on the same seeded inputs (made with numpy).

- on seeded random plans (literal-only levels, a one-level plan, a plan
  that would loop on 8 blocks of 256 threads) the plain version equals the
  plan resolved level by level through ``merkle_node_hash_plain``, through
  hashlib, and through the JAX ``merkle_node_hash_bytes`` one level at a
  time; the host seam ``merkle_plan_hash_bytes`` gives the same digests
  and refuses operands that point forward or past the literals;
- the plan encoder: offsets are the levels' widths from the bottom up,
  the levels are the bottom run of waves of at least DEVICE_MIN_BATCH
  nodes, every operand decodes back to its node's child (an earlier plan
  node or a literal), the literals are distinct;
- a port ``SparseMerkleState(commit_mode="device", device="cpu")`` equals a
  JAX ``SparseMerkleState(commit_mode="device")`` on the same batches over
  a populated tree: roots, the committed key-value nodes, and the meters
  ``wave_device_hashes``, ``wave_host_hashes`` and ``hashes_total``.

Digests and counts are compared exactly: the tolerance is 0.
"""
import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.state.sparse_merkle_state import (  # noqa: E402
    SparseMerkleState as JaxState,
)
from indy_plenum_tpu.storage.kv_store import (  # noqa: E402
    KeyValueStorageInMemory as JaxKv,
)
from indy_plenum_tpu.tpu import sha256 as js  # noqa: E402
from indy_plenum_tpu_torch.server.catchup.catchup_rep_service import (  # noqa: E402,E501
    DEVICE_MIN_BATCH,
)
from indy_plenum_tpu_torch.state import (  # noqa: E402
    sparse_merkle_state as smt,
)
from indy_plenum_tpu_torch.storage.kv_store import (  # noqa: E402
    KeyValueStorageInMemory,
)
from indy_plenum_tpu_torch.tpu import sha256 as s2  # noqa: E402


def _random_plan(seed, widths, n_lits, p_node=0.6):
    """A seeded plan: each operand an earlier level's node with
    probability ``p_node`` (never on the bottom level), else a literal."""
    rng = np.random.RandomState(seed)
    refs, offs = [], [0]
    for w in widths:
        node = (rng.rand(w, 2) < p_node) if offs[-1] \
            else np.zeros((w, 2), bool)
        earlier = rng.randint(0, max(offs[-1], 1), (w, 2))
        lit = -1 - rng.randint(0, n_lits, (w, 2))
        refs.append(np.where(node, earlier, lit))
        offs.append(offs[-1] + w)
    lits = rng.randint(0, 256, (n_lits, 32)).astype(np.uint8)
    return np.concatenate(refs).astype(np.int32), lits, offs


PLANS = {
    "one_level": ((33,), 66, 0.0),
    "literal_levels": ((40, 40, 7), 50, 0.0),
    "mixed": ((64, 40, 32, 9, 3, 1), 30, 0.6),
    "wider_than_a_block": ((1300, 600, 2), 200, 0.5),
}


def _operands(refs, lits, digests):
    def one(x):
        return digests[x] if x >= 0 else lits[-1 - x].tobytes()
    return [(one(a), one(b)) for a, b in refs]


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_plain_matches_levels_hashlib_and_jax(name):
    widths, n_lits, p_node = PLANS[name]
    refs, lits, offs = _random_plan(len(name), widths, n_lits, p_node)
    got = s2.merkle_plan_hash_plain(torch.from_numpy(refs),
                                    torch.from_numpy(lits), offs).numpy()
    # hashlib, node by node in plan order
    digests = []
    for a, b in refs:
        left, right = [digests[x] if x >= 0 else lits[-1 - x].tobytes()
                       for x in (a, b)]
        digests.append(hashlib.sha256(b"\x01" + left + right).digest())
    assert [row.tobytes() for row in got] == digests
    # level by level: the port's per-wave plain version and the JAX wave
    for lo, hi in zip(offs[:-1], offs[1:]):
        pairs = _operands(refs[lo:hi], lits, digests)
        left = np.frombuffer(b"".join(p[0] for p in pairs),
                             np.uint8).reshape(-1, 32)
        right = np.frombuffer(b"".join(p[1] for p in pairs),
                              np.uint8).reshape(-1, 32)
        wave = s2.merkle_node_hash_plain(torch.tensor(left),
                                         torch.tensor(right)).numpy()
        np.testing.assert_array_equal(wave, got[lo:hi])
        np.testing.assert_array_equal(js.merkle_node_hash_bytes(left, right),
                                      got[lo:hi])
    # the host seam the state calls
    np.testing.assert_array_equal(
        s2.merkle_plan_hash_bytes(refs, lits, offs, device="cpu"), got)


def test_plan_seam_refuses_bad_operands():
    refs, lits, offs = _random_plan(3, (8, 4), 10, 0.5)
    forward = refs.copy()
    forward[offs[1], 0] = offs[1]  # a node of its own level
    past = refs.copy()
    past[0, 1] = -1 - lits.shape[0]  # one past the literals
    for bad in (forward, past):
        with pytest.raises(ValueError):
            s2.merkle_plan_hash_bytes(bad, lits, offs, device="cpu")
    with pytest.raises(ValueError):
        s2.merkle_plan_hash_bytes(refs, lits, [1, 8, 12], device="cpu")
    with pytest.raises(ValueError):
        s2.merkle_plan_hash_bytes(refs, lits, [0] * 258, device="cpu")


def _key(i):
    return b"acct%08d" % i


def _populated(kv_cls, state_cls, n_keys=600, **kw):
    kv = kv_cls()
    state = state_cls(kv=kv, commit_mode="host", **kw)
    state.apply_batch([(_key(i), b"v%d" % i) for i in range(n_keys)])
    state.commit()
    return kv, state.committed_head_hash


def test_plan_encoder_refs_and_offsets(monkeypatch):
    """One device commit of 48 keys over a populated tree: the encoded
    plan against the waves it was built from."""
    kv, root = _populated(KeyValueStorageInMemory, smt.SparseMerkleState,
                          device="cpu")
    seen = []
    encode = smt._plan_encode

    def capture(waves, run):
        plan = encode(waves, run)
        seen.append((waves, run, plan))
        return plan

    monkeypatch.setattr(smt, "_plan_encode", capture)
    state = smt.SparseMerkleState(kv=kv, initial_root=root,
                                  commit_mode="device", device="cpu")
    state.apply_batch([(_key(5000 + 3 * i), b"n%d" % i) for i in range(48)])
    (waves, run, (refs, lits, offsets)), = seen
    nonempty = [lv for lv in range(smt.DEPTH - 1, -1, -1) if waves[lv]]
    assert run == nonempty[:len(run)]
    assert all(len(waves[lv]) >= DEVICE_MIN_BATCH for lv in run)
    assert len(run) == len(nonempty) \
        or len(waves[nonempty[len(run)]]) < DEVICE_MIN_BATCH
    assert offsets == list(np.cumsum([0] + [len(waves[lv]) for lv in run]))
    assert refs.dtype == np.int32 and refs.shape == (offsets[-1], 2)
    assert len({row.tobytes() for row in lits}) == lits.shape[0]
    i = 0
    for level_i, level in enumerate(run):
        for pn in waves[level]:
            assert pn.index == i
            for ref, child in zip(refs[i], (pn.left, pn.right)):
                if isinstance(child, smt._PlanNode):
                    assert 0 <= ref < offsets[level_i]
                    assert ref == child.index
                else:
                    assert ref < 0 and lits[-1 - ref].tobytes() == child
            i += 1
    assert state.wave_device_hashes == offsets[-1]


def test_device_commit_plans_match_jax_device_waves():
    """The port's device mode (one commit plan per batch, the plain K11
    on the CPU) against the JAX state's device mode (one XLA wave per
    level): equal roots, committed nodes and meters."""
    port_kv, root = _populated(KeyValueStorageInMemory,
                               smt.SparseMerkleState, device="cpu")
    jax_kv, jax_root = _populated(JaxKv, JaxState)
    assert root == jax_root
    port = smt.SparseMerkleState(kv=port_kv, initial_root=root,
                                 commit_mode="device", device="cpu")
    ref = JaxState(kv=jax_kv, initial_root=root, commit_mode="device")
    batches = [[(_key(7000 + i), b"a%d" % i) for i in range(40)],
               [(_key(2 * i), None if i % 5 == 0 else b"b%d" % i)
                for i in range(36)]]
    for batch in batches:
        assert port.apply_batch(batch) == ref.apply_batch(batch)
        port.commit()
        ref.commit()
        assert port.committed_head_hash == ref.committed_head_hash
    for name in ("wave_device_hashes", "wave_host_hashes", "hashes_total"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.wave_device_hashes > 0 and port.wave_host_hashes > 0
    assert dict(port_kv.iterator()) == dict(jax_kv.iterator())
