"""The port's sparse-Merkle state against the JAX package's on the same
seeded write sets, and its device waves (K11's plain version on the CPU)
against its host waves.

- ``set``/``remove``/``apply_batch``/``commit``/revert and the batch
  overlay at about 2,000 keys, host waves: every working and committed
  root equal to JAX's;
- one ``apply_batch`` of >= 40 distinct keys in ``device`` mode on the CPU
  gives the host root, with the waves counted on the device side;
- ``run_commit_arms(n_keys=2000, windows=3)`` gives JAX's ``final_root``
  and hash counts;
- the state raises without a card unless ``device="cpu"``.
"""
import random

import pytest
import torch

from indy_plenum_tpu.simulation.state_commit_bench import (
    run_commit_arms as jax_arms,
)
from indy_plenum_tpu.state.sparse_merkle_state import (
    SparseMerkleState as JaxState,
)
from indy_plenum_tpu_torch.simulation.state_commit_bench import (
    run_commit_arms,
)
from indy_plenum_tpu_torch.state.sparse_merkle_state import (
    EMPTY_ROOT,
    SparseMerkleState,
)
from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice


def _key(i):
    return b"acct%08d" % i


def _script(seed=5, n_keys=2000):
    """A seeded sequence of state operations: a populate in batches, then
    mixed single writes, removes, batched windows (some with repeated
    keys), speculative batches reverted, and commits."""
    rng = random.Random(seed)
    ops = []
    for lo in range(0, n_keys, 500):
        ops.append(("batch", [(_key(i), b"init%d" % i)
                              for i in range(lo, min(lo + 500, n_keys))]))
        ops.append(("commit", None))
    for w in range(6):
        for _ in range(5):
            k = _key(rng.randrange(n_keys))
            if rng.random() < 0.3:
                ops.append(("remove", k))
            else:
                ops.append(("set", (k, b"s%d" % rng.randrange(1 << 20))))
        writes = [(_key(rng.randrange(n_keys if rng.random() < 0.5 else 40)),
                   None if rng.random() < 0.1 else b"w%d" % i)
                  for i in range(60)]
        ops.append(("batch", writes))
        if w % 3 == 1:
            ops.append(("overlay", writes[:20]))
        if w % 2:
            ops.append(("revert", None))
        else:
            ops.append(("commit", None))
    return ops


def _drive(state, ops):
    roots = []
    for kind, arg in ops:
        if kind == "batch":
            state.apply_batch(arg)
        elif kind == "set":
            state.set(*arg)
        elif kind == "remove":
            state.remove(arg)
        elif kind == "overlay":
            assert state.begin_batch()
            for k, v in arg:
                if v is None:
                    state.remove(k)
                else:
                    state.set(k, v)
            assert state.get(arg[-1][0]) == arg[-1][1]
            state.flush_batch()
        elif kind == "commit":
            state.commit()
        elif kind == "revert":
            state.revert_to_head()
        roots.append((state.head_hash, state.committed_head_hash))
    return roots, state.hashes_total


def test_smt_matches_jax_host_waves():
    ops = _script()
    port = SparseMerkleState(commit_mode="host", device="cpu")
    ref = JaxState(commit_mode="host")
    got, got_hashes = _drive(port, ops)
    want, want_hashes = _drive(ref, ops)
    assert got == want
    assert got_hashes == want_hashes
    assert got[-1][1] != EMPTY_ROOT
    rng = random.Random(1)
    for _ in range(50):
        k = _key(rng.randrange(2000))
        assert port.get(k, is_committed=True) == ref.get(k, is_committed=True)
    # a historical root stays readable; set_head_hash is the LIFO revert
    old = got[3][1]
    port.set_head_hash(old)
    ref.set_head_hash(old)
    assert port.head_hash == ref.head_hash == old
    # state proofs (members and non-members, at the committed and at a
    # historical root): the JAX state's wire bytes and verdicts
    from indy_plenum_tpu.state.sparse_merkle_state import \
        verify_state_proof as jax_verify
    from indy_plenum_tpu_torch.state.sparse_merkle_state import \
        verify_state_proof as port_verify

    root = port.committed_head_hash
    for k in (_key(rng.randrange(4000)) for _ in range(12)):
        value = port.get(k, is_committed=True)
        proof = port.generate_state_proof(k)
        assert proof == ref.generate_state_proof(k)
        assert port.generate_state_proof(k, root=old) == \
            ref.generate_state_proof(k, root=old)
        assert port_verify(root, k, value, proof) is True
        for v in (value, b"forged", None):
            assert port_verify(root, k, v, proof) == \
                jax_verify(root, k, v, proof)


def test_device_waves_on_cpu_give_the_host_root():
    """One batch of 40 distinct keys over a populated tree (host waves):
    device waves (the plain K11) against host waves, the same root and
    hash count, and JAX's root."""
    from indy_plenum_tpu_torch.storage.kv_store import KeyValueStorageInMemory

    kv = KeyValueStorageInMemory()
    base = SparseMerkleState(kv=kv, commit_mode="host", device="cpu")
    base.apply_batch([(_key(i), b"v%d" % i) for i in range(300)])
    base.commit()
    writes = [(_key(1000 + 7 * i), b"d%d" % i) for i in range(40)]
    roots, hashes = [], []
    for mode in ("host", "device"):
        state = SparseMerkleState(kv=kv, initial_root=base.committed_head_hash,
                                  commit_mode=mode, device="cpu")
        roots.append(state.apply_batch(writes))
        hashes.append(state.hashes_total)
        assert (state.wave_device_hashes > 0) == (mode == "device")
    assert roots[0] == roots[1]
    assert hashes[0] == hashes[1]
    ref = JaxState(commit_mode="host")
    ref.apply_batch([(_key(i), b"v%d" % i) for i in range(300)])
    ref.commit()
    assert ref.apply_batch(writes) == roots[0]


def test_commit_arms_match_jax():
    arms = ("sequential", "host")
    got = run_commit_arms(n_keys=2000, windows=3, arms=arms, device="cpu")
    want = jax_arms(n_keys=2000, windows=3, arms=arms)
    assert got["roots_identical"] and want["roots_identical"]
    assert got["final_root"] == want["final_root"]
    for arm in arms:
        assert got["arms"][arm]["hashes_per_commit"] \
            == want["arms"][arm]["hashes_per_commit"]
    assert got["hash_reduction"] == want["hash_reduction"]


def test_state_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        SparseMerkleState()
    with pytest.raises(NoCudaDevice):
        SparseMerkleState(commit_mode="device", device="cuda")
    SparseMerkleState(device="cpu")
