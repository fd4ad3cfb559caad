"""K10-K12: the port's SHA-256 kernels' plain versions against the JAX
package's ``tpu/sha256.py`` on XLA:CPU and against hashlib, on the same
seeded inputs (made with numpy).

- K12 ``sha256_fixed`` at every padding edge (the lengths ``chip_smoke.py``
  holds the kernel at);
- K11 ``merkle_node_hash`` and the state's host seam
  ``merkle_node_hash_bytes`` at wave widths around the offload floor;
- K10 ``verify_audit_paths`` (dense) and ``verify_audit_paths_indexed`` on
  a 1,024-leaf tree with planted faults (a flipped leaf byte, a wrong
  index, a path one node short, one node long, a wrong root): verdicts
  equal to JAX's and to the host ``MerkleVerifier``;
- ``pack_audit_batch`` and ``verify_audit_paths_batch``: the port packs
  without the reference's XLA padding, so the packed arrays differ and
  the verdicts are compared, a path deeper than 48 levels included.

Digests are compared exactly: the tolerance is 0.
"""
import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.ledger.compact_merkle_tree import (  # noqa: E402
    CompactMerkleTree as JaxTree,
)
from indy_plenum_tpu.server.catchup import (  # noqa: E402
    catchup_rep_service as jcrs,
)
from indy_plenum_tpu.tpu import sha256 as js  # noqa: E402
from indy_plenum_tpu_torch.ledger.merkle_verifier import (  # noqa: E402
    STH,
    MerkleVerifier,
)
from indy_plenum_tpu_torch.server.catchup import (  # noqa: E402
    catchup_rep_service as crs,
)
from indy_plenum_tpu_torch.tpu import sha256 as s2  # noqa: E402

LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 128, 200)
WAVES = (1, 31, 32, 33, 257)
_jax_fixed = jax.jit(js.sha256_fixed, static_argnums=1)


@pytest.mark.parametrize("length", LENGTHS)
def test_sha256_fixed_matches_jax_and_hashlib(length):
    rng = np.random.RandomState(length)
    msgs = rng.randint(0, 256, (16, length)).astype(np.uint8)
    got = s2.sha256_fixed(torch.from_numpy(msgs), length).numpy()
    want = np.asarray(_jax_fixed(jnp.asarray(msgs), length))
    np.testing.assert_array_equal(got, want)
    for row, dig in zip(msgs, got):
        assert dig.tobytes() == hashlib.sha256(row.tobytes()).digest()


@pytest.mark.parametrize("n", WAVES)
def test_merkle_node_hash_matches_jax_and_hashlib(n):
    rng = np.random.RandomState(100 + n)
    left = rng.randint(0, 256, (n, 32)).astype(np.uint8)
    right = rng.randint(0, 256, (n, 32)).astype(np.uint8)
    got = s2.merkle_node_hash(torch.from_numpy(left),
                              torch.from_numpy(right)).numpy()
    want = np.asarray(js.merkle_node_hash_batch(jnp.asarray(left),
                                                jnp.asarray(right)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        s2.merkle_node_hash_bytes(left, right, device="cpu"),
        js.merkle_node_hash_bytes(left, right))
    for a, b, dig in zip(left, right, got):
        assert dig.tobytes() == hashlib.sha256(
            b"\x01" + a.tobytes() + b.tobytes()).digest()


def _corpus(n_leaves=1024, first=300, count=256, seed=3):
    rng = np.random.RandomState(seed)
    leaves = [rng.bytes(64) for _ in range(n_leaves)]
    tree = JaxTree()
    tree.extend(leaves)
    idx = list(range(first, first + count))
    return (tree, [leaves[i] for i in idx], idx,
            [tree.audit_path(i) for i in idx])


def _planted(seed=9):
    """The corpus with one fault of each kind on every fifth proof, and
    the per-row tree sizes and roots (a wrong root is per row)."""
    tree, leaf_data, indices, paths = _corpus()
    rng = np.random.RandomState(seed)
    n = len(leaf_data)
    sizes = [tree.tree_size] * n
    roots = [tree.root_hash] * n
    kinds = {}
    for i in range(0, n, 5):
        kind = (i // 5) % 5
        if kind == 0:
            buf = bytearray(leaf_data[i])
            buf[rng.randint(64)] ^= 1 << rng.randint(8)
            leaf_data[i] = bytes(buf)
        elif kind == 1:
            indices[i] += 1
        elif kind == 2:
            paths[i] = paths[i][:-1]
        elif kind == 3:
            paths[i] = paths[i] + [rng.bytes(32)]
        else:
            buf = bytearray(roots[i])
            buf[rng.randint(32)] ^= 1
            roots[i] = bytes(buf)
        kinds[i] = kind
    return leaf_data, indices, paths, sizes, roots, kinds


def _operands(leaf_data, indices, paths, sizes, roots):
    n = len(leaf_data)
    depth = max(len(p) for p in paths)
    from indy_plenum_tpu_torch.ledger.tree_hasher import TreeHasher

    hasher = TreeHasher()
    leaf = np.stack([np.frombuffer(hasher.hash_leaf(d), np.uint8)
                     for d in leaf_data])
    dense = np.zeros((n, depth, 32), np.uint8)
    for i, p in enumerate(paths):
        dense[i, :len(p)] = np.frombuffer(b"".join(p),
                                          np.uint8).reshape(-1, 32)
    return (leaf, np.asarray(indices, np.int32), dense,
            np.asarray([len(p) for p in paths], np.int32),
            np.asarray(sizes, np.int32),
            np.stack([np.frombuffer(r, np.uint8) for r in roots]))


def test_audit_fold_matches_jax_and_verifier_with_planted_faults():
    leaf_data, indices, paths, sizes, roots, kinds = _planted()
    ops = _operands(leaf_data, indices, paths, sizes, roots)
    verifier = MerkleVerifier()
    expect = np.array([verifier.verify_leaf_inclusion(
        d, i, p, STH(tree_size=s, sha256_root_hash=r))
        for d, i, p, s, r in zip(leaf_data, indices, paths, sizes, roots)])
    assert not expect[list(kinds)].any()
    assert np.delete(expect, list(kinds)).all()
    assert set(kinds.values()) == set(range(5))
    # dense
    got = s2.verify_audit_paths(*[torch.from_numpy(a) for a in ops])
    want = np.asarray(js.verify_audit_paths(*[jnp.asarray(a) for a in ops]))
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(want, expect)
    # indexed: the port's unpadded node table, verdicts against JAX's
    leaf, idx, _, plen, ts, root = ops
    packed = crs.pack_audit_batch(leaf_data, indices, paths, sizes[0],
                                  roots[0])
    table, path_idx = packed[2], packed[3]
    got_idx = s2.verify_audit_paths_indexed(*[torch.from_numpy(a) for a in (
        leaf, idx, table, path_idx, plen, ts, root)])
    np.testing.assert_array_equal(got_idx.numpy(), expect)
    jpacked = jcrs.pack_audit_batch(leaf_data, indices, paths, sizes[0],
                                    roots[0])
    n = len(leaf_data)
    jroot = np.array(jpacked[6])
    jroot[:n] = root
    want_idx = np.asarray(js.verify_audit_paths_indexed(
        *[jnp.asarray(a) for a in jpacked[:6]], jnp.asarray(jroot)))[:n]
    np.testing.assert_array_equal(want_idx, expect)


def test_pack_and_batch_verify_match_jax_verdicts():
    tree, leaf_data, indices, paths = _corpus(seed=4)
    size, root = tree.tree_size, tree.root_hash
    port = crs.pack_audit_batch(leaf_data, indices, paths, size, root)
    ref = jcrs.pack_audit_batch(leaf_data, indices, paths, size, root)
    n = len(leaf_data)
    # no padding in the port: the batch at its own size and depth
    assert port[0].shape == (n, 32)
    assert port[3].shape == (n, max(len(p) for p in paths))
    assert ref[0].shape[0] >= n
    got = s2.verify_audit_paths_indexed(*[torch.from_numpy(a)
                                          for a in port]).numpy()
    want = np.asarray(js.verify_audit_paths_indexed(
        *[jnp.asarray(a) for a in ref]))[:n]
    np.testing.assert_array_equal(got, want)
    assert got.all()
    # a path deeper than 48 levels: no packing, the whole chunk False
    deep = list(paths)
    deep[5] = deep[5] + [b"\x00" * 32] * 40
    assert crs.pack_audit_batch(leaf_data, indices, deep, size, root) is None
    assert jcrs.pack_audit_batch(leaf_data, indices, deep, size, root) \
        is None
    for mode in ("device", "host"):
        got = crs.verify_audit_paths_batch(leaf_data, indices, paths, size,
                                           root, mode=mode, device="cpu")
        want = jcrs.verify_audit_paths_batch(leaf_data, indices, paths,
                                             size, root, mode="host")
        np.testing.assert_array_equal(got, want)
    bad = crs.verify_audit_paths_batch(leaf_data, indices, deep, size, root,
                                       mode="device", device="cpu")
    assert bad.shape == (n,) and not bad.any()


def test_one_leaf_tree_and_tiny_batches():
    """Empty paths (a one-leaf tree) pack to a zero-depth batch; batches
    below the device floor verify on the host, as in the reference."""
    tree = JaxTree()
    tree.append(b"only")
    ok = crs.verify_audit_paths_batch(
        [b"only"] * 40, [0] * 40, [[]] * 40, 1, tree.root_hash,
        mode="device", device="cpu")
    assert ok.all()
    tree, leaf_data, indices, paths = _corpus(count=8)
    got = crs.verify_audit_paths_batch(leaf_data, indices, paths,
                                       tree.tree_size, tree.root_hash,
                                       mode="device", device="cpu")
    assert got.all() and got.shape == (8,)


def test_fold_shifts_run_to_completion_as_the_verifier_does():
    """The last leaf of a 2^17 + 1 tree: its one-node path needs 17 index
    shifts at the first level. The port's fold runs them all, as
    ``MerkleVerifier`` does; the reference unrolls the shift its padded
    depth (16) times and rejects this valid proof (ROADMAP Queue 3).
    The port's and the reference's verdicts must still differ here: once
    the reference is fixed, this fails and the departure can go."""
    n = (1 << 17) + 1
    tree = JaxTree()
    tree.extend([b"%d" % i for i in range(n)])
    leaf, path = b"%d" % (n - 1), tree.audit_path(n - 1)
    assert len(path) == 1
    assert MerkleVerifier().verify_leaf_inclusion(
        leaf, n - 1, path, STH(tree_size=n, sha256_root_hash=tree.root_hash))
    args = ([leaf] * 32, [n - 1] * 32, [path] * 32, n, tree.root_hash)
    got = s2.verify_audit_paths_indexed(
        *[torch.from_numpy(a) for a in crs.pack_audit_batch(*args)]).numpy()
    ref = jcrs.pack_audit_batch(*args)
    want = np.asarray(js.verify_audit_paths_indexed(
        *[jnp.asarray(a) for a in ref]))[:32]
    assert got.all() and not want.any()
    assert not np.array_equal(got, want)
