"""The port's audit-path fold kernel (K10, ``csrc/sha256.cu``
``audit_fold_kernel``), its arithmetic modelled in Python, against the
port's plain version (``_audit_fold_plain``), JAX's
``_verify_audit_paths_indexed`` / ``_verify_audit_paths`` on XLA:CPU and
the host ``MerkleVerifier``.

The model follows the kernel's schedule: the first sibling row and the
second level's table index are loaded before the loop; at each level the
next sibling row and the index after it are loaded before the hash. It
selects the node hash's two operands word by word (the sibling left when
the index is odd or equals the subtree's right edge) and makes one node
hash a level. The verifier's ``while fn even and fn != 0: halve fn and
fsn`` after a left sibling is its closed form: both shifted right by the
index's trailing zeros (``__ffs(fn) - 1``), then by one as every level
does. The inputs are every index of every tree of 1 to 70 leaves, and
proofs of a 2^17 + 1 leaf tree (its last leaf needs 17 shifts at its one
level), with the faults ``test_torch_sha256.py`` plants (a flipped leaf
byte, a wrong index, a path one node short, one node long, a wrong root)
on every fifth proof. Verdicts are compared exactly.
"""
import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.tpu import sha256 as js  # noqa: E402
from indy_plenum_tpu_torch.ledger.compact_merkle_tree import (  # noqa: E402
    CompactMerkleTree,
)
from indy_plenum_tpu_torch.ledger.merkle_verifier import (  # noqa: E402
    STH,
    MerkleVerifier,
)
from indy_plenum_tpu_torch.ledger.tree_hasher import TreeHasher  # noqa: E402
from indy_plenum_tpu_torch.tpu import sha256 as s2  # noqa: E402

M32 = 0xFFFFFFFF


def int32(x):
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def ffs(x):
    """CUDA's ``__ffs`` of an int32: 1 + the lowest set bit's place, 0 for
    0."""
    x &= M32
    return (x & -x).bit_length()


def row_words(row):
    return [int.from_bytes(bytes(row[4 * i:4 * i + 4]), "big")
            for i in range(8)]


def node_hash(lo, hi):
    data = b"\x01" + b"".join(w.to_bytes(4, "big") for w in lo + hi)
    return row_words(hashlib.sha256(data).digest())


def fold_model(item, leaf, index, sibling_row, path_idx, path_len,
               tree_size, root, depth):
    """``audit_fold_kernel``'s thread ``item``; ``sibling_row(item, level,
    idx)`` is the item's dense row of ``level`` or the table row
    ``idx``."""
    plen = int(path_len[item])
    levels = plen if plen < depth else depth
    consumed = levels if levels > 0 else 0
    raw, idx_next = None, 0
    if consumed > 0:
        raw = sibling_row(item, 0, int(path_idx[item][0]))
        if consumed > 1:
            idx_next = int(path_idx[item][1])
    r = row_words(leaf[item])
    fn = int32(int(index[item]))
    fsn = int32(int(tree_size[item]) - 1)
    ok = True
    for level in range(consumed):
        s = row_words(raw)
        if level + 1 < consumed:  # in flight while this level hashes
            raw = sibling_row(item, level + 1, idx_next)
            if level + 2 < consumed:
                idx_next = int(path_idx[item][level + 2])
        use_left = (fn & 1) == 1 or fn == fsn
        ok = ok and fsn > 0
        lo = [s[i] if use_left else r[i] for i in range(8)]
        hi = [r[i] if use_left else s[i] for i in range(8)]
        r = node_hash(lo, hi)
        tz = ffs(fn) - 1 if use_left and fn != 0 else 0
        fn = (fn >> tz) >> 1
        fsn = (fsn >> tz) >> 1
    ok = ok and fsn == 0 and consumed == plen
    return ok and r == row_words(root[item])


def plant(proofs, seed):
    """One fault on every fifth proof, the kinds in turn: a flipped leaf
    byte, a wrong index, a path one node short, one node long, a wrong
    root."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (data, idx, path, size, root) in enumerate(proofs):
        if i % 5 == 0:
            kind = (i // 5) % 5
            if kind == 0:
                buf = bytearray(data)
                buf[rng.randint(len(buf))] ^= 1 << rng.randint(8)
                data = bytes(buf)
            elif kind == 1:
                idx += 1
            elif kind == 2:
                path = path[:-1]
            elif kind == 3:
                path = path + [rng.bytes(32)]
            else:
                buf = bytearray(root)
                buf[rng.randint(32)] ^= 1
                root = bytes(buf)
        out.append((data, idx, path, size, root))
    return out


def operands(proofs, depth):
    """Leaf hashes, indices, dense paths, a deduplicated node table and
    its (B, depth) indices (0 past a path), path lengths, per-row tree
    sizes and roots."""
    hasher = TreeHasher()
    n = len(proofs)
    table, where = [bytes(32)], {}
    dense = np.zeros((n, depth, 32), np.uint8)
    path_idx = np.zeros((n, depth), np.int32)
    for b, (_, _, path, _, _) in enumerate(proofs):
        for level, node in enumerate(path):
            if node not in where:
                where[node] = len(table)
                table.append(node)
            path_idx[b, level] = where[node]
            dense[b, level] = np.frombuffer(node, np.uint8)

    def rows(blobs):
        return np.stack([np.frombuffer(x, np.uint8) for x in blobs])

    return {"leaf": rows([hasher.hash_leaf(p[0]) for p in proofs]),
            "index": np.array([p[1] for p in proofs], np.int32),
            "path": dense,
            "table": rows(table),
            "path_idx": path_idx,
            "path_len": np.array([len(p[2]) for p in proofs], np.int32),
            "tree_size": np.array([p[3] for p in proofs], np.int32),
            "root": rows([p[4] for p in proofs])}


def small_tree_proofs():
    """Every index of every tree of 1 to 70 leaves."""
    rng = np.random.RandomState(11)
    proofs = []
    for n in range(1, 71):
        leaves = [rng.bytes(int(rng.randint(1, 80))) for _ in range(n)]
        tree = CompactMerkleTree()
        tree.extend(leaves)
        for i in range(n):
            proofs.append((leaves[i], i, tree.audit_path(i), n,
                           tree.root_hash))
    return proofs


def long_shift_proofs():
    """Proofs of a 2^17 + 1 leaf tree: its last leaf (one sibling, 17
    index shifts) four times, the one before it twice, the first two and
    the middle."""
    n = (1 << 17) + 1
    tree = CompactMerkleTree()
    leaves = [b"%d" % i for i in range(n)]
    tree.extend(leaves)
    return [(leaves[i], i, tree.audit_path(i), n, tree.root_hash)
            for i in (n - 1, n - 2, 0, n // 2, n - 1, n - 1, n - 2, 1, n - 1)]


def check_all(proofs, form):
    """The model, the plain version, JAX and the verifier on ``proofs``:
    one verdict each, all equal. Returns the verdicts."""
    depth = max(len(p[2]) for p in proofs)
    ops = operands(proofs, depth)
    verifier = MerkleVerifier()
    expect = np.array([verifier.verify_leaf_inclusion(
        d, i, p, STH(tree_size=s, sha256_root_hash=r))
        for d, i, p, s, r in proofs])
    if form == "indexed":
        def row(item, level, idx):
            return ops["table"][idx]
        keys = ("leaf", "index", "table", "path_idx", "path_len",
                "tree_size", "root")
        plain = s2.verify_audit_paths_indexed_plain
        ref = js.verify_audit_paths_indexed
    else:
        def row(item, level, idx):
            return ops["path"][item, level]
        keys = ("leaf", "index", "path", "path_len", "tree_size", "root")
        plain = s2.verify_audit_paths_plain
        ref = js.verify_audit_paths
    model = np.array([fold_model(b, ops["leaf"], ops["index"], row,
                                 ops["path_idx"], ops["path_len"],
                                 ops["tree_size"], ops["root"], depth)
                      for b in range(len(proofs))])
    got = plain(*[torch.from_numpy(ops[k]) for k in keys]).numpy()
    want = np.asarray(ref(*[jnp.asarray(ops[k]) for k in keys]))
    np.testing.assert_array_equal(model, expect)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(want, expect)
    return expect


@pytest.mark.parametrize("form", ["indexed", "dense"])
def test_fold_model_matches_plain_jax_and_verifier_on_small_trees(form):
    proofs = plant(small_tree_proofs(), seed=9)
    expect = check_all(proofs, form)
    assert len(proofs) == 70 * 71 // 2
    # every unplanted proof verifies; most planted ones do not (a one-leaf
    # tree's empty path cannot lose a node)
    assert np.delete(expect, np.arange(0, len(proofs), 5)).all()
    assert (~expect[::5]).sum() > 0.9 * len(expect[::5])


def test_fold_model_runs_the_long_shift_of_the_last_leaf():
    """The 2^17 + 1 tree: JAX's shift is unrolled its depth times, and at
    these paths' depth (18) it covers the last leaf's 17 shifts, so every
    form agrees; faults are planted on the first and the sixth proof, both
    of the last leaf (a flipped leaf byte, an index past the tree)."""
    proofs = plant(long_shift_proofs(), seed=4)
    assert [len(p[2]) for p in proofs] == [1, 18, 18, 18, 1, 1, 18, 18, 1]
    for form in ("indexed", "dense"):
        expect = check_all(proofs, form)
        assert list(expect) == [False] + [True] * 4 + [False] + [True] * 3


def test_ffs_shift_is_the_verifiers_loop():
    """``(x >> (__ffs(fn) - 1)) >> 1`` on fn and fsn equals the verifier's
    loop then its halving, for int32 values of every sign, zero and both
    ends."""
    rng = np.random.RandomState(3)
    values = [0, 1, 2, 3, 4, 6, 8, 96, 1 << 17, (1 << 17) + 1, (1 << 30),
              (1 << 31) - 1, -1, -2, -4, -(1 << 31), -(1 << 30)]
    values += [int32(int(x)) for x in rng.randint(0, 1 << 32, 200,
                                                  dtype=np.uint64)]
    for fn0 in values:
        for fsn0 in (fn0, 0, 5, -(1 << 31), int32(fn0 + 7)):
            fn, fsn = fn0, fsn0
            while fn % 2 == 0 and fn != 0:
                fn >>= 1
                fsn >>= 1
            want = (fn >> 1, fsn >> 1)
            tz = ffs(fn0) - 1 if fn0 != 0 else 0
            assert ((fn0 >> tz) >> 1, (fsn0 >> tz) >> 1) == want
