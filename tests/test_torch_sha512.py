"""The port's SHA-512 and mod-L (plain versions on the CPU) against the JAX
functions, hashlib and Python ints: multi-block, ragged, bit-equal."""
import decimal
import hashlib
import os
import re

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.tpu import sha512 as js5  # noqa: E402
from indy_plenum_tpu_torch.tpu import sha512 as ts5  # noqa: E402

L = ts5.L


def test_constants_match_reference():
    assert ts5._K64 == js5._K64
    assert ts5._H064 == js5._H064
    assert ts5._K64[0] == 0x428a2f98d728ae22


def test_sha512_blocks_matches_jax():
    """Bit-equal to the JAX function on the inputs of
    ``tests/test_sha512_kernel.py`` (one compiled JAX shape)."""
    rng = np.random.RandomState(3)
    msgs = [b"", b"abc", rng.bytes(111), rng.bytes(112), rng.bytes(128),
            rng.bytes(239), rng.bytes(240), rng.bytes(300)]
    blocks, counts = ts5.pad_ed25519_messages([b""] * len(msgs), msgs, 4)
    got = ts5.sha512_blocks(torch.from_numpy(blocks),
                            torch.from_numpy(counts)).numpy()
    ref = np.asarray(js5.sha512_blocks(jnp.asarray(blocks),
                                       jnp.asarray(counts)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("max_blocks", [1, 2, 4, 8])
def test_sha512_blocks_multiblock_ragged(max_blocks):
    rng = np.random.RandomState(max_blocks)
    cap = max_blocks * 128 - 64 - 17  # longest message that still fits
    lengths = sorted({0, 1, 47, 48, 111, 112, cap // 2, cap} & set(
        range(cap + 1))) + list(rng.randint(0, cap + 1, 4))
    msgs = [rng.bytes(int(n)) for n in lengths]
    prefixes = [rng.bytes(64) for _ in msgs]
    blocks, counts = ts5.pad_ed25519_messages(prefixes, msgs, max_blocks)
    jb, jc = js5.pad_ed25519_messages(prefixes, msgs, max_blocks)
    assert np.array_equal(blocks, jb) and np.array_equal(counts, jc)
    # garbage past each item's active blocks must be ignored
    for i, c in enumerate(counts):
        blocks[i, c:] = 0xA5
    got = ts5.sha512_blocks(torch.from_numpy(blocks),
                            torch.from_numpy(counts)).numpy()
    for i, (p, m) in enumerate(zip(prefixes, msgs)):
        assert got[i].tobytes() == hashlib.sha512(p + m).digest()


def test_reduce_mod_l_matches_jax_and_ints():
    rng = np.random.RandomState(5)
    edge = [0, 1, L - 1, L, L + 1, 2 * L, 7 * L, (1 << 252), (1 << 253) - 1,
            (1 << 512) - 1, ((1 << 512) - 1) // L * L]
    hs = [rng.bytes(64) for _ in range(12)] + [
        v.to_bytes(64, "little") for v in edge]
    arr = np.stack([np.frombuffer(h, np.uint8) for h in hs])
    got = ts5.reduce_mod_l(torch.from_numpy(arr)).numpy()
    ref = np.asarray(js5.reduce_mod_l(jnp.asarray(arr)))
    assert np.array_equal(got, ref)
    for row, h in zip(got, hs):
        assert int.from_bytes(row.tobytes(), "little") \
            == int.from_bytes(h, "little") % L


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "indy_plenum_tpu_torch", "csrc", "sha512.cu")


def kernel_table():
    """The ``constexpr`` round-constant and IV table of ``csrc/sha512.cu``
    (``kSha512Table``), parsed out of the source."""
    with open(CSRC) as fh:
        src = fh.read()
    body = re.search(r"constexpr uint64_t kSha512Table\[88\] = \{(.*?)\};",
                     src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{16})ull", body)]


def _frac_root_bits(p: int, k: int) -> int:
    """The first 64 bits of the fractional part of p^(1/k), by decimal
    arithmetic (FIPS 180-4 4.2.3, 5.3.5) - independent of the module's
    integer roots."""
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        root = decimal.Decimal(p) ** (decimal.Decimal(1) / k)
        return int((root - int(root)) * (1 << 64))


def test_kernel_constant_tables():
    """The kernel's constants, rebuilt from Python ints: the round
    constants + IV table in ``csrc/sha512.cu`` equals ``_K64 + _H064`` and
    the first-primes derivation; and the operand of the Barrett
    reduction, L and mu."""
    table = kernel_table()
    assert len(table) == 88
    assert table == ts5._K64 + ts5._H064
    primes = ts5._first_primes(80)
    assert primes[:5] == [2, 3, 5, 7, 11] and primes[-1] == 409
    assert table[:80] == [_frac_root_bits(p, 3) for p in primes]
    assert table[80:] == [_frac_root_bits(p, 2) for p in primes[:8]]
    table = ts5._barrett_table(torch.device("cpu")).numpy().view(np.uint64)
    assert table.shape == (9,)
    assert sum(int(table[j]) << (64 * j) for j in range(4)) == L
    mu = sum(int(table[4 + j]) << (64 * j) for j in range(5))
    assert mu == (1 << 512) // L and 1 << 259 <= mu < 1 << 260


# --- K-a's kernel (csrc/sha512.cu sha512_blocks_kernel), modelled ---------

M64 = (1 << 64) - 1


def rotr(x: int, n: int) -> int:
    """The kernel's ``rotr64``: a 64-bit rotate right by n."""
    return ((x >> n) | (x << (64 - n))) & M64


def unpack_block(vectors: np.ndarray):
    """``unpack_block``: 8 16-byte vectors, each four little-endian 32-bit
    words (x, y, z, w), to 16 big-endian 64-bit words - each half byte
    swapped (``__byte_perm(v, 0, 0x0123)``), x and z the high halves."""
    words = vectors.view("<u4").reshape(8, 4).byteswap()
    out = []
    for x, y, z, w in words.tolist():
        out += [(x << 32) | y, (z << 32) | w]
    return out


def compress(st, w, k):
    w = list(w)
    a, b, c, d, e, f, g, h = st
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t + 1) & 15], w[(t + 14) & 15]
            s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7)
            s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6)
            w[t & 15] = (w[t & 15] + s0 + w[(t + 9) & 15] + s1) & M64
        s1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)
        ch = (e & f) ^ (~e & g & M64)
        t1 = (h + s1 + ch + k[t] + w[t & 15]) & M64
        s0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)
        mj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = ((t1 + s0 + mj) & M64, a, b, c,
                                  (d + t1) & M64, e, f, g)
    return [(x + y) & M64 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def model_kernel(blocks: np.ndarray, counts: np.ndarray, table):
    """The kernel's pipelined loop for each item, with the constants of
    its source: block 0's vectors loaded before the loop, block b + 1's
    loaded (when b + 1 < active) before block b's rounds. Returns the
    digests and, per item, the block rows in the order they were read."""
    nb = blocks.shape[1]
    digests, reads = [], []
    for row, count in zip(blocks, counts):
        active = min(int(count), nb)
        order = []

        def load(b):
            order.append(b)
            return row[b].reshape(8, 16)

        st = list(table[80:])
        cur = load(0) if active > 0 else None
        for blk in range(active):
            nxt = load(blk + 1) if blk + 1 < active else None
            st = compress(st, unpack_block(cur), table[:80])
            cur = nxt
        digests.append(b"".join(x.to_bytes(8, "big") for x in st))
        reads.append(order)
    return digests, reads


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_kernel_model_crosses_the_prefetch_boundary(nb):
    """The kernel's loop (next block in flight, 16-byte vectors, the
    constants parsed out of its source) at counts 0, 1, nb - 1 and nb,
    with garbage past each count: each active row read once, in order,
    none past the count; the digests equal hashlib's, the plain version's
    and JAX's ``sha512_blocks``."""
    rng = np.random.RandomState(100 + nb)
    counts = sorted({0, 1, nb - 1, nb}) * 2
    cap = [c * 128 - 17 for c in counts]  # longest message of c blocks
    msgs = [b"" if c == 0 else rng.bytes(
        int(rng.randint(max(0, (c - 1) * 128 - 16), n + 1)))
        for c, n in zip(counts, cap)]
    blocks, got_counts = ts5.pad_ed25519_messages([b""] * len(msgs), msgs,
                                                  nb)
    got_counts[np.array(counts) == 0] = 0
    assert got_counts.tolist() == counts
    for i, c in enumerate(counts):
        blocks[i, c:] = rng.randint(0, 256, (nb - c, 128))
    digests, reads = model_kernel(blocks, got_counts, kernel_table())
    for c, order in zip(counts, reads):
        assert order == list(range(c))
    for c, m, d in zip(counts, msgs, digests):
        if c:
            assert d == hashlib.sha512(m).digest()
    want = np.stack([np.frombuffer(d, np.uint8) for d in digests])
    plain = ts5.sha512_blocks(torch.from_numpy(blocks),
                              torch.from_numpy(got_counts)).numpy()
    assert np.array_equal(plain, want)
    ref = np.asarray(js5.sha512_blocks(jnp.asarray(blocks),
                                       jnp.asarray(got_counts)))
    assert np.array_equal(ref, want)
