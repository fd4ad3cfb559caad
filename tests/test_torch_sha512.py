"""The port's SHA-512 and mod-L (plain versions on the CPU) against the JAX
functions, hashlib and Python ints: multi-block, ragged, bit-equal."""
import hashlib

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


def test_kernel_constant_tables():
    """The operands handed to the CUDA kernels, rebuilt from Python ints:
    round constants + IV, and the Barrett reduction's L and mu."""
    consts = ts5._sha_consts(torch.device("cpu")).numpy().view(np.uint64)
    assert [int(v) for v in consts] == ts5._K64 + ts5._H064
    table = ts5._barrett_table(torch.device("cpu")).numpy().view(np.uint64)
    assert table.shape == (9,)
    assert sum(int(table[j]) << (64 * j) for j in range(4)) == L
    mu = sum(int(table[4 + j]) << (64 * j) for j in range(5))
    assert mu == (1 << 512) // L and 1 << 259 <= mu < 1 << 260
