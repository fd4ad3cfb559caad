"""K12's loads and word-wise padding (``csrc/sha256.cu``
``sha256_fixed_kernel``), modelled on the host by
``tpu/sha256.fixed_words_model``: every length from 0 to 200 bytes, in
buckets that hold the padding edges (55/56, 63/64, 119/120), and rows
whose base is not 4-byte aligned, in an image of device memory whose
bytes around the rows are seeded garbage (an aligned word that straddles
the row's ends brings them in). The model asserts that every word it
loads holds one of the row's bytes; its words equal FIPS 180-4's padded
words; its digests equal hashlib's and JAX's ``sha256_fixed`` (XLA:CPU)
on the same rows. Exact: the tolerance is 0."""
import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.tpu import sha256 as js  # noqa: E402
from indy_plenum_tpu_torch.tpu import sha256 as s2  # noqa: E402

# [lo, hi) buckets of lengths covering 0..200
BUCKETS = ((0, 16), (16, 32), (32, 48), (48, 55), (55, 57), (57, 63),
           (63, 65), (65, 80), (80, 96), (96, 112), (112, 119),
           (119, 121), (121, 136), (136, 152), (152, 168), (168, 184),
           (184, 201))
OFFSETS = (1, 2, 3, 6)  # the rows' base, mod 16
ROWS = 3
# the lengths JAX compiles for (one XLA program a length): each bucket's
# ends and the padding edges
EDGES = {55, 56, 63, 64, 119, 120}
_jax_fixed = jax.jit(js.sha256_fixed, static_argnums=1)


def _padded_words(msg: bytes) -> np.ndarray:
    """FIPS 180-4 padding, byte by byte: (n_blocks, 16) big-endian words."""
    pad = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) \
        + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(pad, ">u4").reshape(-1, 16).astype(np.uint32)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("bucket", BUCKETS,
                         ids=[f"{lo}-{hi - 1}" for lo, hi in BUCKETS])
def test_fixed_words_model_matches_hashlib_and_jax(bucket, offset):
    lo, hi = bucket
    rng = np.random.RandomState(1000 * lo + offset)
    by_blocks = {}  # n_blocks -> [(words, row bytes, length)]
    for length in range(lo, hi):
        base = 16 * rng.randint(0, 4) + offset
        mem = rng.randint(0, 256, base + ROWS * length + 48).astype(np.uint8)
        rows = [mem[base + r * length:base + (r + 1) * length].tobytes()
                for r in range(ROWS)]
        for r, row in enumerate(rows):
            words = s2.fixed_words_model(mem, base + r * length, length)
            np.testing.assert_array_equal(words, _padded_words(row))
            by_blocks.setdefault(len(words), []).append((words, row, length))
        if length in EDGES or length in (lo, hi - 1):
            msgs = np.frombuffer(b"".join(rows), np.uint8).reshape(ROWS,
                                                                   length)
            np.testing.assert_array_equal(
                s2.sha256_fixed_model(mem, base, ROWS, length),
                np.asarray(_jax_fixed(jnp.asarray(msgs), length)))
    for group in by_blocks.values():
        digests = s2.digest_words(np.stack([w for w, _, _ in group]))
        for (_, row, length), dig in zip(group, digests):
            assert dig.tobytes() == hashlib.sha256(row).digest(), length


@pytest.mark.parametrize("offset", (0, 1, 2, 3))
def test_fixed_model_on_long_rows(offset):
    """Rows of 11 to 24 blocks, each row's base at ``offset`` mod 4: the
    model's words stay FIPS 180-4's and its digests hashlib's, with the
    memory image ending at the 4-byte boundary after the last row's last
    byte (a load past it would fail)."""
    rng = np.random.RandomState(300 + offset)
    for length in (703, 704, 705, 777, 1500):
        end = offset + 2 * length
        mem = rng.randint(0, 256, end + (-end) % 4).astype(np.uint8)
        rows = [mem[offset + r * length:offset + (r + 1) * length].tobytes()
                for r in range(2)]
        words = np.stack([s2.fixed_words_model(mem, offset + r * length,
                                               length) for r in range(2)])
        for r in range(2):
            np.testing.assert_array_equal(words[r], _padded_words(rows[r]))
        for row, dig in zip(rows, s2.digest_words(words)):
            assert dig.tobytes() == hashlib.sha256(row).digest(), length
