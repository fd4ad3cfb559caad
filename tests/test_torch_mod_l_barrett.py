"""The limb schedule of the port's h mod L kernel (K-b,
``csrc/sha512.cu`` ``reduce_mod_l_kernel``), modelled in Python integers,
against Python's ``h % L``, the port's plain version (the reference's
ladder) and the JAX package's ``reduce_mod_l``.

The model runs the kernel's steps one for one: 64-bit limbs masked to 64
bits; each product split into its low word (``a * b`` wrapped) and high
word (``__umul64hi``); columns summed into a 3-word accumulator with the
kernel's carries; q3 = (q1 mu) >> 320 from all 25 products; q3 L mod 2^256
from the 10 products of columns 0..3; the 4-limb subtraction with its
borrow chain, then two conditional subtractions of L taken as selects.
It also counts how many of those two subtractions fire: Barrett's bound
is two, and for this L at most one can (the quotient's error is below
1, see ``test_barrett_quotient_error_below_one``). Exact: the outputs are
integers.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jnp = pytest.importorskip("jax.numpy")

import chip_smoke  # noqa: E402
from indy_plenum_tpu.tpu import sha512 as js5  # noqa: E402
from indy_plenum_tpu_torch.tpu import sha512 as ts5  # noqa: E402

L = ts5.L
M64 = (1 << 64) - 1
TOP = (1 << 512) - 1


def mac(a, b, acc):
    """The kernel's ``mac``: c2:c1:c0 += a * b."""
    c0, c1, c2 = acc
    lo = (a * b) & M64
    hi = (a * b) >> 64
    c0 = (c0 + lo) & M64
    t = hi + (c0 < lo)
    assert t <= M64  # hi <= 2^64 - 2: hi + carry does not wrap
    c1 = (c1 + t) & M64
    c2 = (c2 + (c1 < t)) & M64
    return c0, c1, c2


def sub4(r, y):
    """The kernel's ``sub4``: (r - y over 4 limbs, borrow out)."""
    d, borrow = [], 0
    for j in range(4):
        d.append((r[j] - y[j] - borrow) & M64)
        borrow = int(r[j] < y[j] or (r[j] == y[j] and borrow))
    return d, borrow


def barrett_model(h_value):
    """``reduce_mod_l_kernel`` on one item: (residue, subtractions)."""
    h = ts5.limbs64(h_value, 8)
    lmb = ts5.limbs64(L, 4)
    mu = ts5.limbs64(ts5.MU, 5)
    q3, acc = [], (0, 0, 0)
    for k in range(9):
        for i in range(5):
            if 0 <= k - i < 5:
                acc = mac(h[3 + i], mu[k - i], acc)
        if k >= 5:
            q3.append(acc[0])
        acc = (acc[1], acc[2], 0)
    q3.append(acc[0])
    ql, acc = [], (0, 0, 0)
    for k in range(4):
        for i in range(k + 1):
            acc = mac(q3[i], lmb[k - i], acc)
        ql.append(acc[0])
        acc = (acc[1], acc[2], 0)
    r, _ = sub4(h, ql)
    fired = 0
    for _ in range(2):
        d, borrow = sub4(r, lmb)
        keep = (0 - borrow) & M64
        r = [(rj & keep) | (dj & ~keep & M64) for rj, dj in zip(r, d)]
        fired += 1 - borrow
    return sum(v << (64 * j) for j, v in enumerate(r)), fired


def edge_values():
    """``chip_smoke.mod_l_edges``: around 0, L, 2L and 3L, a large multiple
    of L, powers of two at the limb edges, 2^512 - 1, and just under and
    over the multiples of L nearest 2^512."""
    vals = chip_smoke.mod_l_edges()
    assert all(0 <= v <= TOP for v in vals)
    return vals


def test_barrett_quotient_error_below_one():
    """With y = floor(h / 2^192) mu / 2^320 and q3 = floor(y): h / L - y
    is at most frac(2^512 / L) h / 2^512 + mu / 2^320 < 1, so q3 > h / L
    - 2 and q3 is q = floor(h / L) or q - 1: at most one subtraction of L
    fires (HAC's general bound is two)."""
    frac_num = (1 << 512) - ts5.MU * L  # frac(2^512 / L) * L
    assert 0 <= frac_num < L
    # frac + mu / 2^320 < 1, in integers
    assert frac_num * (1 << 320) + ts5.MU * L < L * (1 << 320)


def test_truncated_quotient_needs_two_subtractions():
    """The least Barrett reduction ``chip_smoke.MOD_L_OPS_PER_ITEM``
    counts: q3 from the columns 3..8 of q1 mu only (19 products). The
    dropped columns sum below 2^259, so q3 is q, q - 1 or q - 2 and r =
    h - q3 L < 3L < 2^256: two conditional subtractions of L finish it,
    on the edge values and seeded hashes."""
    mu = ts5.limbs64(ts5.MU, 5)
    rng = np.random.RandomState(11)
    values = edge_values() + [
        int.from_bytes(rng.bytes(64), "little") for _ in range(2000)]
    shorts = set()
    for v in values:
        q1 = ts5.limbs64(v >> 192, 5)
        kept = sum(q1[i] * mu[j] << (64 * (i + j))
                   for i in range(5) for j in range(5) if i + j >= 3)
        dropped = sum(q1[i] * mu[j] << (64 * (i + j))
                      for i in range(5) for j in range(5) if i + j < 3)
        assert dropped < 1 << 259
        q3 = kept >> 320
        r = v - q3 * L
        assert 0 <= r < 3 * L < 1 << 256
        shorts.add(r // L)
    assert shorts <= {0, 1, 2} and 0 in shorts


def test_barrett_schedule_on_edge_values():
    fired = set()
    for v in edge_values():
        got, n = barrett_model(v)
        assert got == v % L, hex(v)
        fired.add(n)
    assert fired == {0, 1}


@settings(max_examples=400, deadline=None)
@given(st.integers(min_value=0, max_value=TOP))
def test_barrett_schedule_on_random_values(v):
    got, n = barrett_model(v)
    assert got == v % L
    assert n <= 1


def test_barrett_schedule_matches_plain_and_jax():
    """The model, the port's plain ladder and JAX's ``reduce_mod_l`` on
    the edge values and seeded hashes, one batch."""
    rng = np.random.RandomState(9)
    values = edge_values() + [
        int.from_bytes(rng.bytes(64), "little") for _ in range(24)]
    arr = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                    for v in values])
    plain = ts5.reduce_mod_l(torch.from_numpy(arr)).numpy()
    ref = np.asarray(js5.reduce_mod_l(jnp.asarray(arr)))
    assert np.array_equal(plain, ref)
    for row, v in zip(plain, values):
        assert barrett_model(v)[0] == int.from_bytes(row.tobytes(),
                                                     "little")
