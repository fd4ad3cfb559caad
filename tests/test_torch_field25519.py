"""The port's plain GF(2^255-19) layer against the JAX one and Python ints.

The port keeps the reference's radix-2^12 representation, so every op must
return the SAME limbs as ``indy_plenum_tpu.tpu.field25519`` on the same
input (the cases of ``tests/test_field25519.py``), and the right value.
"""
import random

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from indy_plenum_tpu.tpu import field25519 as jfe  # noqa: E402
from indy_plenum_tpu_torch.tpu import field25519 as tfe  # noqa: E402

P = jfe.P
ADVERSARIAL = [0, 1, 2, 19, P - 1, P - 2, (1 << 255) - 1, (1 << 256) - 1,
               P, P + 1, 2 * P - 1, (1 << 263) + 12345, (1 << 264) - 1,
               511 * P + 7]


def _limbs(ints, loose=False, seed=0):
    """(len, 22) int64 limbs; ``loose`` pushes 2^12 of slack between
    random neighbouring limbs (limbs up to 2^13)."""
    rng = random.Random(seed)
    full = 1 << (jfe.RADIX * jfe.NLIMBS)
    rows = []
    for x in ints:
        limbs = jfe.limbs_from_int(x % full).astype(np.int64)
        if loose:
            for i in range(jfe.NLIMBS - 1):
                if rng.random() < 0.5 and limbs[i + 1] > 0:
                    limbs[i] += 1 << jfe.RADIX
                    limbs[i + 1] -= 1
        rows.append(limbs)
    return np.stack(rows)


def _ints(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(0, P) for _ in range(n)]


def _both(name, *arrays):
    """Run one op through JAX (int32) and the port (int64); return both."""
    j = np.asarray(getattr(jfe, name)(
        *[jnp.asarray(a.astype(np.int32)) for a in arrays]))
    t = getattr(tfe, name)(*[torch.from_numpy(a) for a in arrays]).numpy()
    return j, t


def _as_ints(arr):
    return [tfe.int_from_limbs(row) for row in arr]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("loose", [False, True])
def test_binary_ops_match_jax_and_ints(op, loose):
    xs = _ints(1, 48) + ADVERSARIAL
    ys = _ints(2, 48) + list(reversed(ADVERSARIAL))
    a, b = _limbs(xs, loose, 3), _limbs(ys, loose, 4)
    j, t = _both(op, a, b)
    assert np.array_equal(j, t)
    fn = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y}[op]
    assert _as_ints(t) == [fn(x, y) % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", ["sqr", "neg", "freeze", "carry"])
def test_unary_ops_match_jax(op):
    xs = _ints(5, 32) + ADVERSARIAL
    a = _limbs(xs, loose=True, seed=6)
    j, t = _both(op, a)
    assert np.array_equal(j, t)
    fn = {"sqr": lambda x: x * x, "neg": lambda x: -x,
          "freeze": lambda x: x, "carry": lambda x: x}[op]
    assert _as_ints(t) == [fn(x) % P for x in xs]


def test_freeze_is_canonical():
    xs = _ints(7, 16) + ADVERSARIAL
    t = tfe.freeze(torch.from_numpy(_limbs(xs, loose=True, seed=8))).numpy()
    assert t.min() >= 0 and t.max() < (1 << tfe.RADIX)
    for row, x in zip(t, xs):
        raw = sum(int(row[j]) << (tfe.RADIX * j) for j in range(tfe.NLIMBS))
        assert raw == x % P


@pytest.mark.parametrize("op,exponent", [("invert", P - 2),
                                         ("pow_p58", (P - 5) // 8)])
def test_exponent_chains(op, exponent):
    xs = [x or 1 for x in _ints(9, 6)]
    j, t = _both(op, _limbs(xs))
    assert np.array_equal(j, t)
    assert _as_ints(t) == [pow(x, exponent, P) for x in xs]


def test_eq_parity_encode_decode():
    xs = _ints(10, 16)
    a = torch.from_numpy(_limbs(xs))
    b = torch.from_numpy(_limbs([x + P for x in xs]))
    assert bool(torch.all(tfe.eq(a, b)))
    assert tfe.parity(a).tolist() == [x % 2 for x in xs]
    assert not tfe.is_zero(a).any()
    enc = tfe.encode_bytes(a).numpy()
    for row, x in zip(enc, xs):
        assert row.tobytes() == x.to_bytes(32, "little")
    raw = np.random.RandomState(11).randint(0, 256, (24, 32)).astype(np.uint8)
    jdec = np.asarray(jfe.decode_bytes(jnp.asarray(raw)))
    tdec = tfe.decode_bytes(torch.from_numpy(raw)).numpy()
    assert np.array_equal(jdec, tdec)
    jenc = np.asarray(jfe.encode_bytes(jnp.asarray(jdec)))
    assert np.array_equal(jenc, tfe.encode_bytes(torch.from_numpy(tdec)).numpy())
