"""The lane schedule of the port's Ed25519 kernel (``csrc/ed25519.cu``),
modelled in Python integers, against the port's and the JAX package's
point operations; and K8's host-side packing of a slide into launches.

The model runs each stage lane by lane as the kernel does: lane l of a
group of L (2 or 4) holds coordinates l, l + L, ... of the point (slot
c // L), computes one square or product per coordinate it holds, and
reads another lane's value only through an exchange, counted as the
kernel's ``__shfl_sync`` calls are (one per coordinate gathered, one per
slot for a partner exchange). A doubling, a cached addition and the
cached form must give the same point as ``point_double`` /
``point_add_cached`` / ``to_cached`` of the port's plain version and of
``indy_plenum_tpu/tpu/ed25519.py``, on seeded points and the identity; the
whole verify schedule (the table of -A, the 64 windows, the masked
verdict of an A that fails to decompress) must give the plain version's
verdicts on the edge rows of ``chip_smoke.verify_edge_inputs``.
"""
import hashlib
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from indy_plenum_tpu.tpu import ed25519 as jted  # noqa: E402
from indy_plenum_tpu.tpu import field25519 as jfe  # noqa: E402
from indy_plenum_tpu_torch.crypto import ed25519 as ed  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as ted  # noqa: E402
from indy_plenum_tpu_torch.tpu import field25519 as tfe  # noqa: E402
from indy_plenum_tpu_torch.tpu import quorum as tq  # noqa: E402

P, D2 = ed.P, (2 * ed.D) % ed.P
LANES = (2, 4)


class Group:
    """L lanes that share one signature; ``exchanges`` counts the kernel's
    warp-wide shuffles of one field element."""

    def __init__(self, lanes):
        self.L = lanes
        self.K = 4 // lanes
        self.exchanges = 0

    def spread(self, point):
        return [[point[lane + self.L * k] % P for k in range(self.K)]
                for lane in range(self.L)]

    def collect(self, own):
        return [own[c % self.L][c // self.L] for c in range(4)]

    def coord(self, own, c):
        """Coordinate c, read by every lane from lane c % L."""
        self.exchanges += 1
        return own[c % self.L][c // self.L]

    def partners(self, own):
        """Every lane's coordinate c ^ 1, slot by slot from lane l ^ 1."""
        self.exchanges += self.K
        return [[own[lane ^ 1][k] for k in range(self.K)]
                for lane in range(self.L)]

    def each(self, fn):
        return [[fn(lane + self.L * k, lane, k) for k in range(self.K)]
                for lane in range(self.L)]


def _second_stage(c, E, F, G, H):
    u, v = {0: (E, F), 1: (G, H), 2: (F, G), 3: (E, H)}[c]
    return u * v % P


def lanes_double(g, own):
    X, Y = g.coord(own, 0), g.coord(own, 1)
    xy = (X + Y) % P
    r = g.each(lambda c, lane, k: pow(xy if c == 3 else own[lane][k], 2, P))
    A, B, zz, S3 = (g.coord(r, c) for c in range(4))
    C = 2 * zz
    Dd = -A
    E, G = (S3 - A - B) % P, (Dd + B) % P
    F, H = (G - C) % P, (Dd - B) % P
    return g.each(lambda c, lane, k: _second_stage(c, E, F, G, H))


def lanes_add_cached(g, own, q):
    part = g.partners(own)

    def first(c, lane, k):
        mine, other = own[lane][k], part[lane][k]
        op = (other + mine if c == 0 else mine - other if c == 1 else other)
        return op * q[lane][k] % P  # B, A, C, D by coordinate

    r = g.each(first)
    B, A, C, Dd = (g.coord(r, c) for c in range(4))
    E, F, G, H = (B - A) % P, (Dd - C) % P, (Dd + C) % P, (B + A) % P
    return g.each(lambda c, lane, k: _second_stage(c, E, F, G, H))


def lanes_to_cached(g, own):
    part = g.partners(own)

    def coord(c, lane, k):
        mine, other = own[lane][k], part[lane][k]
        return [(other + mine), (mine - other), other * D2,
                2 * other][c] % P

    return g.each(coord)


def _points(seed, n):
    """Seeded extended points k*B with a random projective scale, and the
    identity."""
    rng = random.Random(seed)
    out = [(0, 1, 1, 0)]
    for _ in range(n):
        X, Y, Z, T = ed.base_mult(rng.randrange(1, ed.L))
        z = rng.randrange(1, P)
        out.append(tuple(v * z % P for v in (X, Y, Z, T)))
    return out


def _cached(point):
    X, Y, Z, T = point
    return ((Y + X) % P, (Y - X) % P, T * D2 % P, 2 * Z % P)


def _torch(point):
    return torch.from_numpy(np.stack([tfe.limbs_from_int(v) for v in point]))


def _jax(point):
    return jnp.asarray(np.stack([jfe.limbs_from_int(v) for v in point]))


def _ints(limbs, from_limbs):
    return [from_limbs(limbs[i]) for i in range(4)]


@pytest.mark.parametrize("lanes", LANES)
def test_lane_doubling_matches_port_and_jax(lanes):
    for point in _points(1, 4):
        g = Group(lanes)
        got = g.collect(lanes_double(g, g.spread(point)))
        assert g.exchanges == 6  # X and Y, then the four squares
        assert got == _ints(ted.point_double(_torch(point)),
                            tfe.int_from_limbs)
        assert got == _ints(np.asarray(jted.point_double(_jax(point))),
                            jfe.int_from_limbs)


@pytest.mark.parametrize("lanes", LANES)
def test_lane_cached_addition_matches_port_and_jax(lanes):
    points = _points(2, 4)
    for p, q in zip(points, points[::-1]):
        g = Group(lanes)
        got = g.collect(lanes_add_cached(g, g.spread(p),
                                         g.spread(_cached(q))))
        assert g.exchanges == 4 // lanes + 4
        assert got == _ints(ted.point_add_cached(
            _torch(p), _torch(_cached(q))), tfe.int_from_limbs)
        assert got == _ints(np.asarray(jted.point_add_cached(
            _jax(p), _jax(_cached(q)))), jfe.int_from_limbs)


@pytest.mark.parametrize("lanes", LANES)
def test_lane_cached_form_matches_port_and_jax(lanes):
    for point in _points(3, 3):
        g = Group(lanes)
        got = g.collect(lanes_to_cached(g, g.spread(point)))
        assert got == list(_cached(point))
        assert got == _ints(ted.to_cached(_torch(point)), tfe.int_from_limbs)
        assert got == _ints(np.asarray(jted.to_cached(_jax(point))),
                            jfe.int_from_limbs)


def lanes_verify(pk, rb, sb, hb, lanes):
    """The kernel's whole schedule for one signature: an A that fails to
    decompress runs the ladder on a stand-in point, its verdict masked."""
    g = Group(lanes)
    a = ed.decompress(bytes(pk))
    ok = a is not None
    x, y = (a[0] * pow(a[2], P - 2, P) % P,
            a[1] * pow(a[2], P - 2, P) % P) if ok else (0, 1)
    a_neg = g.spread((-x % P, y, 1, -x * y % P))
    table = [g.spread((1, 1, 0, 2)), lanes_to_cached(g, a_neg)]
    pt = a_neg
    for _ in range(14):
        pt = lanes_add_cached(g, pt, table[1])
        table.append(lanes_to_cached(g, pt))
    base = [g.spread((1, 1, 0, 2))] + [
        g.spread(_cached((bx, by, 1, bx * by % P)))
        for bx, by in ted._BASE_POINTS]
    acc = g.spread((0, 1, 1, 0))
    s_int, h_int = int.from_bytes(bytes(sb), "little"), \
        int.from_bytes(bytes(hb), "little")
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = lanes_double(g, acc)
        acc = lanes_add_cached(g, acc, base[(s_int >> (4 * w)) & 0xF])
        acc = lanes_add_cached(g, acc, table[(h_int >> (4 * w)) & 0xF])
    X, Y, Z, _ = g.collect(acc)
    zi = pow(Z, P - 2, P)
    enc = (Y * zi % P) | ((X * zi % P) & 1) << 255
    return ok and enc.to_bytes(32, "little") == bytes(rb)


@pytest.mark.parametrize("lanes", LANES)
def test_lane_schedule_verifies_like_the_plain_version(lanes):
    """The edge rows (a good signature, three undecompressible A, S + L)
    and a few planted faults: the model's verdicts equal the plain
    version's and the expected ones."""
    seed = bytes(range(1, 33))
    pk, msg = ed.public_key(seed), b"edge"
    sig = ed.sign(seed, msg)
    s_big = (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32,
                                                                "little")
    rows = [(pk, sig, True),
            ((P + 1).to_bytes(32, "little"), sig, False),
            ((1 | (1 << 255)).to_bytes(32, "little"), sig, False),
            ((2).to_bytes(32, "little"), sig, False),
            (pk, sig[:32] + s_big, True),
            (pk, bytes([sig[0] ^ 4]) + sig[1:], False),
            (pk, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], False)]
    arrays = [np.stack([np.frombuffer(b, np.uint8) for b in col]) for col in (
        [p for p, _, _ in rows], [g[:32] for _, g, _ in rows],
        [g[32:] for _, g, _ in rows],
        [ted._reduce_mod_l(hashlib.sha512(g[:32] + p + msg).digest())
         for p, g, _ in rows])]
    plain = ted.verify_kernel_plain(*[torch.from_numpy(a) for a in arrays])
    got = [lanes_verify(*(a[i] for a in arrays), lanes)
           for i in range(len(rows))]
    assert got == plain.tolist() == [ok for _, _, ok in rows]


def test_slide_pairs_skip_rows_whose_delta_is_not_positive():
    chunks = tq.slide_pair_chunks(np.array([0, 3, -2, 0, 7, 1], np.int32))
    assert len(chunks) == 1
    assert chunks[0].dtype == np.int32 and chunks[0].flags.c_contiguous
    assert chunks[0].tolist() == [[1, 3], [4, 7], [5, 1]]
    assert tq.slide_pair_chunks(np.zeros(64, np.int32)) == []
    assert tq.slide_pair_chunks(np.full(8, -1, np.int32)) == []


@pytest.mark.parametrize("per_launch", [1, 3, tq.SLIDE_PAIRS_PER_LAUNCH])
def test_slide_pairs_split_into_launches(per_launch):
    deltas = np.zeros(600, np.int32)
    deltas[::2] = np.arange(1, 301)
    chunks = tq.slide_pair_chunks(deltas, per_launch)
    assert len(chunks) == -(-300 // per_launch)
    assert all(1 <= len(c) <= per_launch for c in chunks)
    pairs = np.concatenate(chunks)
    assert pairs[:, 0].tolist() == list(range(0, 600, 2))
    assert pairs[:, 1].tolist() == list(range(1, 301))
