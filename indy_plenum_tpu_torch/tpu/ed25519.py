"""Batched Ed25519 verification (PyTorch + CUDA).

Port of ``indy_plenum_tpu/tpu/ed25519.py``, the device half of
``CoreAuthNr.authenticate_batch``:

- :func:`verify_kernel` (K-c, reference ``ed25519.py:165-207``): point
  decompression of A, a 16-entry table of cached multiples of -A, 64
  four-bit windows of ``S*B + h*(-A)``, compress and compare with R; on
  the card each signature's point arithmetic is spread over two lanes of
  a warp;
- :func:`verify_kernel_full` (reference ``:210-226``): K-a -> K-b -> K-c
  on one stream (:mod:`.sha512`), so SHA512(R || A || M) mod L never
  touches the host;
- the host preparation (``prepare_batch``, ``prepare_batch_device``,
  ``max_blocks_for``) and :func:`batch_verify`, copied from the reference.

The wrapper takes the plain version (:func:`verify_kernel_plain`, the
reference's limb arithmetic in torch ops, :mod:`.field25519`) only for CPU
tensors; CUDA tensors launch ``csrc/ed25519.cu`` or raise.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from ..crypto import ed25519 as ref
from ..utils import kernel_build as kb
from ..utils.torch_env import DeviceLike, resolve_device
from . import field25519 as fe
from . import sha512 as s512

WINDOWS = 64  # 4-bit windows over 256-bit scalars


# --- the plain version: points as (..., 4, 22) limb tensors ------------------


def _pt(x, y, z, t):
    return torch.stack([x, y, z, t], dim=-2)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2008-hwcd. Independent field products run as one stacked call
    (the field ops are limb-wise, so each row is computed exactly as alone):
    the four squarings, then the four output products."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    A, B, ZZ, XY2 = fe.sqr(torch.stack([X, Y, Z, fe.add(X, Y)],
                                        dim=-2)).unbind(-2)
    C = fe.mul_small(ZZ, 2)
    Dd = fe.neg(A)
    E = fe.sub(fe.sub(XY2, A), B)
    G = fe.add(Dd, B)
    F, H = fe.sub(torch.stack([G, Dd], dim=-2),
                  torch.stack([C, B], dim=-2)).unbind(-2)
    return fe.mul(torch.stack([E, G, F, E], dim=-2),
                  torch.stack([F, H, G, H], dim=-2))


def to_cached(p: torch.Tensor) -> torch.Tensor:
    X, Y, Z, T = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    return torch.stack([fe.add(Y, X), fe.sub(Y, X),
                        fe.mul(T, fe.const("D2_LIMBS", T)),
                        fe.mul_small(Z, 2)], dim=-2)


def point_add_cached(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Extended point + cached point (add-2008-hwcd-3, a=-1); its four
    input products, the sums and the four output products each one
    stacked call, as in :func:`point_double`."""
    X1, Y1, Z1, T1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    q, p = torch.broadcast_tensors(q, p)
    A, B, C, Dd = fe.mul(
        torch.stack([fe.sub(Y1, X1), fe.add(Y1, X1), q[..., 2, :],
                     q[..., 3, :]], dim=-2),
        torch.stack([q[..., 1, :], q[..., 0, :], T1, Z1], dim=-2)
    ).unbind(-2)
    E, F = fe.sub(torch.stack([B, Dd], dim=-2),
                  torch.stack([A, C], dim=-2)).unbind(-2)
    G, H = fe.add(torch.stack([Dd, B], dim=-2),
                  torch.stack([C, A], dim=-2)).unbind(-2)
    return fe.mul(torch.stack([E, G, F, E], dim=-2),
                  torch.stack([F, H, G, H], dim=-2))


def point_neg(p: torch.Tensor) -> torch.Tensor:
    X, Y, Z, T = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    return _pt(fe.neg(X), Y, Z, fe.neg(T))


def decompress(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 32) uint8 -> (point (..., 4, 22), ok (...,) bool), RFC 8032."""
    y = fe.decode_bytes(b)
    sign = (b[..., 31].to(torch.int64) >> 7) & 1
    canonical = torch.all(y == fe.freeze(y), dim=-1)
    one = fe.const("ONE", y)
    yy = fe.sqr(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const("D_LIMBS", y)), one)
    v3 = fe.mul(v, fe.sqr(v))
    v7 = fe.mul(fe.sqr(v3), v)
    t = fe.pow_p58(fe.mul(u, v7))
    x = fe.mul(fe.mul(u, v3), t)
    vx2 = fe.mul(v, fe.sqr(x))
    ok_direct = fe.eq(vx2, u)
    ok_flipped = fe.eq(vx2, fe.neg(u))
    x = torch.where(ok_flipped.unsqueeze(-1),
                    fe.mul(x, fe.const("SQRT_M1_LIMBS", x)), x)
    ok = canonical & (ok_direct | ok_flipped)
    ok = ok & ~(fe.is_zero(x) & (sign == 1))
    flip = fe.parity(x) != sign
    x = torch.where(flip.unsqueeze(-1), fe.neg(x), x)
    return _pt(x, y, one.expand_as(x), fe.mul(x, y)), ok


def compress(p: torch.Tensor) -> torch.Tensor:
    """Extended point -> (..., 32) uint8 canonical compressed encoding."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    zi = fe.invert(Z)
    enc = fe.encode_bytes(fe.mul(Y, zi)).clone()
    sign = (fe.parity(fe.mul(X, zi)) << 7).to(torch.uint8)
    enc[..., 31] |= sign
    return enc


def _nibbles(s: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 64) int64 nibbles, little-endian."""
    s = s.to(torch.int64)
    return torch.stack([s & 0xF, (s >> 4) & 0xF], dim=-1).reshape(
        *s.shape[:-1], WINDOWS)


def _identity_cached() -> np.ndarray:
    return np.stack([fe.limbs_from_int(1), fe.limbs_from_int(1),
                     fe.limbs_from_int(0), fe.limbs_from_int(2)])


def _base_points():
    """Affine j*B for j = 1..15 (host ints, shared by both tables)."""
    out = []
    for j in range(1, 16):
        X, Y, Z, _ = ref.base_mult(j)
        zi = pow(Z, ref.P - 2, ref.P)
        out.append(((X * zi) % ref.P, (Y * zi) % ref.P))
    return out


_BASE_POINTS = _base_points()


def _base_table_limbs() -> np.ndarray:
    """Cached multiples j*B, j = 0..15, shape (16, 4, 22) (the reference's
    static base table)."""
    rows = [_identity_cached()]
    for x, y in _BASE_POINTS:
        rows.append(np.stack([
            fe.limbs_from_int((y + x) % ref.P),
            fe.limbs_from_int((y - x) % ref.P),
            fe.limbs_from_int((2 * ref.D * x * y) % ref.P),
            fe.limbs_from_int(2)]))
    return np.stack(rows)


_BASE_TABLE = _base_table_limbs()
_IDENTITY = np.stack([fe.limbs_from_int(0), fe.limbs_from_int(1),
                      fe.limbs_from_int(1), fe.limbs_from_int(0)])
_IDENTITY_CACHED = _identity_cached()


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A module limb table as an int64 tensor on ``device``."""
    return torch.from_numpy(globals()[name].copy()).to(device)


@torch.inference_mode()
def verify_kernel_plain(pk: torch.Tensor, rb: torch.Tensor,
                        s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The plain version of K-c: (B, 32) uint8 x 4 -> (B,) bool. Its
    thousands of small integer ops run in inference mode: no autograd
    bookkeeping, the same values."""
    batch = pk.shape[0]
    A, ok_a = decompress(pk)
    a_neg = point_neg(A)
    a_cached = to_cached(a_neg)
    rows = [_table("_IDENTITY_CACHED", a_cached.device).expand_as(a_cached),
            a_cached]
    pt = a_neg
    for _ in range(14):
        pt = point_add_cached(pt, a_cached)
        rows.append(to_cached(pt))
    table_a = torch.stack(rows, dim=1)  # (B, 16, 4, 22)
    base_table = _table("_BASE_TABLE", a_cached.device)  # (16, 4, 22)
    s_nib = _nibbles(s)
    h_nib = _nibbles(h)
    rows_idx = torch.arange(batch, device=pk.device)
    acc = _table("_IDENTITY", a_cached.device).expand_as(a_cached)
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = point_double(acc)
        acc = point_add_cached(acc, base_table[s_nib[:, w]])
        acc = point_add_cached(acc, table_a[rows_idx, h_nib[:, w]])
    enc = compress(acc)
    return ok_a & torch.all(enc == rb, dim=-1)


# --- the kernel wrapper ------------------------------------------------------


def _fe51_limbs(x: int):
    return [(x >> (51 * i)) & ((1 << 51) - 1) for i in range(5)]


@functools.lru_cache(maxsize=None)
def _kernel_consts(device: torch.device) -> torch.Tensor:
    """csrc/ed25519.cu's constant block: the cached base table in radix
    2^51 (16 x 4 x 5), then d, 2d and sqrt(-1)."""
    words = []
    words += _fe51_limbs(1) + _fe51_limbs(1) + _fe51_limbs(0) \
        + _fe51_limbs(2)
    for x, y in _BASE_POINTS:
        words += _fe51_limbs((y + x) % ref.P)
        words += _fe51_limbs((y - x) % ref.P)
        words += _fe51_limbs((2 * ref.D * x * y) % ref.P)
        words += _fe51_limbs(2)
    words += _fe51_limbs(ref.D) + _fe51_limbs((2 * ref.D) % ref.P) \
        + _fe51_limbs(ref.SQRT_M1)
    return torch.tensor(words, dtype=torch.int64, device=device)


def kernel_operands(pk: torch.Tensor, rb: torch.Tensor, s: torch.Tensor,
                    h: torch.Tensor, what: str) -> list:
    """The pointers K-c's body takes (``csrc/ed25519.cu`` ``verify_item``,
    in K-c and in K14): pk, R, S and h, each checked to be a contiguous
    (B, 32) uint8 tensor on pk's device, then the constant block."""
    batch = pk.shape[0]
    for name, t in (("pk", pk), ("R", rb), ("S", s), ("h", h)):
        if (t.dtype != torch.uint8 or tuple(t.shape) != (batch, 32)
                or not t.is_contiguous() or t.device != pk.device):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"(B, 32) uint8 tensor on {pk.device}")
    return [pk.data_ptr(), rb.data_ptr(), s.data_ptr(), h.data_ptr(),
            _kernel_consts(pk.device).data_ptr()]


def verify_kernel(pk: torch.Tensor, rb: torch.Tensor, s: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """K-c: (B, 32) uint8 x 4 (pk, R, S, h) -> (B,) bool. CPU tensors take
    the plain version; CUDA tensors launch ``ed25519_verify_kernel`` or
    raise."""
    if pk.device.type == "cpu":
        return verify_kernel_plain(pk, rb, s, h)
    if pk.device.type != "cuda":
        raise ValueError(f"verify_kernel: unsupported device {pk.device}")
    ptrs = kernel_operands(pk, rb, s, h, "verify_kernel")
    ok = torch.empty(pk.shape[0], dtype=torch.bool, device=pk.device)
    code = kb.library().ed25519_verify_launch(
        *ptrs[:4], ok.data_ptr(), ptrs[4], pk.shape[0],
        torch.cuda.current_stream(pk.device).cuda_stream)
    kb.check(code, "ed25519_verify")
    kb.LAUNCHES["ed25519_verify"] += 1
    return ok


def verify_kernel_full(pk: torch.Tensor, rb: torch.Tensor, s: torch.Tensor,
                       msg_blocks: torch.Tensor,
                       n_blocks: torch.Tensor) -> torch.Tensor:
    """Fully on-device verify: ``msg_blocks`` are host-padded SHA-512
    blocks of R || A || M; K-a -> K-b -> K-c on the current stream."""
    h = s512.reduce_mod_l(s512.sha512_blocks(msg_blocks, n_blocks))
    return verify_kernel(pk, rb, s, h)


# --- host preparation (copies of the reference's) ---------------------------


def _reduce_mod_l(h64: bytes) -> bytes:
    return (int.from_bytes(h64, "little") % ref.L).to_bytes(32, "little")


def _structural_ok(pk: bytes, sig: bytes) -> bool:
    """Per-item admission shared by BOTH host-hash and device-hash prep:
    the two tiers must reject identically."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    return int.from_bytes(sig[32:], "little") < ref.L


def prepare_batch(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-hash tier: (pk, R, S, h) uint8 (B, 32) arrays + prevalid mask."""
    n = len(sigs)
    pk_a = np.zeros((n, 32), np.uint8)
    r_a = np.zeros((n, 32), np.uint8)
    s_a = np.zeros((n, 32), np.uint8)
    h_a = np.zeros((n, 32), np.uint8)
    pre = np.zeros(n, bool)
    for i, (pk, msg, sig) in enumerate(zip(pks, msgs, sigs)):
        if not _structural_ok(pk, sig):
            continue
        pre[i] = True
        pk_a[i] = np.frombuffer(pk, np.uint8)
        r_a[i] = np.frombuffer(sig[:32], np.uint8)
        s_a[i] = np.frombuffer(sig[32:], np.uint8)
        h = hashlib.sha512(sig[:32] + pk + msg).digest()
        h_a[i] = np.frombuffer(_reduce_mod_l(h), np.uint8)
    return pk_a, r_a, s_a, h_a, pre


def _pad_to(n: int) -> int:
    size = 8
    while size < n:
        size *= 2
    return size


def prepare_batch_device(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    max_blocks: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """Device-hash tier: structural checks + padded SHA-512 blocks; NO
    hashing on the host, only byte moves."""
    n = len(sigs)
    pk_a = np.zeros((n, 32), np.uint8)
    r_a = np.zeros((n, 32), np.uint8)
    s_a = np.zeros((n, 32), np.uint8)
    pre = np.zeros(n, bool)
    prefixes = []
    kept_msgs = []
    for i, (pk, msg, sig) in enumerate(zip(pks, msgs, sigs)):
        if not _structural_ok(pk, sig):
            prefixes.append(b"\x00" * 64)
            kept_msgs.append(b"")
            continue
        pre[i] = True
        pk_a[i] = np.frombuffer(pk, np.uint8)
        r_a[i] = np.frombuffer(sig[:32], np.uint8)
        s_a[i] = np.frombuffer(sig[32:], np.uint8)
        prefixes.append(sig[:32] + pk)
        kept_msgs.append(msg)
    blocks, counts = s512.pad_ed25519_messages(prefixes, kept_msgs,
                                               max_blocks)
    return pk_a, r_a, s_a, blocks, counts, pre


def max_blocks_for(msgs: Sequence[bytes]) -> int:
    """Power-of-two SHA-512 block bucket for a batch."""
    longest = max((len(m) for m in msgs), default=0)
    need = (64 + longest + 17 + 127) // 128
    bucket = 1
    while bucket < need:
        bucket *= 2
    return bucket


def to_device(arrays, device: torch.device):
    """Host arrays -> tensors on ``device`` (one H2D copy each)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def batch_verify(pks: Sequence[bytes], msgs: Sequence[bytes],
                 sigs: Sequence[bytes], device: DeviceLike = None
                 ) -> np.ndarray:
    """Verify a batch of Ed25519 signatures; returns (B,) bool. Hashing
    runs on the device (``verify_kernel_full``); the host only packs
    padded blocks and range-checks S. Runs on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    n = len(sigs)
    if n == 0:
        return np.zeros(0, bool)
    max_blocks = max_blocks_for(msgs)
    pk_a, r_a, s_a, blocks, counts, pre = prepare_batch_device(
        pks, msgs, sigs, max_blocks)
    pad = _pad_to(n) - n

    def padded(a):
        return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))

    ok = verify_kernel_full(*to_device(
        [padded(a) for a in (pk_a, r_a, s_a, blocks, counts)], dev))
    return ok.cpu().numpy()[:n] & pre
