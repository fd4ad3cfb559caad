"""Batched SHA-512 and h mod L for the Ed25519 ingress (PyTorch + CUDA).

Port of ``indy_plenum_tpu/tpu/sha512.py``. Two kernels, each with its
plain PyTorch version beside it:

- :func:`sha512_blocks` (K-a, reference ``sha512.py:201``): SHA-512 over
  host-padded blocks with a per-item active-block count;
- :func:`reduce_mod_l` (K-b, reference ``sha512.py:249``): a 64-byte
  little-endian hash to its residue mod L.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel (``csrc/sha512.cu``) or raises.
The plain versions carry 64-bit words as (hi, lo) 32-bit halves in int64
lanes masked to 0xFFFFFFFF, as the reference does in uint32 lanes: CPU
torch has no unsigned 64-bit shifts or wrapping adds to rely on.

The round constants and initial state are DERIVED here (fractional parts
of cube/square roots of the first primes, FIPS 180-4), as in the
reference, for the plain version; the kernel holds the same values as a
``constexpr`` table in its source (the tests hold the two equal).
"""
from __future__ import annotations

import functools
import math
from collections import defaultdict
from typing import List, Tuple

import numpy as np
import torch

from ..utils import kernel_build as kb

# --- constants, derived (FIPS 180-4) ---------------------------------------


def _first_primes(n: int):
    out, cand = [], 2
    while len(out) < n:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return out


def _icbrt(x: int) -> int:
    r = 1 << ((x.bit_length() + 2) // 3)
    while True:
        nr = (2 * r + x // (r * r)) // 3
        if nr >= r:
            break
        r = nr
    while r * r * r > x:
        r -= 1
    while (r + 1) ** 3 <= x:
        r += 1
    return r


_PRIMES80 = _first_primes(80)
_K64 = [(_icbrt(p << 192)) & ((1 << 64) - 1) for p in _PRIMES80]
_H064 = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in _PRIMES80[:8]]

L = (1 << 252) + 27742317777372353535851937790883648493
_LADDER = 260  # L << 259 > 2^511 >= any SHA-512 output
M32 = 0xFFFFFFFF


def _as_int64(words) -> np.ndarray:
    """uint64 values -> their int64 bit patterns (what a torch int64
    tensor hands the kernel as ``uint64_t*``)."""
    return np.array(words, dtype=np.uint64).view(np.int64)


# Barrett's constant for the kernel: mu = floor(2^512 / L), 5 limbs of 64
# bits (2^259 <= mu < 2^260)
MU = (1 << 512) // L


def limbs64(value: int, n: int):
    """``value`` as ``n`` little-endian 64-bit limbs."""
    return [(value >> (64 * j)) & ((1 << 64) - 1) for j in range(n)]


@functools.lru_cache(maxsize=None)
def _barrett_table(device: torch.device) -> torch.Tensor:
    """The kernel's constants: L in 4 limbs, then mu in 5."""
    return torch.from_numpy(_as_int64(limbs64(L, 4) + limbs64(MU, 5))).to(
        device)


@functools.lru_cache(maxsize=None)
def _l_shift_limbs32(device: torch.device) -> torch.Tensor:
    """The same table as 17 32-bit limbs per row (plain version)."""
    rows = []
    for i in range(_LADDER - 1, -1, -1):
        v = L << i
        rows.append([(v >> (32 * j)) & M32 for j in range(17)])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_aligned(t: torch.Tensor, name: str, align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- the plain version: 64-bit words as (hi, lo) 32-bit halves -------------


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _rotr64(h, lo, n: int):
    if n < 32:
        return (((h >> n) | (lo << (32 - n))) & M32,
                ((lo >> n) | (h << (32 - n))) & M32)
    if n == 32:
        return lo, h
    m = n - 32
    return (((lo >> m) | (h << (32 - m))) & M32,
            ((h >> m) | (lo << (32 - m))) & M32)


def _shr64(h, lo, n: int):
    return h >> n, ((lo >> n) | (h << (32 - n))) & M32


def _sigma(h, lo, r1, r2, r3, shift_last: bool):
    ah, al = _rotr64(h, lo, r1)
    bh, bl = _rotr64(h, lo, r2)
    ch, cl = _shr64(h, lo, r3) if shift_last else _rotr64(h, lo, r3)
    return ah ^ bh ^ ch, al ^ bl ^ cl


def _compress512(sh: List[torch.Tensor], sl: List[torch.Tensor],
                 wh: List[torch.Tensor], wl: List[torch.Tensor]):
    """One compression over (B,) halves: state (8), block words (16)."""
    wh, wl = list(wh), list(wl)
    for t in range(16, 80):
        s0h, s0l = _sigma(wh[t - 15], wl[t - 15], 1, 8, 7, True)
        s1h, s1l = _sigma(wh[t - 2], wl[t - 2], 19, 61, 6, True)
        th, tl = _add64(wh[t - 16], wl[t - 16], s0h, s0l)
        th, tl = _add64(th, tl, wh[t - 7], wl[t - 7])
        th, tl = _add64(th, tl, s1h, s1l)
        wh.append(th)
        wl.append(tl)
    ah, bh, ch, dh, eh, fh, gh, hh = sh
    al, bl, cl, dl, el, fl, gl, hl = sl
    for t in range(80):
        k = _K64[t]
        s1h, s1l = _sigma(eh, el, 14, 18, 41, False)
        chh = (eh & fh) ^ ((~eh & M32) & gh)
        chl = (el & fl) ^ ((~el & M32) & gl)
        t1h, t1l = _add64(hh, hl, s1h, s1l)
        t1h, t1l = _add64(t1h, t1l, chh, chl)
        t1l = t1l + (k & M32)
        t1h = (t1h + (k >> 32) + (t1l >> 32)) & M32
        t1l = t1l & M32
        t1h, t1l = _add64(t1h, t1l, wh[t], wl[t])
        s0h, s0l = _sigma(ah, al, 28, 34, 39, False)
        mjh = (ah & bh) ^ (ah & ch) ^ (bh & ch)
        mjl = (al & bl) ^ (al & cl) ^ (bl & cl)
        t2h, t2l = _add64(s0h, s0l, mjh, mjl)
        hh, hl = gh, gl
        gh, gl = fh, fl
        fh, fl = eh, el
        eh, el = _add64(dh, dl, t1h, t1l)
        dh, dl = ch, cl
        ch, cl = bh, bl
        bh, bl = ah, al
        ah, al = _add64(t1h, t1l, t2h, t2l)
    out_h, out_l = [], []
    for x, y, p, q in zip(sh, sl, (ah, bh, ch, dh, eh, fh, gh, hh),
                          (al, bl, cl, dl, el, fl, gl, hl)):
        rh, rl = _add64(x, y, p, q)
        out_h.append(rh)
        out_l.append(rl)
    return out_h, out_l


def sha512_blocks_plain(blocks: torch.Tensor,
                        n_blocks: torch.Tensor) -> torch.Tensor:
    """The plain version of K-a: (B, NB, 128) uint8 + (B,) int32 ->
    (B, 64) uint8; rows past ``n_blocks[i]`` are ignored."""
    b = blocks.to(torch.int64)
    batch, nb = b.shape[0], b.shape[1]
    octs = b.reshape(batch, nb, 16, 8)
    hi = ((octs[..., 0] << 24) | (octs[..., 1] << 16)
          | (octs[..., 2] << 8) | octs[..., 3])
    lo = ((octs[..., 4] << 24) | (octs[..., 5] << 16)
          | (octs[..., 6] << 8) | octs[..., 7])
    zeros = torch.zeros(batch, dtype=torch.int64, device=blocks.device)
    sh = [zeros + (h >> 32) for h in _H064]
    sl = [zeros + (h & M32) for h in _H064]
    counts = n_blocks.to(torch.int64)
    for i in range(nb):
        wh = [hi[:, i, j] for j in range(16)]
        wl = [lo[:, i, j] for j in range(16)]
        nh, nl = _compress512(sh, sl, wh, wl)
        active = i < counts
        sh = [torch.where(active, x, y) for x, y in zip(nh, sh)]
        sl = [torch.where(active, x, y) for x, y in zip(nl, sl)]
    words = torch.stack(
        [torch.stack([h, l], dim=-1) for h, l in zip(sh, sl)], dim=1)
    shifts = torch.tensor([24, 16, 8, 0], device=blocks.device)
    out = (words.unsqueeze(-1) >> shifts) & 0xFF  # (B, 8, 2, 4)
    return out.reshape(batch, 64).to(torch.uint8)


def reduce_mod_l_plain(h_le_bytes: torch.Tensor) -> torch.Tensor:
    """The plain version of K-b: (B, 64) uint8 LE -> (B, 32) uint8 LE of
    h mod L, by the reference's conditional-subtract ladder (260 steps;
    limbs of 32 bits here instead of 16)."""
    b = h_le_bytes.to(torch.int64)
    batch = b.shape[0]
    quads = b.reshape(batch, 16, 4)
    limbs = (quads[..., 0] | (quads[..., 1] << 8) | (quads[..., 2] << 16)
             | (quads[..., 3] << 24))
    h = [limbs[:, j] for j in range(16)]
    h.append(torch.zeros_like(h[0]))
    table = _l_shift_limbs32(h_le_bytes.device)
    for r in range(_LADDER):
        row = table[r]
        diffs = []
        borrow = torch.zeros_like(h[0])
        for j in range(17):
            d = h[j] - row[j] - borrow
            borrow = (d < 0).to(torch.int64)
            diffs.append(d + (borrow << 32))
        keep = borrow == 0
        h = [torch.where(keep, d, x) for d, x in zip(diffs, h)]
    out = torch.stack(h[:8], dim=1)  # < L < 2^253
    shifts = torch.tensor([0, 8, 16, 24], device=h_le_bytes.device)
    return ((out.unsqueeze(-1) >> shifts) & 0xFF).reshape(
        batch, 32).to(torch.uint8)


# --- kernel wrappers --------------------------------------------------------


def sha512_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor
                  ) -> torch.Tensor:
    """K-a. CPU tensors take the plain version; CUDA tensors launch
    ``sha512_blocks_kernel`` or raise (a CUDA tensor that is not 16-byte
    aligned raises too: rows are read as 16-byte vectors)."""
    if blocks.device.type == "cpu":
        return sha512_blocks_plain(blocks, n_blocks)
    _require_cuda(blocks, "sha512_blocks")
    _check(blocks, "blocks", torch.uint8, 3)
    _check(n_blocks, "n_blocks", torch.int32, 1)
    batch, nb, width = blocks.shape
    if width != 128 or n_blocks.shape[0] != batch \
            or n_blocks.device != blocks.device:
        raise ValueError("sha512_blocks: blocks (B, NB, 128) and "
                         "n_blocks (B,) on one device")
    _check_aligned(blocks, "blocks", 16)
    out = torch.empty((batch, 64), dtype=torch.uint8, device=blocks.device)
    code = kb.library().sha512_blocks_launch(
        blocks.data_ptr(), n_blocks.data_ptr(), out.data_ptr(), batch, nb,
        _stream(blocks))
    kb.check(code, "sha512_blocks")
    kb.LAUNCHES["sha512_blocks"] += 1
    return out


def reduce_mod_l(h_le_bytes: torch.Tensor) -> torch.Tensor:
    """K-b. CPU tensors take the plain version (the reference's ladder);
    CUDA tensors launch ``reduce_mod_l_kernel`` (a Barrett reduction) or
    raise."""
    if h_le_bytes.device.type == "cpu":
        return reduce_mod_l_plain(h_le_bytes)
    _require_cuda(h_le_bytes, "reduce_mod_l")
    _check(h_le_bytes, "h", torch.uint8, 2)
    if h_le_bytes.shape[1] != 64:
        raise ValueError("reduce_mod_l: expected (B, 64) bytes")
    _check_aligned(h_le_bytes, "h", 8)
    batch = h_le_bytes.shape[0]
    out = torch.empty((batch, 32), dtype=torch.uint8,
                      device=h_le_bytes.device)
    lib = kb.library()
    code = lib.reduce_mod_l_launch(
        h_le_bytes.data_ptr(), out.data_ptr(),
        _barrett_table(h_le_bytes.device).data_ptr(), batch,
        _stream(h_le_bytes))
    kb.check(code, "reduce_mod_l")
    kb.LAUNCHES["reduce_mod_l"] += 1
    return out


def pad_ed25519_messages(prefixes, msgs, max_blocks: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side packing (copy of the reference's): (R||A) prefixes +
    messages -> (B, max_blocks, 128) uint8 FIPS-padded blocks + (B,) int32
    block counts, vectorized per distinct message length."""
    n = len(msgs)
    plen = len(prefixes[0]) if prefixes else 0
    buf = np.zeros((n, max_blocks * 128), np.uint8)
    counts = np.zeros(n, np.int32)
    if n == 0:
        return buf.reshape(n, max_blocks, 128), counts
    buf[:, :plen] = np.frombuffer(b"".join(prefixes),
                                  np.uint8).reshape(n, plen)
    by_len = defaultdict(list)
    for i, m in enumerate(msgs):
        by_len[len(m)].append(i)
    for mlen, idx_list in by_len.items():
        idxs = np.asarray(idx_list)
        total = plen + mlen
        nb = (total + 17 + 127) // 128
        assert nb <= max_blocks, (total, max_blocks)
        if mlen:
            arr = np.frombuffer(
                b"".join(msgs[i] for i in idx_list),
                np.uint8).reshape(len(idx_list), mlen)
            buf[idxs, plen:total] = arr
        buf[idxs, total] = 0x80
        bits = np.frombuffer((total * 8).to_bytes(16, "big"), np.uint8)
        buf[np.ix_(idxs, np.arange(nb * 128 - 16, nb * 128))] = bits
        counts[idxs] = nb
    return buf.reshape(n, max_blocks, 128), counts


def sha512_host_oracle(data: bytes) -> bytes:
    """hashlib's SHA-512, the reference's host oracle for the kernel's
    digests (``indy_plenum_tpu/tpu/sha512.py:337``)."""
    import hashlib

    return hashlib.sha512(data).digest()
