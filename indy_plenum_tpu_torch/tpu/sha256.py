"""Batched SHA-256 for the ledgers' Merkle machinery (PyTorch + CUDA).

Port of ``indy_plenum_tpu/tpu/sha256.py``. Three kernels in
``csrc/sha256.cu``, each with its plain PyTorch version beside it:

- :func:`sha256_fixed` (K12, reference ``sha256.py:103``): SHA-256 of
  fixed-length messages, (B, L) uint8 -> (B, 32);
- :func:`merkle_plan_hash` (K11, reference ``_merkle_node_hash_batch``
  ``:325``, one call per level there): H(0x01 || l || r) for every node
  of a commit plan, all levels of the batched SMT commit in one launch;
  :func:`merkle_plan_hash_bytes` is the host seam the state calls once per
  commit with numpy arrays. :func:`merkle_node_hash` and
  :func:`merkle_node_hash_bytes` (``:337``) keep the reference's
  one-wave signatures and run a one-level plan;
- :func:`verify_audit_paths` / :func:`verify_audit_paths_indexed` (K10,
  ``:273`` / ``:295``): the RFC 6962 audit-path fold to a (B,) verdict,
  siblings dense (B, D, 32) or from a (U, 32) node table by (B, D) int32.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. The plain versions carry the
uint32 words in int64 lanes masked to 0xFFFFFFFF: CPU torch has no
unsigned 32-bit shift, add or not to rely on for the wraparound.

The fold's inner index/size shift runs to completion as
``MerkleVerifier.root_from_audit_path``'s while loop does; the reference
unrolls it its padded depth times (>= 16 there), which a CUDA kernel that
compiles no shapes does not carry. No XLA shape padding is carried over
either: waves and batches run at their own sizes.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..utils import kernel_build as kb
from ..utils.torch_env import DeviceLike, resolve_device

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

M32 = 0xFFFFFFFF

# K11's plans: at most the SMT's depth of levels. A plan runs in one block
# while its widest level has at most PLAN_BLOCK_NODES nodes, else in one
# cluster of up to PLAN_CLUSTER blocks, PLAN_BLOCK_NODES nodes a block
# (csrc/sha256.cu). The cut is measured (chip_smoke.py sha256_report):
# above ~100 nodes a level one SM is issue-bound, below it one node
# hash's latency binds and a cluster barrier only adds to it.
MAX_PLAN_LEVELS = 256
PLAN_BLOCK_NODES = 96
PLAN_CLUSTER = 8
# K10's threads a block (csrc/sha256.cu audit_fold_kernel); at 4,096 proofs
# 32, 64 and 128 all run one warp a scheduler (chip_smoke.py
# sha256_report times each)
AUDIT_THREADS = 128

# --- the plain versions: uint32 words in int64 lanes ------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state: List[torch.Tensor],
              block: List[torch.Tensor]) -> List[torch.Tensor]:
    """One compression over (B,) lanes: state (8 words), block (16)."""
    w = list(block)
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e & M32) & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        mj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + mj) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 big-endian -> (..., k) int64 words."""
    quads = b.to(torch.int64).reshape(b.shape[:-1] + (-1, 4))
    return ((quads[..., 0] << 24) | (quads[..., 1] << 16)
            | (quads[..., 2] << 8) | quads[..., 3])


def _words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    out = (w.unsqueeze(-1) >> shifts) & 0xFF
    return out.reshape(w.shape[:-1] + (-1,)).to(torch.uint8)


def _initial_state(batch: int, device) -> List[torch.Tensor]:
    zeros = torch.zeros(batch, dtype=torch.int64, device=device)
    return [zeros + h for h in _H0]


def sha256_fixed_plain(msg: torch.Tensor) -> torch.Tensor:
    """The plain version of K12: (..., L) uint8 -> (..., 32) uint8, padded
    as the reference pads (0x80, zeros, 64-bit big-endian bit length)."""
    msg_len = msg.shape[-1]
    lead = msg.shape[:-1]
    flat = msg.reshape(int(np.prod(lead, dtype=np.int64)), msg_len)
    n_blocks = (msg_len + 9 + 63) // 64
    pad = np.zeros(n_blocks * 64 - msg_len, np.uint8)
    pad[0] = 0x80
    pad[-8:] = np.frombuffer((msg_len * 8).to_bytes(8, "big"), np.uint8)
    pad_t = torch.from_numpy(pad).to(msg.device)
    padded = torch.cat([flat, pad_t.expand(flat.shape[0], -1)], dim=1)
    words = _bytes_to_words(padded)
    state = _initial_state(flat.shape[0], msg.device)
    for i in range(n_blocks):
        state = _compress(state, [words[:, 16 * i + j] for j in range(16)])
    return _words_to_bytes(torch.stack(state, dim=1)).reshape(lead + (32,))


def _node_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """H(0x01 || l || r) on (B, 8) words, built from word-shifted halves
    as the reference's ``_merkle_node_hash_words`` builds them."""
    lw = [left[:, i] for i in range(8)]
    rw = [right[:, i] for i in range(8)]
    w = [0x01000000 | (lw[0] >> 8)]
    w += [((lw[i - 1] << 24) & M32) | (lw[i] >> 8) for i in range(1, 8)]
    w.append(((lw[7] << 24) & M32) | (rw[0] >> 8))
    w += [((rw[i - 1] << 24) & M32) | (rw[i] >> 8) for i in range(1, 8)]
    state = _compress(_initial_state(left.shape[0], left.device), w)
    zero = torch.zeros_like(lw[0])
    w2 = [((rw[7] << 24) & M32) | 0x00800000] + [zero] * 14 + [zero + 520]
    return torch.stack(_compress(state, w2), dim=1)


def merkle_node_hash_plain(left: torch.Tensor,
                           right: torch.Tensor) -> torch.Tensor:
    """The plain version of K11: (B, 32) uint8 x 2 -> (B, 32) uint8."""
    return _words_to_bytes(_node_words(_bytes_to_words(left),
                                       _bytes_to_words(right)))


def _plan_offsets(level_offsets) -> np.ndarray:
    """Host int32 level offsets of a plan: 1 + n_levels entries (at most
    1 + :data:`MAX_PLAN_LEVELS`), nondecreasing from 0."""
    offs = np.asarray(level_offsets)
    if offs.ndim != 1 or not 1 <= offs.size <= MAX_PLAN_LEVELS + 1 \
            or offs[0] != 0 or (np.diff(offs) < 0).any() \
            or offs[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"plan level offsets must be 1 + n_levels <= "
                         f"{MAX_PLAN_LEVELS + 1} nondecreasing ints from 0")
    return np.ascontiguousarray(offs, dtype=np.int32)


def check_plan_refs(refs: np.ndarray, n_literals: int,
                    offs: np.ndarray) -> None:
    """Raise unless every operand of level l refers to a node of an
    earlier level (``[0, offs[l])``) or to a literal (``[-n_literals,
    -1]``): the kernel resolves levels in order and reads what it is
    told."""
    if refs.shape != (int(offs[-1]), 2):
        raise ValueError(f"plan refs must be ({int(offs[-1])}, 2), got "
                         f"{refs.shape}")
    if refs.size:
        starts = np.repeat(offs[:-1], np.diff(offs))[:, None]
        if not (refs < starts).all() or int(refs.min()) < -n_literals:
            raise ValueError("a plan operand refers to a node of its own "
                             "or a later level, or past the literals")


def merkle_plan_hash_plain(refs: torch.Tensor, literals: torch.Tensor,
                           level_offsets) -> torch.Tensor:
    """The plain version of K11: the plan's levels in order, each one
    batched :func:`merkle_node_hash_plain` over its operands. ``refs``
    (n, 2) int32, ``literals`` (L, 32) uint8, ``level_offsets`` host ints
    -> (n, 32) uint8 digests."""
    offs = _plan_offsets(level_offsets)
    # da: allow[device-sync] -- the plain K11 checks the plan's operands on the host before its walk; it runs on CPU tensors and as the kernel's oracle, never on the consensus tick loop
    check_plan_refs(refs.cpu().numpy(), literals.shape[0], offs)
    out = torch.empty((int(offs[-1]), 32), dtype=torch.uint8,
                      device=refs.device)
    lits = literals if literals.shape[0] else torch.zeros(
        (1, 32), dtype=torch.uint8, device=refs.device)
    # da: allow[device-sync] -- offs is the host-side numpy plan offsets; no device value involved
    for lo, hi in zip(offs[:-1].tolist(), offs[1:].tolist()):
        if hi == lo:
            continue
        r = refs[lo:hi].to(torch.int64)

        def operand(x):
            node = (x >= 0).unsqueeze(1)
            return torch.where(node, out[x.clamp(min=0)],
                               lits[(-1 - x).clamp(min=0)])

        out[lo:hi] = merkle_node_hash_plain(operand(r[:, 0]),
                                            operand(r[:, 1]))
    return out


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes wrapped to int32 values (the reference's int32 math)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def _audit_fold_plain(leaf: torch.Tensor, index: torch.Tensor,
                      sibling: Callable[[int], torch.Tensor], depth: int,
                      path_len: torch.Tensor, tree_size: torch.Tensor,
                      root: torch.Tensor) -> torch.Tensor:
    """The plain version of K10: the reference's ``_audit_fold`` over
    (B, 8) words; ``sibling(level)`` gives the level's (B, 8) words."""
    r = _bytes_to_words(leaf)
    fn = index.to(torch.int64)
    fsn = _int32(tree_size.to(torch.int64) - 1)
    plen = path_len.to(torch.int64)
    consumed = torch.zeros_like(fn)
    ok = torch.ones(fn.shape, dtype=torch.bool, device=fn.device)
    for level in range(depth):
        active = level < plen
        if not bool(active.any()):
            break  # every later level is inactive too
        use_left = ((fn & 1) == 1) | (fn == fsn)
        sib = sibling(level)
        left = torch.where(use_left[:, None], sib, r)
        right = torch.where(use_left[:, None], r, sib)
        r = torch.where(active[:, None], _node_words(left, right), r)
        ok = ok & (~active | (fsn > 0))
        shift = use_left & active
        fn2, fsn2 = fn, fsn
        while True:  # while fn % 2 == 0 and fn != 0: fn >>= 1; fsn >>= 1
            do = shift & ((fn2 & 1) == 0) & (fn2 != 0)
            if not bool(do.any()):
                break
            fn2 = torch.where(do, fn2 >> 1, fn2)
            fsn2 = torch.where(do, fsn2 >> 1, fsn2)
        fn = torch.where(active, fn2 >> 1, fn)
        fsn = torch.where(active, fsn2 >> 1, fsn)
        consumed = consumed + active.to(torch.int64)
    ok = ok & (fsn == 0) & (consumed == plen)
    return ok & (r == _bytes_to_words(root)).all(dim=1)


def verify_audit_paths_plain(leaf, index, path, path_len, tree_size,
                             root) -> torch.Tensor:
    """The plain version of K10, dense siblings (B, D, 32)."""
    words = _bytes_to_words(path)
    return _audit_fold_plain(leaf, index, lambda lv: words[:, lv, :],
                             path.shape[1], path_len, tree_size, root)


def verify_audit_paths_indexed_plain(leaf, index, table, path_idx, path_len,
                                     tree_size, root) -> torch.Tensor:
    """The plain version of K10 over a node table (U, 32) + (B, D)."""
    words = _bytes_to_words(table)
    idx = path_idx.to(torch.int64)
    return _audit_fold_plain(leaf, index, lambda lv: words[idx[:, lv]],
                             path_idx.shape[1], path_len, tree_size, root)


# --- kernel wrappers --------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           align: int = 4) -> None:
    """A contiguous tensor of ``dtype`` on ``device`` whose shape matches
    ``shape`` (None = any size), ``align``-byte aligned: 4 for word loads,
    16 for K10's 16-byte row loads."""
    ok = (t.dtype == dtype and t.is_contiguous() and t.device == device
          and t.dim() == len(shape)
          and all(want is None or got == want
                  for got, want in zip(t.shape, shape)))
    if not ok:
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the data must be {align}-byte aligned")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    return t.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --- K12's loads and word-wise padding, modelled on the host ---------------
# The kernel's own arithmetic (csrc/sha256.cu fixed_load, fixed_join,
# fixed_pad) on a numpy image of device memory: the tests hold it against
# hashlib and the reference at every length and row offset, which the card
# alone cannot show for the unaligned cases.


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte (sel >> 4n) & 7
    of the 8 bytes y:x (x holds bytes 0-3)."""
    v = (y << 32) | x
    return sum(((v >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def fixed_pad(x: int, q: int) -> int:
    """A message word padded: ``q`` is msg_len minus the word's first
    byte; the message bytes masked where the message ends, 0x80 after its
    last byte, 0 past it."""
    if q < 4:
        x = 0 if q <= 0 else x & ((0xFFFFFFFF << (32 - 8 * q)) & M32)
        if q >= 0:
            x |= 0x80000000 >> (8 * q)
    return x


def fixed_words_model(mem: np.ndarray, start: int,
                      msg_len: int) -> np.ndarray:
    """(n_blocks, 16) uint32: the padded message words K12's thread builds
    for the row of ``msg_len`` bytes at ``mem[start]``: the aligned 32-bit
    words of the row (its first byte rounded down to 4), each loaded only
    where it holds one of the row's bytes (asserted here), joined two at a
    time at the row's offset; the last block's words 14 and 15 the bit
    length."""
    s = start & 3
    base = start - s
    sel = ((s + 3) | ((s + 2) << 4) | ((s + 1) << 8) | (s << 12)) & 0xFFFF
    n_blocks = (msg_len + 9 + 63) // 64

    def load(k):  # aligned word k from the row's base
        at = base + 4 * k
        assert at + 4 > start and at < start + msg_len, "a load past the row"
        return int(mem[at:at + 4].view("<u4")[0])

    out = np.zeros((n_blocks, 16), np.uint32)
    for b in range(n_blocks):
        for i in range(16):
            q = msg_len - 64 * b - 4 * i
            lo = load(16 * b + i) if q > 0 else 0
            hi = load(16 * b + i + 1) if s and q > 4 - s else 0
            out[b, i] = fixed_pad(byte_perm(lo, hi, sel), q)
        if b == n_blocks - 1:
            out[b, 14] = (msg_len * 8) >> 32
            out[b, 15] = (msg_len * 8) & M32
    return out


def sha256_fixed_model(mem: np.ndarray, base: int, batch: int,
                       msg_len: int) -> np.ndarray:
    """(batch, 32) uint8 digests of the rows of ``msg_len`` bytes at
    ``mem[base:]``, from :func:`fixed_words_model`'s words and the plain
    compression."""
    return digest_words(np.stack([
        fixed_words_model(mem, base + r * msg_len, msg_len)
        for r in range(batch)]))


def digest_words(words: np.ndarray) -> np.ndarray:
    """(B, n_blocks, 16) uint32 padded message words -> (B, 32) uint8
    digests, by the plain compression."""
    lanes = torch.from_numpy(words.astype(np.int64))
    state = _initial_state(words.shape[0], "cpu")
    for b in range(words.shape[1]):
        state = _compress(state, [lanes[:, b, i] for i in range(16)])
    # da: allow[device-sync] -- a host model: every tensor here is a CPU tensor built from numpy; no device value involved
    return _words_to_bytes(torch.stack(state, dim=1)).numpy()


def sha256_fixed(msg: torch.Tensor,
                 msg_len: Optional[int] = None) -> torch.Tensor:
    """K12: (B, L) uint8 -> (B, 32) uint8 (``msg_len``, when given, must be
    L, as in the reference's signature). CPU tensors take the plain
    version; CUDA tensors launch ``sha256_fixed_kernel`` or raise."""
    if msg_len is not None and msg.shape[-1] != msg_len:
        raise ValueError(f"sha256_fixed: rows of {msg.shape[-1]} bytes, "
                         f"msg_len {msg_len}")
    if msg.device.type == "cpu":
        return sha256_fixed_plain(msg)
    dev = _cuda_device(msg, "sha256_fixed")
    if msg.dtype != torch.uint8 or msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError("sha256_fixed: expected a contiguous (B, L) uint8 "
                         "tensor")
    batch, length = msg.shape
    out = torch.empty((batch, 32), dtype=torch.uint8, device=dev)
    code = kb.library().sha256_fixed_launch(
        msg.data_ptr(), out.data_ptr(), batch, length, _stream(dev))
    kb.check(code, "sha256_fixed")
    kb.LAUNCHES["sha256_fixed"] += 1
    return out


def merkle_plan_hash(refs: torch.Tensor, literals: torch.Tensor,
                     level_offsets) -> torch.Tensor:
    """K11: every node of a commit plan in one launch. ``refs`` (n, 2)
    int32 operand references (>= 0: an earlier level's node; < 0:
    ``-(1 + i)``, literal i), ``literals`` (L, 32) uint8, and
    ``level_offsets``, 1 + n_levels host ints (level l is nodes
    ``[offs[l], offs[l + 1])``, bottom level first) -> (n, 32) uint8. The
    offsets stay on the host: the widest level sets the launch (one block
    up to :data:`PLAN_BLOCK_NODES` nodes, else one cluster of up to
    :data:`PLAN_CLUSTER` blocks) and they ride in the kernel's
    parameters. CPU tensors take the plain version; CUDA tensors
    launch ``merkle_plan_kernel`` or raise. On the card the operands are
    the caller's to keep in range (:func:`check_plan_refs`, which
    :func:`merkle_plan_hash_bytes` runs on its host arrays)."""
    if refs.device.type == "cpu":
        return merkle_plan_hash_plain(refs, literals, level_offsets)
    dev = _cuda_device(refs, "merkle_plan_hash")
    offs = _plan_offsets(level_offsets)
    n = int(offs[-1])
    _check(refs, "merkle_plan_hash: refs", torch.int32, (n, 2), dev)
    _check(literals, "merkle_plan_hash: literals", torch.uint8, (None, 32),
           dev)
    if refs.data_ptr() % 8:
        raise ValueError("merkle_plan_hash: refs must be 8-byte aligned")
    widest = int(np.diff(offs).max(initial=0))
    blocks = min(PLAN_CLUSTER, max(1, -(-widest // PLAN_BLOCK_NODES)))
    return _plan_launch(refs, literals, offs, blocks)


def _plan_launch(refs: torch.Tensor, literals: torch.Tensor,
                 offs: np.ndarray, blocks: int) -> torch.Tensor:
    """One ``merkle_plan_kernel`` launch on checked operands, in one block
    (``blocks`` 1) or one cluster of ``blocks`` (2 .. PLAN_CLUSTER)."""
    out = torch.empty((int(offs[-1]), 32), dtype=torch.uint8,
                      device=refs.device)
    code = kb.library().merkle_plan_launch(
        refs.data_ptr(), literals.data_ptr(), out.data_ptr(),
        offs.ctypes.data, offs.size - 1, blocks, _stream(refs.device))
    kb.check(code, "merkle_plan")
    kb.LAUNCHES["merkle_node_hash"] += 1
    return out


def _wave_refs(n: int) -> np.ndarray:
    """A one-level plan over literals ``[left; right]``: node i hashes
    literal i with literal n + i."""
    idx = np.arange(1, n + 1, dtype=np.int32)
    return np.stack([-idx, -idx - n], axis=1)


def merkle_node_hash(left: torch.Tensor, right: torch.Tensor
                     ) -> torch.Tensor:
    """K11 as one wave: H(0x01 || left || right), (B, 32) uint8 x 2 ->
    (B, 32). CPU tensors take the plain version; CUDA tensors launch
    ``merkle_plan_kernel`` on a one-level, literal-only plan, or raise."""
    if left.device.type == "cpu":
        return merkle_node_hash_plain(left, right)
    dev = _cuda_device(left, "merkle_node_hash")
    batch = left.shape[0]
    for name, t in (("left", left), ("right", right)):
        _check(t, f"merkle_node_hash: {name}", torch.uint8, (batch, 32), dev)
    idx = torch.arange(1, batch + 1, dtype=torch.int32, device=dev)
    refs = torch.stack([-idx, -idx - batch], dim=1)  # as _wave_refs
    return merkle_plan_hash(refs, torch.cat([left, right]), [0, batch])


def _check_fold(leaf, index, path_len, tree_size, root, name):
    """K10's per-proof operands, each 16-byte aligned (the kernel reads
    rows as 16-byte vectors)."""
    dev = _cuda_device(leaf, name)
    batch = leaf.shape[0]
    _check(leaf, f"{name}: leaf", torch.uint8, (batch, 32), dev, 16)
    _check(root, f"{name}: root", torch.uint8, (batch, 32), dev, 16)
    for what, t in (("index", index), ("path_len", path_len),
                    ("tree_size", tree_size)):
        _check(t, f"{name}: {what}", torch.int32, (batch,), dev, 16)
    return dev, batch


def _fold_launch(entry: str, counter: str, operands, batch: int,
                 depth: int, threads: int) -> torch.Tensor:
    """One ``audit_fold_kernel`` launch of ``threads`` a block on checked
    operands: the (B,) verdicts."""
    dev = operands[0].device
    ok = torch.empty(batch, dtype=torch.uint8, device=dev)
    code = getattr(kb.library(), entry)(
        *[t.data_ptr() for t in operands], ok.data_ptr(), batch, depth,
        threads, _stream(dev))
    kb.check(code, counter)
    kb.LAUNCHES[counter] += 1
    return ok.bool()


def _audit_dense_kernel(leaf, index, path, path_len, tree_size, root,
                        threads: int = AUDIT_THREADS) -> torch.Tensor:
    dev, batch = _check_fold(leaf, index, path_len, tree_size, root,
                             "verify_audit_paths")
    depth = path.shape[1] if path.dim() == 3 else -1
    _check(path, "verify_audit_paths: path", torch.uint8,
           (batch, depth, 32), dev, 16)
    return _fold_launch("audit_paths_launch", "audit_paths",
                        (leaf, index, path, path_len, tree_size, root),
                        batch, depth, threads)


def _audit_indexed_kernel(leaf, index, table, path_idx, path_len,
                          tree_size, root,
                          threads: int = AUDIT_THREADS) -> torch.Tensor:
    dev, batch = _check_fold(leaf, index, path_len, tree_size, root,
                             "verify_audit_paths_indexed")
    depth = path_idx.shape[1] if path_idx.dim() == 2 else -1
    _check(table, "verify_audit_paths_indexed: table", torch.uint8,
           (None, 32), dev, 16)
    _check(path_idx, "verify_audit_paths_indexed: path_idx", torch.int32,
           (batch, depth), dev, 16)
    return _fold_launch("audit_paths_indexed_launch", "audit_paths_indexed",
                        (leaf, index, table, path_idx, path_len, tree_size,
                         root), batch, depth, threads)


def verify_audit_paths(leaf: torch.Tensor, index: torch.Tensor,
                       path: torch.Tensor, path_len: torch.Tensor,
                       tree_size: torch.Tensor,
                       root: torch.Tensor) -> torch.Tensor:
    """K10, dense: leaf hashes (B, 32) uint8, index (B,) int32, path
    (B, D, 32) uint8, path_len (B,) int32, tree_size (B,) int32, root
    (B, 32) -> (B,) bool. CPU tensors take the plain version; CUDA
    tensors launch ``audit_fold_kernel`` or raise (a misaligned operand
    raises: every one must be 16-byte aligned)."""
    if leaf.device.type == "cpu":
        return verify_audit_paths_plain(leaf, index, path, path_len,
                                        tree_size, root)
    return _audit_dense_kernel(leaf, index, path, path_len, tree_size, root)


def verify_audit_paths_indexed(leaf: torch.Tensor, index: torch.Tensor,
                               table: torch.Tensor, path_idx: torch.Tensor,
                               path_len: torch.Tensor,
                               tree_size: torch.Tensor,
                               root: torch.Tensor) -> torch.Tensor:
    """K10 over a deduplicated node table: table (U, 32) uint8 and
    path_idx (B, D) int32 (every entry in [0, U)) instead of dense paths.
    CPU tensors take the plain version; CUDA tensors launch
    ``audit_fold_kernel`` or raise (a misaligned operand raises: every
    one must be 16-byte aligned)."""
    if leaf.device.type == "cpu":
        return verify_audit_paths_indexed_plain(
            leaf, index, table, path_idx, path_len, tree_size, root)
    return _audit_indexed_kernel(leaf, index, table, path_idx, path_len,
                                 tree_size, root)


def merkle_plan_hash_bytes(refs: np.ndarray, literals: np.ndarray,
                           level_offsets,
                           device: DeviceLike = None) -> np.ndarray:
    """Host-array seam for a commit plan: ``refs`` (n, 2) int32,
    ``literals`` (L, 32) uint8 and the level offsets in, the (n, 32)
    uint8 digests out. The operands are checked on the host
    (:func:`check_plan_refs`). On the card refs and literals cross in
    ONE pinned buffer with a non-blocking copy, K11 runs once on the
    current stream and every digest comes back into pinned memory behind
    one event. The digests are the product (the commit's dirty nodes and
    its root) and commits run off the vote-plane tick loop, so the call
    blocks, as the reference's per-wave call does."""
    dev = resolve_device(device)
    offs = _plan_offsets(level_offsets)
    refs = np.ascontiguousarray(refs, dtype=np.int32)
    literals = np.ascontiguousarray(literals, dtype=np.uint8).reshape(-1, 32)
    check_plan_refs(refs, literals.shape[0], offs)
    n = refs.shape[0]
    if dev.type == "cpu":
        # da: allow[device-sync] -- the CPU path: the plain version's tensors are host tensors already
        return merkle_plan_hash_plain(torch.tensor(refs),
                                      torch.tensor(literals), offs).numpy()
    ref_bytes = 8 * n
    staged = torch.empty(ref_bytes + literals.size, dtype=torch.uint8,
                         pin_memory=True)
    # da: allow[device-sync] -- a numpy view of the pinned HOST staging buffer; no device value involved
    view = staged.numpy()
    view[:ref_bytes] = refs.view(np.uint8).reshape(-1)
    view[ref_bytes:] = literals.reshape(-1)
    on_card = staged.to(dev, non_blocking=True)
    out = merkle_plan_hash(on_card[:ref_bytes].view(torch.int32).view(n, 2),
                           on_card[ref_bytes:].view(-1, 32), offs)
    host = torch.empty((n, 32), dtype=torch.uint8, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    # da: allow[device-sync] -- wave result is the product; state commit runs outside the consensus tick loop
    done.synchronize()
    # da: allow[device-sync] -- the digests came back into pinned host memory behind the event above
    return host.numpy()


def merkle_node_hash_bytes(left: np.ndarray, right: np.ndarray,
                           device: DeviceLike = None) -> np.ndarray:
    """Host-array seam of one wave, the reference's signature: (n, 32)
    uint8 host arrays in, the resolved (n, 32) uint8 host array out. It
    rides :func:`merkle_plan_hash_bytes` as a one-level plan."""
    n = left.shape[0]
    return merkle_plan_hash_bytes(_wave_refs(n),
                                  np.concatenate([left, right]), [0, n],
                                  device)


def sha256_host_oracle(data: bytes) -> bytes:
    """hashlib's SHA-256, the reference's host oracle for the kernels'
    digests (``indy_plenum_tpu/tpu/sha256.py:360``)."""
    import hashlib

    return hashlib.sha256(data).digest()
