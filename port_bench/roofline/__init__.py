"""The least time one NVIDIA H100 could take for a kernel's work, from the
operations and bytes the work needs.

Frozen copy of ``chip_smoke.py``'s table of peaks and its formulas for
K-c (``csrc/ed25519.cu`` ``ed25519_verify_kernel``), K7
(``csrc/quorum.cu`` ``quorum_step_kernel``) and K10 (``csrc/sha256.cu``
``audit_fold_kernel``): ``bound`` and the instruction counts at the top
of that script, ``step_work`` and the K10 entries of its kernels line.
Peaks are NVIDIA's data sheet for the SXM part at its 700 W limit: HBM3
at 3.35 TB/s, and 32-bit integer instructions at 132 SMs x 64 lanes x
1.98 GHz. The instruction counts are lower bounds (the dominant terms
only, counted from the CUDA sources), so a share of this bound is a
share of a floor: it cannot pass 100 % while the counts hold.

Each ``*_work`` function takes the shapes one launch was given and
returns (bytes moved once, 32-bit instructions).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Ed25519 verify, per signature: a field multiply is 25 64x64->128
# products x 8 instructions + ~110 for the column sums and carries, a
# square 15 products + ~90. Decompress: 18 multiplies, 255 squares; the
# rest: x*y 1, table 127 multiplies, 64 windows x (32 multiplies + 16
# squares), compress 13 multiplies + 254 squares.
FE_MUL_OPS = 25 * 8 + 110
FE_SQR_OPS = 15 * 8 + 90
DECOMPRESS_OPS_PER_ITEM = 18 * FE_MUL_OPS + 255 * FE_SQR_OPS
VERIFY_OPS_PER_ITEM = (DECOMPRESS_OPS_PER_ITEM
                       + (1 + 127 + 64 * 32 + 13) * FE_MUL_OPS
                       + (64 * 16 + 254) * FE_SQR_OPS)
# SHA-256, per 64-byte compression: 64 rounds x 14 + 48 schedule words x
# 10 + 8 final adds; a node hash H(0x01 || l || r) is two compressions,
# less the constant-IV round and the constant words of its second block.
SHA256_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8
SHA256_IV_ROUND_SAVING = 14 - 2
SHA256_NODE_OPS = (2 * SHA256_OPS_PER_COMPRESSION - SHA256_IV_ROUND_SAVING
                   - (220 - 107))
def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the HBM rate and instructions over the
    integer issue rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def kc_work(n_signatures: int):
    """K-c over ``n_signatures`` real signatures: pk, R, S and h read
    (32 bytes each), one verdict byte written, each a full verify."""
    return (n_signatures * (4 * 32 + 1),
            n_signatures * VERIFY_OPS_PER_ITEM)


def k7_work(m: int, n: int, s: int, c: int, n_words: int, width: int,
            hits: int = 0):
    """K7 over an (M, N, S, C) group, ``n_words`` vote words and a
    compact record ``width`` slots wide (min(S, delta cap)): every
    plane read once, each word read and each hit's byte written, the
    ordered and acked planes and the frontier written, the events and the
    compact record written; a few instructions per word and vote byte."""
    state_bytes = m * (3 * s + 2 * n * s + n * c + 4)
    events_bytes = m * (3 * s + c + 8 * s)
    compact_bytes = m * (4 + 8 * width + 8 + c)
    nbytes = (state_bytes + 4 * n_words + hits + m * (2 * s + 4)
              + events_bytes + compact_bytes)
    return nbytes, 10 * n_words + m * (2 * n * s + 12 * s)


def k10_work(chunk: int, depth: int, n_table: int, levels: int):
    """K10 indexed over ``chunk`` proofs of at most ``depth`` levels, a
    deduplicated table of ``n_table`` nodes and ``levels`` node hashes in
    all: leaf hash, index, size, path length, root read and a verdict
    written per proof, a 4-byte table index per level, each table node
    read once; two compressions a level."""
    fold_bytes = chunk * (32 + 4 + 4 + 4 + 32 + 1)
    return (fold_bytes + chunk * depth * 4 + n_table * 32,
            levels * SHA256_NODE_OPS)
