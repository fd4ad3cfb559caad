// SHA-256 for the ledgers' Merkle machinery: fixed-length messages, the
// RFC 6962 node hash H(0x01 || l || r), and the audit-path fold.
//
// Replaces (JAX reference, indy_plenum_tpu/tpu/sha256.py):
//   K12  sha256_fixed (sha256.py:103) / merkle_node_hash (:127) - SHA-256
//        of fixed-length messages, padded at trace time there;
//   K11  _merkle_node_hash_batch (:325, jit :334) via
//        merkle_node_hash_bytes (:337) - the per-level waves of the batched
//        SMT commit, (B, 32) x 2 -> (B, 32) each, in the uint32-lane word
//        form of _merkle_node_hash_words (:195). Here one launch resolves
//        a whole commit plan: every level of it, bottom up;
//   K10  _verify_audit_paths (:273) / _verify_audit_paths_indexed (:295),
//        the fold _audit_fold (:221) - RFC 6962 audit paths against a
//        root, dense (B, D, 32) siblings or a (U, 32) node table indexed
//        by (B, D) int32.
//
// What bounds them on an H100: integer issue, and at the main path's sizes
// one thread's chain. One compression is 64 dependent rounds of 32-bit
// rotates, adds and logic (~1,400 instructions with the schedule, 3-input
// logic and adds merged into LOP3 and IADD3) for 64 bytes of message, so
// even a node hash, which reads 64 bytes and writes 32, needs ~2,600
// instructions per 96 bytes moved - far above the card's ~5 instructions
// per byte balance (16.7e12 INT32/s over 3.35e12 B/s). K10 reads one
// 32-byte sibling per level and does two compressions per level.
//
// Design:
//   - one device function for the compression: the state and a rolling
//     16-word schedule window stay in registers, the 64 rounds are
//     unrolled (K11, K12; K10 rolls the 48 scheduled ones 16 a loop
//     iteration, node_hash_rolled), K sits in __constant__ memory (every
//     thread of a warp reads the same round constant at once: a
//     broadcast), rotates are __funnelshift_r; big-endian words are
//     loaded with __byte_perm;
//   - node_hash builds the two message blocks straight from word-shifted
//     halves as the reference's word path does (prefix word 0x01000000 |
//     l0>>8, second block r7<<24 | 0x00800000, zeros, bit length 520): no
//     byte round-trips. K10 and K11 share it;
//   - K11 (merkle_plan_kernel) takes a commit plan: the planned nodes of
//     every level in one array, bottom level first, each with two int32
//     operand references (>= 0: an earlier node's digest; < 0: -(1 + i)
//     into a table of 32-byte literals - siblings, defaults, leaf hashes)
//     and the levels' start offsets. The SMT's levels are ~250 deep and
//     each needs the one below, so the per-wave form paid a launch and a
//     host round trip per level; here one launch walks the levels with a
//     barrier between them. Node j of a level is thread j / blocks of
//     block j % blocks (looping where a level is wider than the
//     threads), so a narrow level still spreads over every block. The
//     wrapper sizes the launch from the widest level: one block
//     (__syncthreads between levels) up to PLAN_BLOCK_NODES (96) nodes,
//     else one cluster of up to kPlanCluster blocks, ~96 nodes a block
//     (cluster.sync between levels). Measured on the card: a 320-node
//     level on one SM is issue-bound (~2,600 instructions a node hash
//     over 64 INT32 lanes: ~8 us a level); spread over 4 SMs it is bound
//     by one node hash's latency (~3.5 us a level, the floor) plus the
//     cluster barrier. Digests go to an (n_nodes, 32) output in global
//     memory: the host needs every one of them, and a parent reads its
//     children there (L2, __ldcg: written in this launch, so never
//     through the read-only path) - unless this thread wrote the child
//     last, then from registers (the SMT's one-key chains: node j above
//     node j). A node's refs and literal operands are read before the
//     barrier that precedes its level. The bound that binds is the
//     dependent chain: levels x one node hash's latency;
//   - K12: one thread per message, kFixedThreads (32) a block; the
//     message words built from aligned 32-bit loads of the row (the next
//     block's in flight during a block's rounds), the padding word-wise
//     (no per-byte branch), the unrolled compression;
//   - K10: one thread per proof; items are independent, so a proof's
//     time is its chain of min(depth, path_len) node hashes (levels past
//     path_len change nothing in the reference either), and the kernel
//     keeps everything else off that chain. Each level makes ONE
//     node_hash call on operands selected word by word (sibling left when
//     the index is odd or at the subtree's right edge): lanes of a warp
//     whose parities differ run the same instructions, where an if/else
//     around two calls would run both bodies. The verifier's shift loop
//     (while the index is even and not 0, halve index and size) is its
//     closed form, a shift by the index's trailing zeros (__ffs), so it
//     runs to completion as MerkleVerifier's while loop does (the
//     reference bounds it by its padded depth, >= 16 there) with no loop
//     on the chain; index and tree size stay int32 so parity, >> and the
//     comparisons agree. The next level's sibling row, and the table
//     index after it, are loaded while the current level hashes: no
//     memory latency on the chain but the first level's. Rows are read
//     as two 16-byte loads (the wrapper checks every operand's
//     alignment). The node hash's compressions are the rolled ones: with
//     the fully unrolled body (~2,900 SASS instructions, ~46 KB of code)
//     a card of warps streaming it took longer for 4,096 proofs than one
//     proof's chain, with the rolled body (~1,500) about as long
//     (utils/audit_fold_probe.py times both). The block size comes from
//     the wrapper (AUDIT_THREADS; at 4,096 proofs every size from 32 to
//     128 runs one warp a scheduler).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void init_state(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// One compression: st (8 words) updated in place; w (16 words) is used as
// the rolling schedule window and left clobbered.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + kK[t] + wt;
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// H(0x01 || l || r) on big-endian words: two compressions.
__device__ __forceinline__ void node_hash(const uint32_t l[8],
                                          const uint32_t r[8],
                                          uint32_t out[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[i] = (l[i - 1] << 24) | (l[i] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[8 + i] = (r[i - 1] << 24) | (r[i] >> 8);
  init_state(out);
  compress(out, w);
  w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 1; i < 15; ++i) w[i] = 0;
  w[15] = 520;  // 65 bytes * 8
  compress(out, w);
}

// K10's node hash: the same two blocks with the compression's 48
// scheduled rounds rolled, three loop iterations of 16 unrolled rounds
// (the window's indices stay static), and the two blocks as one unrolled
// loop. About half the code of node_hash, which a card full of warps
// streaming the same long body fetches slower than it runs
// (utils/audit_fold_probe.py times both). K11 keeps node_hash as it is
// written: routing it through these helpers changed K11's code and made
// its plans slower on the card. K12 keeps compress (one warp a scheduler
// runs it: the rolled rounds measured slower there).
__device__ __forceinline__ uint32_t schedule(uint32_t w[16], int j) {
  const uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  w[j] = w[j] + s0 + w[(j + 9) & 15] + s1;
  return w[j];
}

__device__ __forceinline__ void sha_round(uint32_t& a, uint32_t& b,
                                          uint32_t& c, uint32_t& d,
                                          uint32_t& e, uint32_t& f,
                                          uint32_t& g, uint32_t& h,
                                          uint32_t k, uint32_t wt) {
  const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = h + S1 + ch + k + wt;
  const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
  const uint32_t t2 = S0 + mj;
  h = g; g = f; f = e; e = d + t1;
  d = c; c = b; b = a; a = t1 + t2;
}

__device__ __forceinline__ void compress_rolled(uint32_t st[8],
                                                uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 16; ++t) sha_round(a, b, c, d, e, f, g, h, kK[t], w[t]);
#pragma unroll 1
  for (int base = 16; base < 64; base += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sha_round(a, b, c, d, e, f, g, h, kK[base + j], schedule(w, j));
    }
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ void node_hash_rolled(const uint32_t l[8],
                                                 const uint32_t r[8],
                                                 uint32_t out[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[i] = (l[i - 1] << 24) | (l[i] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[8 + i] = (r[i - 1] << 24) | (r[i] >> 8);
  init_state(out);
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    compress_rolled(out, w);
    if (blk == 0) {
      w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
      for (int i = 1; i < 15; ++i) w[i] = 0;
      w[15] = 520;  // 65 bytes * 8
    }
  }
}

__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t x[8]) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = bswap32(__ldg(q + i));
}

// A 32-byte row as two 16-byte loads (the row must be 16-byte aligned),
// kept raw until row_words turns it into big-endian words.
__device__ __forceinline__ void load_row16(const uint8_t* p, uint4& a,
                                           uint4& b) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  a = __ldg(q);
  b = __ldg(q + 1);
}

__device__ __forceinline__ void row_words(const uint4& a, const uint4& b,
                                          uint32_t x[8]) {
  x[0] = bswap32(a.x); x[1] = bswap32(a.y);
  x[2] = bswap32(a.z); x[3] = bswap32(a.w);
  x[4] = bswap32(b.x); x[5] = bswap32(b.y);
  x[6] = bswap32(b.z); x[7] = bswap32(b.w);
}

__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t x[8]) {
  uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = bswap32(x[i]);
}

// K12: msg (B, L) bytes -> out (B, 32), one thread a message (its
// compressions are one dependent chain, and at the sizes it serves one
// warp a scheduler runs it: one thread's chain sets the time). Each thread
// reads its row as the aligned 32-bit words that hold it (the row's first
// byte rounded down to 4, whatever L is and wherever the rows start) and
// builds each big-endian message word from two of them with __byte_perm
// at the row's byte offset; a word is loaded only where it holds one of
// the row's bytes (an aligned word never leaves the page of a byte it
// holds). A block's 16 words are 16 to 32 independent loads: one memory
// latency, and block b + 1's are loaded before block b's rounds run, so
// only the first block waits on memory.
//
// FIPS 180-4 padding is word-wise and every test of msg_len is uniform
// across the launch (every row has the same length): the word holding
// byte msg_len keeps its message bytes under a mask and takes 0x80 after
// them, later words are 0 and never loaded, and the last block's words 14
// and 15 are the 64-bit bit length. The rounds are the unrolled compress
// (one warp a scheduler fetches the long body without missing, and the
// unrolled rounds keep the constants as immediates).
// csrc/probe/sha256_fixed_variants.cu builds the other forms it was
// measured against (rolled rounds, no block in flight, the rows staged in
// shared memory, the byte loads it replaced) from the helpers below.

// A message word x (its bytes in big-endian order) padded: q = msg_len -
// (the word's first byte), uniform across the launch.
__device__ __forceinline__ uint32_t fixed_pad(uint32_t x, int q) {
  if (q < 4) {
    if (q <= 0) x = 0u;
    else x &= 0xFFFFFFFFu << (32 - 8 * q);
    if (q >= 0) x |= 0x80000000u >> (8 * q);
  }
  return x;
}

// Block b's raw words: lo[i] while word i holds message bytes (q > 0),
// hi[i] where the row's offset s splits the word and the message reaches
// past lo[i]; 0 otherwise.
__device__ __forceinline__ void fixed_load(const uint32_t* __restrict__ g,
                                           int s, int msg_len, int b,
                                           uint32_t lo[16], uint32_t hi[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = msg_len - 64 * b - 4 * i;
    lo[i] = q > 0 ? __ldg(g + 16 * b + i) : 0u;
    hi[i] = s != 0 && q > 4 - s ? __ldg(g + 16 * b + i + 1) : 0u;
  }
}

// Block b's 16 padded words from its raw words.
__device__ __forceinline__ void fixed_join(const uint32_t lo[16],
                                           const uint32_t hi[16],
                                           uint32_t sel, int msg_len,
                                           int n_blocks, uint64_t bitlen,
                                           int b, uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w[i] = fixed_pad(__byte_perm(lo[i], hi[i], sel),
                     msg_len - 64 * b - 4 * i);
  }
  if (b == n_blocks - 1) {
    w[14] = static_cast<uint32_t>(bitlen >> 32);
    w[15] = static_cast<uint32_t>(bitlen);
  }
}

// Row ``item``'s aligned words, its byte offset s in them and the
// __byte_perm selector that takes a word's 4 bytes from s on.
__device__ __forceinline__ const uint32_t* fixed_row(const uint8_t* msg,
                                                     int item, int msg_len,
                                                     int& s, uint32_t& sel) {
  const uintptr_t own =
      reinterpret_cast<uintptr_t>(msg) + static_cast<size_t>(item) * msg_len;
  s = static_cast<int>(own & 3);
  sel = ((s + 3) | ((s + 2) << 4) | ((s + 1) << 8) | (s << 12)) & 0xFFFFu;
  return reinterpret_cast<const uint32_t*>(own & ~uintptr_t(3));
}

// K12's block size (utils/sha256_fixed_probe.py: 32 and 64 threads within
// 1%, 128 2-4% slower)
constexpr int kFixedThreads = 32;

__global__ void __launch_bounds__(kFixedThreads)
    sha256_fixed_kernel(const uint8_t* __restrict__ msg,
                        uint8_t* __restrict__ out, int batch,
                        int msg_len) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  int s;
  uint32_t sel;
  const uint32_t* g = fixed_row(msg, item, msg_len, s, sel);
  const int n_blocks = (msg_len + 9 + 63) / 64;
  const uint64_t bitlen = static_cast<uint64_t>(msg_len) * 8;
  uint32_t st[8];
  init_state(st);
  uint32_t lo[16], hi[16];
  fixed_load(g, s, msg_len, 0, lo, hi);
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t w[16];
    fixed_join(lo, hi, sel, msg_len, n_blocks, bitlen, b, w);
    if (b + 1 < n_blocks) fixed_load(g, s, msg_len, b + 1, lo, hi);
    compress(st, w);
  }
  store_words(out + static_cast<size_t>(item) * 32, st);
}

// K11: a commit plan. The level offsets ride in the kernel's parameters.
constexpr int kMaxPlanLevels = 256;  // the SMT's depth
constexpr int kPlanThreads = 256;    // most threads a block
constexpr int kPlanCluster = 8;      // blocks of the wide plans' cluster

struct PlanLevels {
  int n_levels;
  int off[kMaxPlanLevels + 1];  // level l is nodes [off[l], off[l + 1])
};

// Before the barrier: node i's operand references and its literal
// operands (read-only, so they may be read while the level below is
// still being hashed).
__device__ __forceinline__ void plan_prefetch(int i,
                                              const int32_t* __restrict__ refs,
                                              const uint8_t* __restrict__ lits,
                                              int2& r, uint32_t a[8],
                                              uint32_t b[8]) {
  r = __ldg(reinterpret_cast<const int2*>(refs) + i);
  if (r.x < 0) load_words(lits + static_cast<size_t>(-1 - r.x) * 32, a);
  if (r.y < 0) load_words(lits + static_cast<size_t>(-1 - r.y) * 32, b);
}

// After the barrier: a node operand, from the registers when this thread
// wrote it last, else from the output (written in this launch: read
// through L2, never the read-only path).
__device__ __forceinline__ void plan_resolve(int ref, const uint8_t* out,
                                             int last, const uint32_t h[8],
                                             uint32_t x[8]) {
  if (ref < 0) return;  // a literal, prefetched
  if (ref == last) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = h[k];
    return;
  }
  const uint32_t* q =
      reinterpret_cast<const uint32_t*>(out + static_cast<size_t>(ref) * 32);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = bswap32(__ldcg(q + k));
}

// One launch: gridDim.x == 1 (one block, no cluster) or 2 .. kPlanCluster
// blocks launched as one cluster. Node j of a level is thread
// j / gridDim.x of block j % gridDim.x, so even a narrow level spreads
// over every block of the cluster; a thread keeps the digest it wrote
// last in registers, so a chain whose parent lands on the same thread
// (the SMT's one-key paths: node j above node j) skips the L2 read.
__global__ void __launch_bounds__(kPlanThreads)
    merkle_plan_kernel(const int32_t* __restrict__ refs,
                       const uint8_t* __restrict__ lits, uint8_t* out,
                       const PlanLevels lv) {
  const bool clustered = gridDim.x > 1;
  const int stride = blockDim.x * gridDim.x;
  const int t = threadIdx.x * gridDim.x + blockIdx.x;
  int last = -1;
  uint32_t h[8];
  int2 r;
  uint32_t a[8], b[8];
  int i = t;
  if (i < lv.off[1]) plan_prefetch(i, refs, lits, r, a, b);
  for (int l = 0; l < lv.n_levels; ++l) {
    const int hi = lv.off[l + 1];
    while (i < hi) {
      plan_resolve(r.x, out, last, h, a);
      plan_resolve(r.y, out, last, h, b);
      node_hash(a, b, h);
      last = i;
      store_words(out + static_cast<size_t>(i) * 32, h);
      i += stride;
      if (i < hi) plan_prefetch(i, refs, lits, r, a, b);
    }
    if (l + 1 < lv.n_levels) {
      i = hi + t;
      if (i < lv.off[l + 2]) plan_prefetch(i, refs, lits, r, a, b);
      if (clustered) {
        cg::this_cluster().sync();
      } else {
        __syncthreads();
      }
    }
  }
}

// K10: one thread per proof, one node hash a level. Siblings come from
// path[b, level] (dense) or table[path_idx[b, level]] (``Indexed``). The
// library launches node_hash_rolled; node_hash (``Rolled`` false) is built
// by csrc/probe/audit_fold_variants.cu only.
template <bool Rolled, bool Indexed>
__global__ void audit_fold_kernel(const uint8_t* __restrict__ leaf,
                                  const int32_t* __restrict__ index,
                                  const uint8_t* __restrict__ path,
                                  const uint8_t* __restrict__ table,
                                  const int32_t* __restrict__ path_idx,
                                  const int32_t* __restrict__ path_len,
                                  const int32_t* __restrict__ tree_size,
                                  const uint8_t* __restrict__ root,
                                  uint8_t* __restrict__ ok_out, int batch,
                                  int depth) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  const int32_t plen = path_len[item];
  const int levels = plen < depth ? plen : depth;
  const int consumed = levels > 0 ? levels : 0;
  const size_t row0 = static_cast<size_t>(item) * depth;
  // level l's sibling row; ``idx`` is its table index when indexed
  auto sibling = [&](int l, int32_t idx) {
    return Indexed ? table + static_cast<size_t>(idx) * 32
                   : path + (row0 + l) * 32;
  };
  uint4 sa = make_uint4(0, 0, 0, 0), sb = sa;  // this level's sibling, raw
  int32_t idx_next = 0;  // the next level's table index
  if (consumed > 0) {
    load_row16(sibling(0, Indexed ? __ldg(path_idx + row0) : 0), sa, sb);
    if (Indexed && consumed > 1) idx_next = __ldg(path_idx + row0 + 1);
  }
  uint32_t r[8];
  {
    uint4 la, lb;
    load_row16(leaf + static_cast<size_t>(item) * 32, la, lb);
    row_words(la, lb, r);
  }
  int32_t fn = index[item];
  int32_t fsn = tree_size[item] - 1;
  bool ok = true;
  for (int level = 0; level < consumed; ++level) {
    uint32_t s[8];
    row_words(sa, sb, s);
    // the next level's sibling, and the index after it, in flight while
    // this level hashes
    if (level + 1 < consumed) {
      load_row16(sibling(level + 1, idx_next), sa, sb);
      if (Indexed && level + 2 < consumed) {
        idx_next = __ldg(path_idx + row0 + level + 2);
      }
    }
    // int32 parity as the reference's floor-mod: (fn & 1) == fn % 2
    const bool use_left = (fn & 1) || (fn == fsn);
    ok = ok && (fsn > 0);  // a level consumed with fsn exhausted
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lo[i] = use_left ? s[i] : r[i];
      hi[i] = use_left ? r[i] : s[i];
    }
    if (Rolled) {
      node_hash_rolled(lo, hi, r);
    } else {
      node_hash(lo, hi, r);
    }
    // the verifier's ``while fn even and fn != 0: halve fn and fsn`` after
    // a left sibling, in closed form, then the level's own halving
    const int tz = use_left && fn != 0 ? __ffs(fn) - 1 : 0;
    fn = (fn >> tz) >> 1;
    fsn = (fsn >> tz) >> 1;
  }
  ok = ok && (fsn == 0) && (consumed == plen);
  uint4 ra, rb;
  load_row16(root + static_cast<size_t>(item) * 32, ra, rb);
  uint32_t want[8];
  row_words(ra, rb, want);
#pragma unroll
  for (int i = 0; i < 8; ++i) ok = ok && (r[i] == want[i]);
  ok_out[item] = ok ? 1 : 0;
}

inline int grid_for(int batch, int threads) {
  return (batch + threads - 1) / threads;
}

// K10's block size: whole warps, at most 1,024 threads
inline bool fold_threads_ok(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

}  // namespace

extern "C" int sha256_fixed_launch(const void* msg, void* out, int batch,
                                   int msg_len, void* stream) {
  if (msg_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0) {
    sha256_fixed_kernel<<<grid_for(batch, kFixedThreads), kFixedThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(msg), static_cast<uint8_t*>(out), batch,
        msg_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// offsets: n_levels + 1 host ints, nondecreasing from 0; blocks: 1 (one
// block) to kPlanCluster (one cluster; the wrapper picks it from the
// widest level). Each block gets the threads the widest level needs.
extern "C" int merkle_plan_launch(const void* refs, const void* lits,
                                  void* out, const int* offsets,
                                  int n_levels, int blocks, void* stream) {
  if (n_levels < 0 || n_levels > kMaxPlanLevels || blocks < 1 ||
      blocks > kPlanCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_levels == 0) return static_cast<int>(cudaGetLastError());
  PlanLevels lv;
  lv.n_levels = n_levels;
  int widest = 0;
  for (int l = 0; l <= n_levels; ++l) {
    lv.off[l] = offsets[l];
    if (l > 0) {
      const int width = offsets[l] - offsets[l - 1];
      if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
      widest = width > widest ? width : widest;
    }
  }
  if (offsets[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (widest + blocks - 1) / blocks;
  int threads = ((per_block + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kPlanThreads) threads = kPlanThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, merkle_plan_kernel, static_cast<const int32_t*>(refs),
      static_cast<const uint8_t*>(lits), static_cast<uint8_t*>(out), lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int audit_paths_launch(const void* leaf, const void* index,
                                  const void* path, const void* path_len,
                                  const void* tree_size, const void* root,
                                  void* ok, int batch, int depth,
                                  int threads, void* stream) {
  if (!fold_threads_ok(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    audit_fold_kernel<true, false><<<grid_for(batch, threads), threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(leaf), static_cast<const int32_t*>(index),
        static_cast<const uint8_t*>(path), nullptr, nullptr,
        static_cast<const int32_t*>(path_len),
        static_cast<const int32_t*>(tree_size),
        static_cast<const uint8_t*>(root), static_cast<uint8_t*>(ok), batch,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int audit_paths_indexed_launch(
    const void* leaf, const void* index, const void* table,
    const void* path_idx, const void* path_len, const void* tree_size,
    const void* root, void* ok, int batch, int depth, int threads,
    void* stream) {
  if (!fold_threads_ok(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    audit_fold_kernel<true, true><<<grid_for(batch, threads), threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(leaf), static_cast<const int32_t*>(index),
        nullptr, static_cast<const uint8_t*>(table),
        static_cast<const int32_t*>(path_idx),
        static_cast<const int32_t*>(path_len),
        static_cast<const int32_t*>(tree_size),
        static_cast<const uint8_t*>(root), static_cast<uint8_t*>(ok), batch,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}
