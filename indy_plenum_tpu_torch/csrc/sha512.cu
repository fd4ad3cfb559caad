// SHA-512 over host-padded blocks, and h mod L, for the Ed25519 ingress.
//
// Replaces (JAX reference, indy_plenum_tpu/tpu/sha512.py):
//   K-a  sha512_blocks  (sha512.py:201) - multi-block SHA-512 with a
//        per-item active-block count, 64-bit words held as (hi, lo)
//        uint32 pairs there;
//   K-b  reduce_mod_l   (sha512.py:249) - h mod L by a 260-step
//        conditional-subtract ladder over 16-bit limbs there; a Barrett
//        reduction here.
//
// What bounds them on an H100: integer issue. SHA-512 does ~80 rounds of
// 64-bit adds/rotates/logic per 128-byte block (each 64-bit op is two or
// more 32-bit instructions), against 128 bytes read - far above the
// card's bytes-per-operation balance, so the 64 INT32 lanes per SM are the
// limit, not HBM. At the drain's 8,192 messages that is 256 warps, at most
// one on each of the card's 528 schedulers: one thread's dependent chain
// and its warp's issue rate set the time, not the card's. The Barrett
// reduction does 35 64x64->128 products per item for 96 bytes moved; at
// the drain's 8,192 items its one dependent chain a thread, not the
// card's issue rate, sets the time.
//
// Design of K-a (one thread a message: a message's 160 rounds are one
// dependent chain whatever runs them, so the design shortens the chain and
// the instructions a thread issues):
//   - native uint64 words; the 16-word schedule lives in registers as a
//     rolling window; a thread loops over its item's ACTIVE blocks only
//     (n_blocks[i]), so padding rows past the count are never read;
//   - the 80 round constants and the IV are a constexpr table here (the
//     host derives the same values from the first primes, for the plain
//     version and the tests): no operand, no staging, no barrier. The
//     rounds are template instances, so rounds 0..15 fold their constants
//     into their adds as immediates; rounds 16..79 are four turns of one
//     16-round body, their constants from a __constant__ copy of the
//     table. Fully unrolled, the 80 rounds are ~3,700 instructions (59 KB
//     of SASS), and warps that share an SM at different rounds miss in
//     the instruction cache: rolled, the drain takes 18% less time on an
//     H100 at 700 W (PERF.md);
//   - a 64-bit rotate is written shift-or: ptxas makes it two funnel
//     shifts (SHF) on the 32-bit halves, as the SASS shows (PERF.md);
//     ch and maj are one 3-input logic op (LOP3) a half;
//   - a block's 128 bytes are 8 16-byte loads, and block b + 1's are in
//     flight while block b's rounds run, so only a message's first block
//     exposes the load latency. Rows are 16-byte aligned (the wrapper
//     raises otherwise);
//   - 64 threads a block (kSha512Threads): the fastest of the sweep at
//     the drain's 8,192 messages and at 32,768 on an H100 at 700 W (32
//     within 1%, 256 60% slower at the drain; PERF.md).
//   csrc/probe/sha512_variants.cu holds the forms this one was measured
//   against (every round unrolled, 8-byte loads, and the replaced kernel
//   that staged its constants in shared memory), for
//   utils/sha512_probe.py; the library builds this form only.
//
// K-b: one thread per item, Barrett (Handbook of Applied
//     Cryptography, 14.42) with b = 2^64, k = 4 and mu = floor(2^512 / L)
//     (5 limbs) from the host beside L (4 limbs): q1 = h >> 192, q3 =
//     (q1 mu) >> 320 (all 25 products, no column skipped: h - q3 L < 3L),
//     r = (h - q3 L) mod 2^256 (10 products: 3L < 2^256, so the low 256
//     bits are r itself), then two conditional subtractions of L, each a
//     select (Barrett's general bound; for this L only the first can fire,
//     tests/test_torch_mod_l_barrett.py shows why). Products are
//     schoolbook by columns into a 3-word accumulator (lo from a * b, hi
//     from __umul64hi). 64 threads a block, so the drain's 8,192 items
//     are 128 blocks, about one a SM.
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

// FIPS 180-4 4.2.3 and 5.3.5: K[0..79], then H0[0..7] at 80..87
constexpr uint64_t kSha512Table[88] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
    // the initial state, H0[0..7] at 80..87
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

__host__ __device__ constexpr uint64_t sha512_const(int i) {
  return kSha512Table[i];
}

// entry I of the table as a scalar constant (device code reads no array of
// the host's)
template <int I>
constexpr uint64_t kSha512Word = sha512_const(I);

// K-a's threads a block, and the most its kernel is built for (the
// probe's sweep launches it at 32 to 256)
constexpr int kSha512Threads = 64;
constexpr int kSha512MaxThreads = 256;

__device__ __forceinline__ uint64_t pack(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// round T of the compression (T >= 16: the schedule word computed in
// place); k its round constant
template <int T>
__device__ __forceinline__ void sha512_round(uint64_t& a, uint64_t& b,
                                             uint64_t& c, uint64_t& d,
                                             uint64_t& e, uint64_t& f,
                                             uint64_t& g, uint64_t& h,
                                             uint64_t (&w)[16], uint64_t k) {
  if constexpr (T >= 16) {
    const uint64_t w15 = w[(T + 1) & 15], w2 = w[(T + 14) & 15];
    const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
    const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
    w[T & 15] += s0 + w[(T + 9) & 15] + s1;
  }
  const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
  const uint64_t ch = (e & f) ^ (~e & g);
  const uint64_t t1 = h + S1 + ch + k + w[T & 15];
  const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
  const uint64_t mj = (a & b) | (c & (a | b));
  h = g;
  g = f;
  f = e;
  e = d + t1;
  d = c;
  c = b;
  b = a;
  a = t1 + S0 + mj;
}

// rounds T..., each constant an immediate
template <int... T>
__device__ __forceinline__ void sha512_rounds(
    uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t& e,
    uint64_t& f, uint64_t& g, uint64_t& h, uint64_t (&w)[16],
    std::integer_sequence<int, T...>) {
  (sha512_round<T>(a, b, c, d, e, f, g, h, w, kSha512Word<T>), ...);
}

// 16 scheduled rounds whose constants are kc[0..15] (loaded, not
// immediates)
template <int... J>
__device__ __forceinline__ void sha512_rounds_loaded(
    uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t& e,
    uint64_t& f, uint64_t& g, uint64_t& h, uint64_t (&w)[16],
    const uint64_t* kc, std::integer_sequence<int, J...>) {
  (sha512_round<16 + J>(a, b, c, d, e, f, g, h, w, kc[J]), ...);
}

// the round constants again as a __constant__ table, for rounds 16..79
struct Sha512Rounds {
  uint64_t k[80];
};

__host__ __device__ constexpr Sha512Rounds sha512_rounds_table() {
  Sha512Rounds r{};
  for (int i = 0; i < 80; ++i) r.k[i] = kSha512Table[i];
  return r;
}

__constant__ Sha512Rounds kSha512Rounds = sha512_rounds_table();

// the 80 rounds of one block over the state st: rounds 0..15 each a
// template instance, its constant an immediate; rounds 16..79 four turns
// of one 16-round body, constants from the __constant__ table (fully
// unrolled, the 80 rounds are ~3,700 instructions, 59 KB of SASS)
__device__ __forceinline__ void sha512_compress(uint64_t (&st)[8],
                                                uint64_t (&w)[16]) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
  constexpr auto first = std::make_integer_sequence<int, 16>{};
  sha512_rounds(a, b, c, d, e, f, g, h, w, first);
#pragma unroll 1
  for (int turn = 1; turn < 5; ++turn) {
    sha512_rounds_loaded(a, b, c, d, e, f, g, h, w,
                         kSha512Rounds.k + 16 * turn, first);
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

template <int... I>
__device__ __forceinline__ void sha512_init(
    uint64_t (&st)[8], std::integer_sequence<int, I...>) {
  ((st[I] = kSha512Word<80 + I>), ...);
}

// block b's 16 big-endian words from its 8 16-byte vectors
__device__ __forceinline__ void unpack_block(const uint4 (&v)[8],
                                             uint64_t (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[2 * i] = pack(__byte_perm(v[i].x, 0, 0x0123),
                    __byte_perm(v[i].y, 0, 0x0123));
    w[2 * i + 1] = pack(__byte_perm(v[i].z, 0, 0x0123),
                        __byte_perm(v[i].w, 0, 0x0123));
  }
}

// the digest's 8 words, big-endian, as 4 16-byte vectors
__device__ __forceinline__ void store_digest(const uint64_t (&st)[8],
                                             uint4* dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t x = st[2 * i], y = st[2 * i + 1];
    dst[i] = make_uint4(__byte_perm(static_cast<uint32_t>(x >> 32), 0,
                                    0x0123),
                        __byte_perm(static_cast<uint32_t>(x), 0, 0x0123),
                        __byte_perm(static_cast<uint32_t>(y >> 32), 0,
                                    0x0123),
                        __byte_perm(static_cast<uint32_t>(y), 0, 0x0123));
  }
}

// K-a: one thread a message, 16-byte loads, the next block's in flight
// while this block's rounds run
__global__ void __launch_bounds__(kSha512MaxThreads)
    sha512_blocks_kernel(const uint4* __restrict__ blocks,
                         const int32_t* __restrict__ n_blocks,
                         uint4* __restrict__ out, int batch, int nb) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  uint64_t st[8];
  sha512_init(st, std::make_integer_sequence<int, 8>{});
  int active = n_blocks[item];
  if (active > nb) active = nb;
  const uint4* row = blocks + static_cast<size_t>(item) * nb * 8;
  uint4 cur[8];
  if (active > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = row[i];
  }
  for (int blk = 0; blk < active; ++blk) {
    uint4 next[8];
    if (blk + 1 < active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) next[i] = row[(blk + 1) * 8 + i];
    }
    uint64_t w[16];
    unpack_block(cur, w);
    sha512_compress(st, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = next[i];
  }
  store_digest(st, out + static_cast<size_t>(item) * 4);
}

// c2:c1:c0 += a * b (column accumulation; the high word of a product is
// at most 2^64 - 2, so hi + carry does not wrap)
__device__ __forceinline__ void mac(uint64_t a, uint64_t b, uint64_t& c0,
                                    uint64_t& c1, uint64_t& c2) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  c0 += lo;
  const uint64_t t = hi + (c0 < lo);
  c1 += t;
  c2 += c1 < t;
}

// r - y over 4 limbs into d; returns the borrow out (1 when r < y)
__device__ __forceinline__ uint64_t sub4(const uint64_t* r, const uint64_t* y,
                                         uint64_t* d) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = r[j] - y[j] - borrow;
    borrow = (r[j] < y[j]) | ((r[j] == y[j]) & borrow);
  }
  return borrow;
}

constexpr int kModLThreads = 64;

// consts: L in 4 little-endian limbs, then mu = floor(2^512 / L) in 5
__global__ void __launch_bounds__(kModLThreads)
    reduce_mod_l_kernel(const uint64_t* __restrict__ h_le,
                        uint64_t* __restrict__ out,
                        const uint64_t* __restrict__ consts, int batch) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  uint64_t h[8], L[4], mu[5];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = h_le[static_cast<size_t>(item) * 8 + j];
#pragma unroll
  for (int j = 0; j < 4; ++j) L[j] = __ldg(consts + j);
#pragma unroll
  for (int j = 0; j < 5; ++j) mu[j] = __ldg(consts + 4 + j);
  // q3 = (q1 mu) >> 320, q1 = h[3..7]: columns 0..8, limbs 5..9 kept
  uint64_t q3[5];
  uint64_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (k - i >= 0 && k - i < 5) mac(h[3 + i], mu[k - i], c0, c1, c2);
    }
    if (k >= 5) q3[k - 5] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  q3[4] = c0;
  // q3 L mod 2^256: columns 0..3 (q3[4] does not reach them)
  uint64_t ql[4];
  c0 = c1 = c2 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i <= k; ++i) mac(q3[i], L[k - i], c0, c1, c2);
    ql[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  uint64_t r[4], d[4];
  sub4(h, ql, r);  // mod 2^256: the borrow out is dropped
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const uint64_t keep = 0 - sub4(r, L, d);  // all ones when r < L
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = (r[j] & keep) | (d[j] & ~keep);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[static_cast<size_t>(item) * 4 + j] = r[j];
}

}  // namespace

extern "C" int sha512_blocks_launch(const void* blocks, const void* n_blocks,
                                    void* out, int batch, int nb,
                                    void* stream) {
  if (batch > 0) {
    sha512_blocks_kernel<<<(batch + kSha512Threads - 1) / kSha512Threads,
                           kSha512Threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(blocks),
        static_cast<const int32_t*>(n_blocks), static_cast<uint4*>(out),
        batch, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reduce_mod_l_launch(const void* h_le, void* out,
                                   const void* consts, int batch,
                                   void* stream) {
  if (batch > 0) {
    const int grid = (batch + kModLThreads - 1) / kModLThreads;
    reduce_mod_l_kernel<<<grid, kModLThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(h_le), static_cast<uint64_t*>(out),
        static_cast<const uint64_t*>(consts), batch);
  }
  return static_cast<int>(cudaGetLastError());
}
