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
// limit, not HBM. The Barrett reduction does 35 64x64->128 products per
// item for 96 bytes moved; at the drain's 8,192 items its one dependent
// chain a thread, not the card's issue rate, sets the time.
//
// Design:
//   - one thread per message; native uint64 words (no hi/lo pairs); the
//     16-word schedule lives in registers as a rolling window;
//   - a thread loops over its item's ACTIVE blocks only (n_blocks[i]), so
//     padding rows past the count are never read;
//   - the 80 round constants and the IV come from the caller (derived on
//     the host from the first primes, as the JAX module derives them) and
//     are staged into shared memory once per block: every thread of a
//     warp reads the same constant at the same time, a broadcast;
//   - loads are 8-byte words byte-swapped from big-endian; rows are
//     128-byte aligned because torch allocations are;
//   - mod L: one thread per item, Barrett (Handbook of Applied
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

namespace {

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  uint32_t lo = static_cast<uint32_t>(x);
  uint32_t hi = static_cast<uint32_t>(x >> 32);
  uint32_t nlo = __byte_perm(hi, 0, 0x0123);
  uint32_t nhi = __byte_perm(lo, 0, 0x0123);
  return (static_cast<uint64_t>(nhi) << 32) | nlo;
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// consts: K[0..79], H0[80..87]
__global__ void sha512_blocks_kernel(const uint64_t* __restrict__ blocks,
                                     const int32_t* __restrict__ n_blocks,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ consts,
                                     int batch, int nb) {
  __shared__ uint64_t k[88];
  for (int i = threadIdx.x; i < 88; i += blockDim.x) k[i] = consts[i];
  __syncthreads();
  int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;

  uint64_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = k[80 + i];
  int active = n_blocks[item];
  if (active > nb) active = nb;
  const uint64_t* row = blocks + static_cast<size_t>(item) * nb * 16;
  for (int blk = 0; blk < active; ++blk) {
    uint64_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = bswap64(row[blk * 16 + i]);
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
    // fully unrolled: the window indices below become constants and w[]
    // stays in registers
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      uint64_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
        uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
        w[t & 15] = wt;
      }
      uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + k[t] + wt;
      uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
      uint64_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  uint64_t* dst = out + static_cast<size_t>(item) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = bswap64(h[i]);
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
                                    void* out, const void* consts, int batch,
                                    int nb, void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int grid = (batch + threads - 1) / threads;
    sha512_blocks_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(blocks),
        static_cast<const int32_t*>(n_blocks), static_cast<uint64_t*>(out),
        static_cast<const uint64_t*>(consts), batch, nb);
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
