// SHA-512 over host-padded blocks, and h mod L, for the Ed25519 ingress.
//
// Replaces (JAX reference, indy_plenum_tpu/tpu/sha512.py):
//   K-a  sha512_blocks  (sha512.py:201) - multi-block SHA-512 with a
//        per-item active-block count, 64-bit words held as (hi, lo)
//        uint32 pairs there;
//   K-b  reduce_mod_l   (sha512.py:249) - h mod L by a 260-step
//        conditional-subtract ladder over 16-bit limbs there.
//
// What bounds them on an H100: integer issue. SHA-512 does ~80 rounds of
// 64-bit adds/rotates/logic per 128-byte block (each 64-bit op is two or
// more 32-bit instructions), against 128 bytes read - far above the
// card's bytes-per-operation balance, so the 64 INT32 lanes per SM are the
// limit, not HBM. The ladder likewise does 260 x 8 64-bit subtracts per
// item for 96 bytes moved.
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
//   - mod L: one thread per item; the ladder runs on 8 x 64-bit limbs
//     against a host-computed table of L << i (uniform index across the
//     warp: one broadcast load per step).
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

// lshift: 260 rows of 8 limbs, row r = L << (259 - r) (descending)
__global__ void reduce_mod_l_kernel(const uint64_t* __restrict__ h_le,
                                    uint64_t* __restrict__ out,
                                    const uint64_t* __restrict__ lshift,
                                    int batch) {
  int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  uint64_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = h_le[static_cast<size_t>(item) * 8 + j];
  for (int r = 0; r < 260; ++r) {
    const uint64_t* t = lshift + r * 8;
    uint64_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t tj = __ldg(t + j);
      uint64_t hj = h[j];
      d[j] = hj - tj - borrow;
      borrow = (hj < tj) | ((hj == tj) & borrow);
    }
    if (!borrow) {
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = d[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[static_cast<size_t>(item) * 4 + j] = h[j];
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
                                   const void* lshift, int batch,
                                   void* stream) {
  if (batch > 0) {
    const int threads = 128;
    const int grid = (batch + threads - 1) / threads;
    reduce_mod_l_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(h_le), static_cast<uint64_t*>(out),
        static_cast<const uint64_t*>(lshift), batch);
  }
  return static_cast<int>(cudaGetLastError());
}
