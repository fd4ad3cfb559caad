// K-a's forms, for utils/sha512_probe.py: the kernel of ../sha512.cu
// (rounds 16..79 rolled, 16-byte loads with the next block in flight)
// beside the forms it was measured against: every round unrolled (each
// constant an immediate), 8-byte loads when a block starts, and the form
// it replaced (the round constants and the IV staged from an operand into
// shared memory behind a barrier, 8-byte loads). Built on its own by the
// probe, never into the port's library, which holds the first form only.
#include "../sha512.cu"

namespace {

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return pack(__byte_perm(static_cast<uint32_t>(x), 0, 0x0123),
              __byte_perm(static_cast<uint32_t>(x >> 32), 0, 0x0123));
}

// rounds 16..79
template <class Seq>
struct Shift16;
template <int... I>
struct Shift16<std::integer_sequence<int, I...>> {
  using type = std::integer_sequence<int, (I + 16)...>;
};
using ScheduledRounds = Shift16<std::make_integer_sequence<int, 64>>::type;

// the 80 rounds, every one a template instance with its constant an
// immediate (kRolled false), or the library's sha512_compress
template <bool kRolled>
__device__ __forceinline__ void compress_form(uint64_t (&st)[8],
                                              uint64_t (&w)[16]) {
  if constexpr (kRolled) {
    sha512_compress(st, w);
  } else {
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
    sha512_rounds(a, b, c, d, e, f, g, h, w,
                  std::make_integer_sequence<int, 16>{});
    sha512_rounds(a, b, c, d, e, f, g, h, w, ScheduledRounds{});
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
    st[4] += e;
    st[5] += f;
    st[6] += g;
    st[7] += h;
  }
}

// the library's kernel in another round form (kRolled) and load form
// (kPipelined: 16-byte loads, the next block's in flight; else one 8-byte
// load a word when its block starts)
template <bool kRolled, bool kPipelined>
__global__ void __launch_bounds__(kSha512MaxThreads)
    sha512_form_kernel(const uint64_t* __restrict__ blocks,
                       const int32_t* __restrict__ n_blocks,
                       uint4* __restrict__ out, int batch, int nb) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  uint64_t st[8];
  sha512_init(st, std::make_integer_sequence<int, 8>{});
  int active = n_blocks[item];
  if (active > nb) active = nb;
  const uint64_t* row = blocks + static_cast<size_t>(item) * nb * 16;
  if constexpr (kPipelined) {
    const uint4* vrow = reinterpret_cast<const uint4*>(row);
    uint4 cur[8];
    if (active > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = vrow[i];
    }
    for (int blk = 0; blk < active; ++blk) {
      uint4 next[8];
      if (blk + 1 < active) {
#pragma unroll
        for (int i = 0; i < 8; ++i) next[i] = vrow[(blk + 1) * 8 + i];
      }
      uint64_t w[16];
      unpack_block(cur, w);
      compress_form<kRolled>(st, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) cur[i] = next[i];
    }
  } else {
    for (int blk = 0; blk < active; ++blk) {
      uint64_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = bswap64(row[blk * 16 + i]);
      compress_form<kRolled>(st, w);
    }
  }
  store_digest(st, out + static_cast<size_t>(item) * 4);
}

// the replaced form; consts: K[0..79], H0[80..87]
__global__ void sha512_staged_kernel(const uint64_t* __restrict__ blocks,
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
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      uint64_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
        uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^
                      (w15 >> 7);
        uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^
                      (w2 >> 6);
        wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
        w[t & 15] = wt;
      }
      uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^
                    rotr64(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + k[t] + wt;
      uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^
                    rotr64(a, 39);
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

}  // namespace

// form: 0 the replaced kernel (``consts`` its table), 1 unrolled and
// 8-byte loads, 2 rolled and 8-byte loads, 3 unrolled and the next block
// in flight, 4 the library's kernel (rolled, the next block in flight);
// forms 1-4 take the constants from the code. threads: 32 .. 256, a
// multiple of 32
extern "C" int sha512_variant_launch(const void* blocks, const void* n_blocks,
                                     void* out, const void* consts,
                                     int batch, int nb, int threads,
                                     int form, void* stream) {
  if (threads < 32 || threads > kSha512MaxThreads || threads % 32 != 0 ||
      form < 0 || form > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  const dim3 grid((batch + threads - 1) / threads);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint64_t*>(blocks);
  const auto* n = static_cast<const int32_t*>(n_blocks);
  auto* o = static_cast<uint4*>(out);
  switch (form) {
    case 0:
      sha512_staged_kernel<<<grid, threads, 0, st>>>(
          b, n, static_cast<uint64_t*>(out),
          static_cast<const uint64_t*>(consts), batch, nb);
      break;
    case 1:
      sha512_form_kernel<false, false><<<grid, threads, 0, st>>>(
          b, n, o, batch, nb);
      break;
    case 2:
      sha512_form_kernel<true, false><<<grid, threads, 0, st>>>(
          b, n, o, batch, nb);
      break;
    case 3:
      sha512_form_kernel<false, true><<<grid, threads, 0, st>>>(
          b, n, o, batch, nb);
      break;
    default:
      sha512_blocks_kernel<<<grid, threads, 0, st>>>(
          static_cast<const uint4*>(blocks), n, o, batch, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
