// Batched Ed25519 verification: one CUDA thread per signature.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/ed25519.py:165-207
// `_verify_kernel` (K-c), with the field ops of tpu/field25519.py inlined
// (here: fe25519.cuh). verify_kernel_full (ed25519.py:210-226) is K-a ->
// K-b -> this kernel on one stream (see sha512.cu and
// indy_plenum_tpu_torch/tpu/ed25519.py).
//
// Structure kept from ref10 and the JAX kernel: RFC 8032 decompression of
// A (non-canonical y, x = 0 with sign 1 and non-squares rejected), a table
// of the cached multiples j * (-A), j = 0..15, then 64 msb-first 4-bit
// windows of 4 doublings + 2 cached additions computing S*B + h*(-A), and
// a compress-and-compare against R. Verdicts are a function of the group
// element only, so they equal the JAX kernel's bit for bit.
//
// What bounds it on an H100: integer multiply issue. A verification is
// about 2,200 field multiplies of 25 64x64->128-bit products and 1,530
// squares of 15 (several IMAD instructions apiece) plus carries, for 128
// bytes of input - orders of magnitude above the card's
// bytes-per-operation balance.
//
// Design against that bound and the register file:
//   - radix 2^51 in uint64 (fe25519.cuh): 25 wide products per multiply
//     (15 per square) instead of the reference's 484 narrow ones;
//   - the per-signature table of 16 cached points (16 x 4 x 5 uint64 =
//     2.5 KB) is indexed by a data-dependent nibble, so it lives in LOCAL
//     memory (per-thread, L1-cached), not registers; the base-point table
//     and the curve constants are one small global array every thread
//     reads (L1/L2-resident broadcast);
//   - no shared memory; 64 threads per block, so an 8192-entry ingress
//     drain spreads over 128 blocks (one per SM) instead of 64, and
//     occupancy is set by registers alone (~224 per thread).
#include <cstdint>
#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

using fe25519::fe;

struct ge {  // extended (X, Y, Z, T)
  fe X, Y, Z, T;
};
struct gc {  // cached (Y + X, Y - X, 2d * T, 2Z)
  fe ypx, ymx, t2d, z2;
};

__device__ __forceinline__ fe load_fe(const uint64_t* p) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) r.v[i] = __ldg(p + i);
  return r;
}

__device__ __forceinline__ ge point_double(const ge& p) {
  fe A = fe25519::sqr(p.X);
  fe B = fe25519::sqr(p.Y);
  fe zz = fe25519::sqr(p.Z);
  fe C = fe25519::add(zz, zz);
  fe Dd = fe25519::neg(A);
  fe E = fe25519::sub(fe25519::sub(fe25519::sqr(fe25519::add(p.X, p.Y)), A),
                      B);
  fe G = fe25519::add(Dd, B);
  fe F = fe25519::sub(G, C);
  fe H = fe25519::sub(Dd, B);
  ge r;
  r.X = fe25519::mul(E, F);
  r.Y = fe25519::mul(G, H);
  r.Z = fe25519::mul(F, G);
  r.T = fe25519::mul(E, H);
  return r;
}

// extended + cached (add-2008-hwcd-3, a = -1)
__device__ __forceinline__ ge point_add_cached(const ge& p, const gc& q) {
  fe A = fe25519::mul(fe25519::sub(p.Y, p.X), q.ymx);
  fe B = fe25519::mul(fe25519::add(p.Y, p.X), q.ypx);
  fe C = fe25519::mul(q.t2d, p.T);
  fe Dd = fe25519::mul(q.z2, p.Z);
  fe E = fe25519::sub(B, A);
  fe F = fe25519::sub(Dd, C);
  fe G = fe25519::add(Dd, C);
  fe H = fe25519::add(B, A);
  ge r;
  r.X = fe25519::mul(E, F);
  r.Y = fe25519::mul(G, H);
  r.Z = fe25519::mul(F, G);
  r.T = fe25519::mul(E, H);
  return r;
}

__device__ __forceinline__ gc to_cached(const ge& p, const fe& d2) {
  gc c;
  c.ypx = fe25519::add(p.Y, p.X);
  c.ymx = fe25519::sub(p.Y, p.X);
  c.t2d = fe25519::mul(p.T, d2);
  c.z2 = fe25519::add(p.Z, p.Z);
  return c;
}

// consts layout (uint64): base table 16 x 4 x 5 (cached j*B, j = 0..15),
// then d, 2d, sqrt(-1) (5 limbs each)
constexpr int kBase = 0;
constexpr int kD = 16 * 4 * 5;
constexpr int kD2 = kD + 5;
constexpr int kSqrtM1 = kD2 + 5;

__device__ __forceinline__ gc load_base(const uint64_t* consts, int j) {
  const uint64_t* p = consts + kBase + j * 20;
  gc c;
  c.ypx = load_fe(p);
  c.ymx = load_fe(p + 5);
  c.t2d = load_fe(p + 10);
  c.z2 = load_fe(p + 15);
  return c;
}

__global__ void ed25519_verify_kernel(const uint8_t* __restrict__ pk,
                                      const uint8_t* __restrict__ rb,
                                      const uint8_t* __restrict__ sb,
                                      const uint8_t* __restrict__ hb,
                                      uint8_t* __restrict__ ok_out,
                                      const uint64_t* __restrict__ consts,
                                      int batch) {
  int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  const uint8_t* a_bytes = pk + static_cast<size_t>(item) * 32;

  uint8_t a_enc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a_enc[i] = a_bytes[i];
  const int sign = a_enc[31] >> 7;
  a_enc[31] &= 0x7F;

  // --- decompress A (RFC 8032 5.1.3) ---
  const fe d = load_fe(consts + kD);
  const fe d2 = load_fe(consts + kD2);
  const fe one = fe25519::from_u64(1);
  fe y = fe25519::from_bytes(a_enc);
  uint8_t y_canon[32];
  fe25519::contract(y_canon, y);
  bool canonical = true;
#pragma unroll
  for (int i = 0; i < 32; ++i) canonical &= (y_canon[i] == a_enc[i]);
  fe yy = fe25519::sqr(y);
  fe u = fe25519::sub(yy, one);
  fe v = fe25519::add(fe25519::mul(yy, d), one);
  fe v3 = fe25519::mul(v, fe25519::sqr(v));
  fe v7 = fe25519::mul(fe25519::sqr(v3), v);
  fe t = fe25519::pow_p58(fe25519::mul(u, v7));
  fe x = fe25519::mul(fe25519::mul(u, v3), t);
  fe vx2 = fe25519::mul(v, fe25519::sqr(x));
  bool ok_direct = fe25519::eq(vx2, u);
  bool ok_flipped = fe25519::eq(vx2, fe25519::neg(u));
  if (ok_flipped) x = fe25519::mul(x, load_fe(consts + kSqrtM1));
  bool ok = canonical && (ok_direct || ok_flipped);
  if (fe25519::is_zero(x) && sign == 1) ok = false;
  if (!ok) {
    ok_out[item] = 0;
    return;
  }
  if (fe25519::parity(x) != sign) x = fe25519::neg(x);

  // -A = (-x, y, 1, -x*y)
  ge a_neg;
  a_neg.X = fe25519::neg(x);
  a_neg.Y = y;
  a_neg.Z = one;
  a_neg.T = fe25519::neg(fe25519::mul(x, y));

  // --- table of cached j * (-A), j = 0..15 (local memory) ---
  gc table[16];
  table[0].ypx = one;
  table[0].ymx = one;
  table[0].t2d = fe25519::from_u64(0);
  table[0].z2 = fe25519::from_u64(2);
  table[1] = to_cached(a_neg, d2);
  ge pt = a_neg;
  for (int j = 2; j < 16; ++j) {
    pt = point_add_cached(pt, table[1]);
    table[j] = to_cached(pt, d2);
  }

  // --- 64 msb-first 4-bit windows of S*B + h*(-A) ---
  const uint8_t* s_bytes = sb + static_cast<size_t>(item) * 32;
  const uint8_t* h_bytes = hb + static_cast<size_t>(item) * 32;
  ge acc;
  acc.X = fe25519::from_u64(0);
  acc.Y = one;
  acc.Z = one;
  acc.T = fe25519::from_u64(0);
  for (int w = 63; w >= 0; --w) {
    acc = point_double(acc);
    acc = point_double(acc);
    acc = point_double(acc);
    acc = point_double(acc);
    const int shift = (w & 1) * 4;
    const int sn = (s_bytes[w >> 1] >> shift) & 0xF;
    const int hn = (h_bytes[w >> 1] >> shift) & 0xF;
    acc = point_add_cached(acc, load_base(consts, sn));
    acc = point_add_cached(acc, table[hn]);
  }

  // --- compress and compare with R ---
  fe zi = fe25519::invert(acc.Z);
  fe ax = fe25519::mul(acc.X, zi);
  fe ay = fe25519::mul(acc.Y, zi);
  uint8_t enc[32];
  fe25519::contract(enc, ay);
  enc[31] |= static_cast<uint8_t>(fe25519::parity(ax) << 7);
  const uint8_t* r_bytes = rb + static_cast<size_t>(item) * 32;
  uint8_t diff = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) diff |= enc[i] ^ r_bytes[i];
  ok_out[item] = diff == 0 ? 1 : 0;
}

}  // namespace

extern "C" int ed25519_verify_launch(const void* pk, const void* rb,
                                     const void* sb, const void* hb,
                                     void* ok_out, const void* consts,
                                     int batch, void* stream) {
  if (batch > 0) {
    const int threads = 64;
    const int grid = (batch + threads - 1) / threads;
    ed25519_verify_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(rb),
        static_cast<const uint8_t*>(sb), static_cast<const uint8_t*>(hb),
        static_cast<uint8_t*>(ok_out), static_cast<const uint64_t*>(consts),
        batch);
  }
  return static_cast<int>(cudaGetLastError());
}
