// GF(2^255 - 19) in five 51-bit limbs of uint64, for one CUDA thread.
//
// Replaces the field layer of the JAX reference
// (indy_plenum_tpu/tpu/field25519.py: carry :96-124, mul :149, sqr,
// freeze :197, invert/pow_p58 :188-195, decode_bytes/encode_bytes :277,
// :292), which holds an element as 22 limbs of 12 bits in int32 lanes
// because the TPU's vector unit has no 64-bit multiply. Hopper multiplies
// 64 x 64 -> 128 bits in a few instructions, so the radix here is 2^51:
// a product is 25 wide multiplies instead of 484 narrow ones, a
// square 15.
//
// What bounds it on an H100: integer multiply issue (each 64 x 64 -> 128
// product is several 32-bit IMAD instructions); an element is 40 bytes in
// registers and never touches memory. The design answer is the radix
// above, and carries folded into the column sums so mul does one pass.
//
// Bounds: every operation returns limbs below 2^51 + 2^13 ("carried");
// add/sub carry their result too, so mul always sees limbs < 2^52 and its
// five-term column sums stay below 2^116 in unsigned __int128. Only
// fe_contract produces the canonical representative; equality, parity
// and encoding go through it, as freeze() does in the JAX module.
#pragma once
#include <cstdint>

namespace fe25519 {

typedef unsigned __int128 u128;
static constexpr uint64_t M51 = (1ULL << 51) - 1;

struct fe {
  uint64_t v[5];
};

__device__ __forceinline__ void carry(fe& h) {
  h.v[1] += h.v[0] >> 51; h.v[0] &= M51;
  h.v[2] += h.v[1] >> 51; h.v[1] &= M51;
  h.v[3] += h.v[2] >> 51; h.v[2] &= M51;
  h.v[4] += h.v[3] >> 51; h.v[3] &= M51;
  h.v[0] += 19 * (h.v[4] >> 51); h.v[4] &= M51;
}

__device__ __forceinline__ fe from_u64(uint64_t x) {
  fe r;
  r.v[0] = x & M51; r.v[1] = x >> 51; r.v[2] = 0; r.v[3] = 0; r.v[4] = 0;
  return r;
}

__device__ __forceinline__ fe add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + b.v[i];
  carry(r);
  return r;
}

// a - b as a + 4p - b: every limb of 4p exceeds any carried limb of b
__device__ __forceinline__ fe sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + 0x1FFFFFFFFFFFB4ULL - b.v[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) r.v[i] = a.v[i] + 0x1FFFFFFFFFFFFCULL - b.v[i];
  carry(r);
  return r;
}

__device__ __forceinline__ fe neg(const fe& a) {
  fe z;
#pragma unroll
  for (int i = 0; i < 5; ++i) z.v[i] = 0;
  return sub(z, a);
}

__device__ __forceinline__ fe mul(const fe& f, const fe& g) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3],
                 g4 = g.v[4];
  const uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3,
                 g4_19 = 19 * g4;
  u128 r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
            (u128)f3 * g2_19 + (u128)f4 * g1_19;
  u128 r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
            (u128)f3 * g3_19 + (u128)f4 * g2_19;
  u128 r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
            (u128)f3 * g4_19 + (u128)f4 * g3_19;
  u128 r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
            (u128)f3 * g0 + (u128)f4 * g4_19;
  u128 r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
            (u128)f3 * g1 + (u128)f4 * g0;
  r1 += (uint64_t)(r0 >> 51);
  r2 += (uint64_t)(r1 >> 51);
  r3 += (uint64_t)(r2 >> 51);
  r4 += (uint64_t)(r3 >> 51);
  fe h;
  h.v[0] = (uint64_t)r0 & M51;
  h.v[1] = (uint64_t)r1 & M51;
  h.v[2] = (uint64_t)r2 & M51;
  h.v[3] = (uint64_t)r3 & M51;
  uint64_t top = (uint64_t)(r4 >> 51);
  h.v[4] = (uint64_t)r4 & M51;
  h.v[0] += 19 * top;
  h.v[1] += h.v[0] >> 51;
  h.v[0] &= M51;
  return h;
}

// f * f in 15 wide products: the cross terms f_i * f_j (i != j) are taken
// once against a doubled factor. Each column sum is the same integer as
// mul(f, f)'s, so the carried limbs are bit-identical to it.
__device__ __forceinline__ fe sqr(const fe& f) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t f0_2 = 2 * f0, f1_2 = 2 * f1, f2_2 = 2 * f2, f3_2 = 2 * f3;
  const uint64_t f3_19 = 19 * f3, f4_19 = 19 * f4;
  u128 r0 = (u128)f0 * f0 + (u128)f1_2 * f4_19 + (u128)f2_2 * f3_19;
  u128 r1 = (u128)f0_2 * f1 + (u128)f2_2 * f4_19 + (u128)f3 * f3_19;
  u128 r2 = (u128)f0_2 * f2 + (u128)f1 * f1 + (u128)f3_2 * f4_19;
  u128 r3 = (u128)f0_2 * f3 + (u128)f1_2 * f2 + (u128)f4 * f4_19;
  u128 r4 = (u128)f0_2 * f4 + (u128)f1_2 * f3 + (u128)f2 * f2;
  r1 += (uint64_t)(r0 >> 51);
  r2 += (uint64_t)(r1 >> 51);
  r3 += (uint64_t)(r2 >> 51);
  r4 += (uint64_t)(r3 >> 51);
  fe h;
  h.v[0] = (uint64_t)r0 & M51;
  h.v[1] = (uint64_t)r1 & M51;
  h.v[2] = (uint64_t)r2 & M51;
  h.v[3] = (uint64_t)r3 & M51;
  uint64_t top = (uint64_t)(r4 >> 51);
  h.v[4] = (uint64_t)r4 & M51;
  h.v[0] += 19 * top;
  h.v[1] += h.v[0] >> 51;
  h.v[0] &= M51;
  return h;
}

__device__ __forceinline__ fe sqr_n(fe f, int n) {
  for (int i = 0; i < n; ++i) f = sqr(f);
  return f;
}

// z^(2^250 - 1), and z^11 on the side (ref10's shared addition chain)
__device__ __forceinline__ fe pow_2_250_1(const fe& z, fe& z11) {
  fe z2 = sqr(z);
  fe z9 = mul(sqr_n(z2, 2), z);      // z^8 * z
  z11 = mul(z9, z2);                 // z^11
  fe t = mul(sqr(z11), z9);          // z^(2^5 - 1)
  fe t10 = mul(sqr_n(t, 5), t);      // 2^10 - 1
  fe t20 = mul(sqr_n(t10, 10), t10); // 2^20 - 1
  fe t40 = mul(sqr_n(t20, 20), t20); // 2^40 - 1
  fe t50 = mul(sqr_n(t40, 10), t10); // 2^50 - 1
  fe t100 = mul(sqr_n(t50, 50), t50);     // 2^100 - 1
  fe t200 = mul(sqr_n(t100, 100), t100);  // 2^200 - 1
  return mul(sqr_n(t200, 50), t50);       // 2^250 - 1
}

// z^(p - 2) = z^(2^255 - 21)
__device__ __forceinline__ fe invert(const fe& z) {
  fe z11;
  fe t = pow_2_250_1(z, z11);
  return mul(sqr_n(t, 5), z11);
}

// z^((p - 5) / 8) = z^(2^252 - 3)
__device__ __forceinline__ fe pow_p58(const fe& z) {
  fe z11;
  fe t = pow_2_250_1(z, z11);
  return mul(sqr_n(t, 2), z);
}

__device__ __forceinline__ uint64_t load64_le(const uint8_t* s) {
  uint64_t r = 0;
#pragma unroll
  for (int i = 7; i >= 0; --i) r = (r << 8) | s[i];
  return r;
}

// 32 little-endian bytes -> element, bit 255 ignored (the caller reads
// it as the sign)
__device__ __forceinline__ fe from_bytes(const uint8_t* s) {
  fe h;
  h.v[0] = load64_le(s) & M51;
  h.v[1] = (load64_le(s + 6) >> 3) & M51;
  h.v[2] = (load64_le(s + 12) >> 6) & M51;
  h.v[3] = (load64_le(s + 19) >> 1) & M51;
  h.v[4] = (load64_le(s + 24) >> 12) & M51;
  return h;
}

// canonical 32-byte little-endian encoding (value reduced below p)
__device__ __forceinline__ void contract(uint8_t out[32], const fe& in) {
  fe t = in;
  carry(t);
  carry(t);
  // now 0 <= t < 2^255 with carried limbs; bring [p, 2^255) below p:
  // add 19, carry (wraps 2^255 to 19 via the fold), then add 2^255 - 19
  // and drop the top carry
  t.v[0] += 19;
  carry(t);
  t.v[0] += (1ULL << 51) - 19;
  t.v[1] += (1ULL << 51) - 1;
  t.v[2] += (1ULL << 51) - 1;
  t.v[3] += (1ULL << 51) - 1;
  t.v[4] += (1ULL << 51) - 1;
  t.v[1] += t.v[0] >> 51; t.v[0] &= M51;
  t.v[2] += t.v[1] >> 51; t.v[1] &= M51;
  t.v[3] += t.v[2] >> 51; t.v[2] &= M51;
  t.v[4] += t.v[3] >> 51; t.v[3] &= M51;
  t.v[4] &= M51;
  uint64_t w[4];
  w[0] = t.v[0] | (t.v[1] << 51);
  w[1] = (t.v[1] >> 13) | (t.v[2] << 38);
  w[2] = (t.v[2] >> 26) | (t.v[3] << 25);
  w[3] = (t.v[3] >> 39) | (t.v[4] << 12);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 8; ++b) out[8 * i + b] = (uint8_t)(w[i] >> (8 * b));
  }
}

__device__ __forceinline__ bool eq(const fe& a, const fe& b) {
  uint8_t x[32], y[32];
  contract(x, a);
  contract(y, b);
  uint8_t d = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) d |= x[i] ^ y[i];
  return d == 0;
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  uint8_t x[32];
  contract(x, a);
  uint8_t d = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) d |= x[i];
  return d == 0;
}

__device__ __forceinline__ int parity(const fe& a) {
  uint8_t x[32];
  contract(x, a);
  return x[0] & 1;
}

}  // namespace fe25519
