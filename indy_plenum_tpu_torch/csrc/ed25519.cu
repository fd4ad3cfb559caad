// Batched Ed25519 verification: a group of L neighbouring lanes of a warp
// per signature (L = 2 on the main path, or L = 4, a quad).
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
// bytes-per-operation balance. But one signature is a serial chain of
// ~3,700 dependent field operations, and with one thread a signature an
// ingress drain of 8,192 leaves 2 warps on an SM: nothing hides the
// chain's latency.
//
// Design: the point arithmetic of one signature is spread over L lanes,
// after the four-processor schedule of Hisil, Wong, Carter and Dawson,
// "Twisted Edwards Curves Revisited" (ASIACRYPT 2008):
//   - coordinate c of the accumulator (X, Y, Z, T) and of a cached point
//     (Y + X, Y - X, 2d * T, 2Z) lives on lane c % L of the group, in its
//     slot c / L, as carried radix-2^51 limbs;
//   - a doubling is two stages: one square a coordinate (X^2, Y^2, Z^2,
//     (X + Y)^2), then one product a coordinate (E*F, G*H, F*G, E*H); a
//     cached addition is two stages of one product a coordinate ((Y + X)
//     * ypx, (Y - X) * ymx, T * t2d, Z * z2, then the same four outputs);
//   - between stages the lanes exchange carried elements with
//     __shfl_sync of width L, two 32-bit shuffles a limb;
//   - the serial parts (decompression with its pow_p58, the final
//     inversion and encoding) run on every lane of the group: on SIMT
//     that costs the warp the same instructions as one lane with the rest
//     idle.
// So the ladder keeps the reference's sequence of field operations (64
// windows of 4 doublings and 2 cached additions), spread over lanes, and a
// signature's chain falls from ~3,700 dependent field operations to
// ~1,300 stages at L = 4 (of one field operation a lane) or at L = 2 (of
// two), with L times the warps in flight.
//   - The main path launches L = 2 with the table in local memory: of the
//     four variants the fastest at 8,192 signatures and at 32,768 on an
//     H100 (utils/verify_lanes_probe.py builds all four from
//     csrc/probe/ed25519_variants.cu and times them). At L = 4 the
//     serial parts' redundant instructions cost what the shorter chain
//     saves; at
//     32,768 the shared table caps an SM at ~11 warps, while the local
//     one lets the 128-register cap fit 32,768 x 2 lanes in one wave.
//   - Every lane stays to the end, since a shuffle over lanes that have
//     left is undefined: a group past the batch works on the batch's last
//     row and writes nothing, and an A that fails to decompress runs the
//     ladder on whatever x came out, its verdict masked.
//   - A lane reads only the table coordinates it wrote itself, so the
//     table of j * (-A) needs no barrier: in local memory (640 bytes a
//     coordinate) or in shared memory (16 signatures a block, 2,592 bytes
//     each, rows padded by 32 bytes), by the template's choice.
//   - The base table j * B (2.5 KB) is loaded into shared memory once a
//     block; a lane reads only its coordinate of an entry.
#include <cstdint>
#include <cuda_runtime.h>

#include "fe25519.cuh"
#include "quorum_common.cuh"

namespace {

using fe25519::fe;

// the main path's launch: 2 lanes a signature, the table in local memory
constexpr int kMainLanes = 2;
constexpr bool kMainSharedTable = false;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSigsPerBlock = 16;
constexpr int kRegisterCap = 128;  // registers a thread, via launch bounds

// consts layout (uint64): base table 16 x 4 x 5 (cached j*B, j = 0..15,
// coordinates Y + X, Y - X, 2d * T, 2Z), then d, 2d, sqrt(-1) (5 limbs
// each)
constexpr int kD = 16 * 4 * 5;
constexpr int kD2 = kD + 5;
constexpr int kSqrtM1 = kD2 + 5;
// a table in shared memory: [j][limb][coordinate]
constexpr int kTableWords = 16 * 5 * 4;
constexpr int kSigStride = kTableWords + 4;

__device__ __forceinline__ fe load_fe(const uint64_t* p) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) r.v[i] = __ldg(p + i);
  return r;
}

__device__ __forceinline__ fe pick(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// element ``a`` of lane ``src`` of this lane's group of L
template <int L>
__device__ __forceinline__ fe shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t lo =
        __shfl_sync(kFull, static_cast<uint32_t>(a.v[i]), src, L);
    const uint32_t hi =
        __shfl_sync(kFull, static_cast<uint32_t>(a.v[i] >> 32), src, L);
    r.v[i] = (static_cast<uint64_t>(hi) << 32) | lo;
  }
  return r;
}

// coordinate C of a point spread over the group, on every lane
template <int L, int C>
__device__ __forceinline__ fe coord(const fe (&own)[4 / L]) {
  return shfl<L>(own[C / L], C % L);
}

// the second stage of a doubling or a cached addition: r holds the four
// first-stage results (A, B, C, D) as every lane sees them; coordinate c
// of the result is E*F, G*H, F*G or E*H
__device__ __forceinline__ fe second_stage(int c, const fe& E, const fe& F,
                                           const fe& G, const fe& H) {
  const fe u = pick(c == 0 || c == 3, E, pick(c == 1, G, F));
  const fe v = pick(c == 0, F, pick(c == 2, G, H));
  return fe25519::mul(u, v);
}

// dbl-2008-hwcd (a = -1) over the group
template <int L>
__device__ __forceinline__ void point_double(fe (&own)[4 / L], int lane) {
  constexpr int K = 4 / L;
  const fe X = coord<L, 0>(own);
  const fe Y = coord<L, 1>(own);
  const fe xy = fe25519::add(X, Y);
  fe r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + L * k;
    r[k] = fe25519::sqr(pick(c == 3, xy, own[k]));
  }
  const fe A = coord<L, 0>(r);
  const fe B = coord<L, 1>(r);
  const fe zz = coord<L, 2>(r);
  const fe S3 = coord<L, 3>(r);
  const fe C = fe25519::add(zz, zz);
  const fe Dd = fe25519::neg(A);
  const fe E = fe25519::sub(fe25519::sub(S3, A), B);
  const fe G = fe25519::add(Dd, B);
  const fe F = fe25519::sub(G, C);
  const fe H = fe25519::sub(Dd, B);
#pragma unroll
  for (int k = 0; k < K; ++k) own[k] = second_stage(lane + L * k, E, F, G, H);
}

// extended + cached (add-2008-hwcd-3, a = -1) over the group; q holds
// this lane's coordinates of the cached point
template <int L>
__device__ __forceinline__ void point_add_cached(fe (&own)[4 / L],
                                                 const fe (&q)[4 / L],
                                                 int lane) {
  constexpr int K = 4 / L;
  fe r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // coordinate c ^ 1 of the point: Y beside X, T beside Z
    const fe partner = shfl<L>(own[k], lane ^ 1);
    const int c = lane + L * k;
    const fe op = pick(c == 0, fe25519::add(partner, own[k]),
                       pick(c == 1, fe25519::sub(own[k], partner), partner));
    r[k] = fe25519::mul(op, q[k]);  // B, A, C, D by coordinate
  }
  const fe B = coord<L, 0>(r);
  const fe A = coord<L, 1>(r);
  const fe C = coord<L, 2>(r);
  const fe Dd = coord<L, 3>(r);
  const fe E = fe25519::sub(B, A);
  const fe F = fe25519::sub(Dd, C);
  const fe G = fe25519::add(Dd, C);
  const fe H = fe25519::add(B, A);
#pragma unroll
  for (int k = 0; k < K; ++k) own[k] = second_stage(lane + L * k, E, F, G, H);
}

// this lane's coordinates of the cached form of the point
template <int L>
__device__ __forceinline__ void to_cached(fe (&out)[4 / L],
                                          const fe (&own)[4 / L],
                                          const fe& d2, int lane) {
#pragma unroll
  for (int k = 0; k < 4 / L; ++k) {
    const fe partner = shfl<L>(own[k], lane ^ 1);
    const int c = lane + L * k;
    // Y + X on X's lane, Y - X on Y's, 2d * T on Z's, 2Z on T's
    const fe t2d = fe25519::mul(partner, d2);
    out[k] = pick(c == 0, fe25519::add(partner, own[k]),
                  pick(c == 1, fe25519::sub(own[k], partner),
                       pick(c == 2, t2d,
                            fe25519::add(partner, partner))));
  }
}

// The verdict of signature ``item`` on this lane's group: the body of
// K-c, which K14 (fused_step_kernel) runs too. Every thread of the block
// calls it (it holds a barrier); ``smem`` is the block's dynamic shared
// memory (the base table, then the signature tables when kSharedTable).
template <int L, bool kSharedTable>
__device__ __forceinline__ bool verify_item(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ rb,
    const uint8_t* __restrict__ sb, const uint8_t* __restrict__ hb,
    const uint64_t* __restrict__ consts, uint64_t* smem, int item) {
  constexpr int K = 4 / L;
  const int lane = threadIdx.x % L;
  const int sig = threadIdx.x / L;

  for (int t = threadIdx.x; t < kTableWords; t += blockDim.x) {
    const int j = t / 20, c = (t % 20) / 5, i = t % 5;
    smem[(j * 5 + i) * 4 + c] = __ldg(consts + t);
  }
  __syncthreads();  // no lane has left: groups past the batch stay

  // --- decompress A (RFC 8032 5.1.3), on every lane of the group ---
  const uint8_t* a_bytes = pk + static_cast<size_t>(item) * 32;
  uint8_t a_enc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a_enc[i] = a_bytes[i];
  const int sign = a_enc[31] >> 7;
  a_enc[31] &= 0x7F;
  const fe d = load_fe(consts + kD);
  const fe d2 = load_fe(consts + kD2);
  const fe one = fe25519::from_u64(1);
  const fe zero = fe25519::from_u64(0);
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
  const bool ok_direct = fe25519::eq(vx2, u);
  const bool ok_flipped = fe25519::eq(vx2, fe25519::neg(u));
  if (ok_flipped) x = fe25519::mul(x, load_fe(consts + kSqrtM1));
  bool ok = canonical && (ok_direct || ok_flipped);
  if (fe25519::is_zero(x) && sign == 1) ok = false;
  if (fe25519::parity(x) != sign) x = fe25519::neg(x);

  // this lane's coordinates of -A = (-x, y, 1, -x*y)
  const fe nx = fe25519::neg(x);
  const fe nxy = fe25519::neg(fe25519::mul(x, y));
  fe pt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + L * k;
    pt[k] = pick(c == 0, nx, pick(c == 1, y, pick(c == 2, one, nxy)));
  }

  // --- table of cached j * (-A), j = 0..15: this lane's coordinates ---
  uint64_t local_table[kSharedTable ? 1 : 16 * K * 5];
  uint64_t* shared_table = smem + kTableWords + sig * kSigStride;
  auto put = [&](int j, const fe (&e)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if constexpr (kSharedTable) {
          shared_table[(j * 5 + i) * 4 + lane + L * k] = e[k].v[i];
        } else {
          local_table[(j * K + k) * 5 + i] = e[k].v[i];
        }
      }
    }
  };
  auto get = [&](int j, fe (&e)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if constexpr (kSharedTable) {
          e[k].v[i] = shared_table[(j * 5 + i) * 4 + lane + L * k];
        } else {
          e[k].v[i] = local_table[(j * K + k) * 5 + i];
        }
      }
    }
  };
  fe entry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {  // the identity, cached: (1, 1, 0, 2)
    const int c = lane + L * k;
    entry[k] = pick(c < 2, one, pick(c == 2, zero, fe25519::from_u64(2)));
  }
  put(0, entry);
  fe a1[K];
  to_cached<L>(a1, pt, d2, lane);
  put(1, a1);
  for (int j = 2; j < 16; ++j) {
    point_add_cached<L>(pt, a1, lane);
    to_cached<L>(entry, pt, d2, lane);
    put(j, entry);
  }

  // --- 64 msb-first 4-bit windows of S*B + h*(-A) ---
  const uint8_t* s_bytes = sb + static_cast<size_t>(item) * 32;
  const uint8_t* h_bytes = hb + static_cast<size_t>(item) * 32;
  fe acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {  // the identity: (0, 1, 1, 0)
    const int c = lane + L * k;
    acc[k] = pick(c == 1 || c == 2, one, zero);
  }
  for (int w = 63; w >= 0; --w) {
    point_double<L>(acc, lane);
    point_double<L>(acc, lane);
    point_double<L>(acc, lane);
    point_double<L>(acc, lane);
    const int shift = (w & 1) * 4;
    const int sn = (__ldg(s_bytes + (w >> 1)) >> shift) & 0xF;
    const int hn = (__ldg(h_bytes + (w >> 1)) >> shift) & 0xF;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        entry[k].v[i] = smem[(sn * 5 + i) * 4 + lane + L * k];
      }
    }
    point_add_cached<L>(acc, entry, lane);
    get(hn, entry);
    point_add_cached<L>(acc, entry, lane);
  }

  // --- compress and compare with R, on every lane of the group ---
  const fe ax0 = coord<L, 0>(acc);
  const fe ay0 = coord<L, 1>(acc);
  const fe zi = fe25519::invert(coord<L, 2>(acc));
  const fe ax = fe25519::mul(ax0, zi);
  const fe ay = fe25519::mul(ay0, zi);
  uint8_t enc[32];
  fe25519::contract(enc, ay);
  enc[31] |= static_cast<uint8_t>(fe25519::parity(ax) << 7);
  const uint8_t* r_bytes = rb + static_cast<size_t>(item) * 32;
  uint8_t diff = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) diff |= enc[i] ^ r_bytes[i];
  return ok && diff == 0;
}

template <int L, bool kSharedTable>
__global__ void __launch_bounds__(kSigsPerBlock * L,
                                  65536 / (kSigsPerBlock * L * kRegisterCap))
ed25519_verify_kernel(const uint8_t* __restrict__ pk,
                      const uint8_t* __restrict__ rb,
                      const uint8_t* __restrict__ sb,
                      const uint8_t* __restrict__ hb,
                      uint8_t* __restrict__ ok_out,
                      const uint64_t* __restrict__ consts, int batch) {
  extern __shared__ uint64_t smem[];  // base table, then signature tables
  int item = blockIdx.x * kSigsPerBlock + static_cast<int>(threadIdx.x) / L;
  const bool live = item < batch;
  if (!live) item = batch - 1;
  const bool ok =
      verify_item<L, kSharedTable>(pk, rb, sb, hb, consts, smem, item);
  if (live && threadIdx.x % L == 0) ok_out[item] = ok ? 1 : 0;
}

// K14's tail, in the block that draws the last ticket (one warp): member
// 0's column counts, checkpoint counts and decide with compact off. Every
// plane is read through L2 (other blocks of this launch wrote them), and
// each load is an L2 round trip on the warp's chain, so a thread issues a
// batch of loads before it uses any: the counts (qc::l2_chunk_counts),
// the checkpoint votes, and the PRE-PREPARE, ordered and acked rows,
// staged into shared memory for qc::decide_slots, whose ordered row is
// copied back after. Not inlined: its registers are allocated apart from
// the verify's, whose code stays K-c's. ``smem``: C int32 checkpoint
// counts, 2S uint16 column counts (N < 65,536 rows), then the three
// staged rows; the decide writes slot s's flags over the staged
// PRE-PREPARE byte it read first. So the scratch is 7S + 4C bytes, within
// the base table's 2,560 up to S = 364 (phase G's S = 300): the kernel
// asks the SM for K-c's shared memory, and K-c's verify keeps its L1.
constexpr int kTailBatch = 8;  // loads a thread issues at once

__device__ __noinline__ void fused_tail(qc::Planes p, int N, int S, int C,
                                        int n_validators, qc::Events e,
                                        uint64_t* smem) {
  int32_t* kc_s = reinterpret_cast<int32_t*>(smem);
  uint16_t* pc_s = reinterpret_cast<uint16_t*>(kc_s + C);
  uint16_t* cc_s = pc_s + S;
  uint8_t* pp_s = reinterpret_cast<uint8_t*>(cc_s + S);
  uint8_t* ord_s = pp_s + S;
  uint8_t* ack_s = ord_s + S;
  uint8_t* flags = pp_s;  // written by the decide, not read
  const int t = threadIdx.x;
  const int step = blockDim.x;
  for (int i0 = t; i0 < S; i0 += step * kTailBatch) {
    uint8_t a[kTailBatch], b[kTailBatch], c[kTailBatch];
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u) {
      const int i = i0 + u * step;
      a[u] = i < S ? __ldcg(p.pp + i) : 0;
      b[u] = i < S ? __ldcg(p.ordered + i) : 0;
      c[u] = i < S ? __ldcg(p.acked + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u) {
      const int i = i0 + u * step;
      if (i < S) {
        pp_s[i] = a[u];
        ord_s[i] = b[u];
        ack_s[i] = c[u];
        pc_s[i] = 0;
        cc_s[i] = 0;
      }
    }
  }
  for (int c = t; c < C; c += step) kc_s[c] = 0;
  __syncthreads();
  qc::l2_chunk_counts(p, 0, N, S, 0, N, 0, S, pc_s, cc_s);
  const int nc = N * C;  // member 0's checkpoint votes, row-major
  for (int i0 = t; i0 < nc; i0 += step * kTailBatch) {
    uint8_t v[kTailBatch];
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u) {
      const int i = i0 + u * step;
      v[u] = i < nc ? __ldcg(p.ck + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kTailBatch; ++u) {
      if (v[u]) atomicAdd(kc_s + (i0 + u * step) % C, v[u]);
    }
  }
  __syncthreads();
  qc::Planes staged = p;
  staged.pp = pp_s;
  staged.ordered = ord_s;
  staged.acked = ack_s;
  qc::decide_slots(
      staged, e, 0, S, 0, S, n_validators, 0,
      [&](int s, int* pc, int* cc) {
        *pc = pc_s[s];
        *cc = cc_s[s];
      },
      flags, flags, flags);
  qc::decide_checkpoints(e, 0, C, n_validators,
                         [&](int c) { return kc_s[c]; });
  __syncthreads();
  for (int i = t; i < S; i += step) p.ordered[i] = ord_s[i];
}

// What K14 does after its verdicts: lane 0 of each live group writes its
// verdict and scatters its word when the signature holds; the ticket;
// the last block's tail, which resets the ticket. Not inlined, and its
// operands by value (a reference to a kernel parameter makes a local
// copy): the kernel's own frame is the verify's alone. The verify keeps
// its table of -A multiples and its spills in local memory, so its time
// follows that frame: with this part inlined (or the tail called with the
// state by reference) the frame grew past K-c's and K14 ran ~18 us over
// K-c alone at phase G, as the parent's second launch did; with it apart
// the frame is smaller than K-c's and K14 runs about K-c's time
// (PERF.md §6, K14).
__device__ __noinline__ void fused_finish(bool ok, bool live, int item,
                                          uint8_t* ok_out, qc::Planes p,
                                          const uint32_t* words, int N,
                                          int S, int C, int n_validators,
                                          qc::Events e, unsigned int* ticket,
                                          uint64_t* smem) {
  __shared__ bool last;
  if (live && threadIdx.x % kMainLanes == 0) {
    ok_out[item] = ok ? 1 : 0;
    if (ok) {
      qc::scatter_word(qc::member_planes(p, 0, N, S, C), __ldg(words + item),
                       S, C, 0, N, 0, S, true, true);
    }
  }
  // the block's stores before its ticket: the barrier orders them before
  // thread 0's release; the last block's acquire orders every block's
  // before its tail (one acq_rel atomic a block, no fence a lane)
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int drawn;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(drawn)
                 : "l"(ticket)
                 : "memory");
    last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  fused_tail(p, N, S, C, n_validators, e, smem);
  if (threadIdx.x == 0) *ticket = 0u;
}

// K14: K-c's verify (the main path's form) and the quorum step of ONE
// member in one launch. After its verdict, lane 0 of each live group
// writes ok_out[item] and, when the signature holds, stores word item's 1
// into the member's planes (qc::scatter_word over every row and slot:
// PRE-PREPAREs whatever the sender, checkpoints bounded by C); a group
// past the batch stores nothing. Then each block takes a ticket (an
// acq_rel atomic after a barrier); the block that draws the last sees every
// block's stores and evaluates the member (fused_tail: the column
// counts over the N rows, the slots' decide and the checkpoints' with
// compact off, as the reference's q.step sets neither prepared_acked nor
// the frontier, tpu/step.py:19-20). Its scratch takes the dynamic shared
// memory the base table held: the verify is done with it. It resets the
// ticket as it ends: ``ticket`` belongs to the wrapper's stream, whose
// calls run one after another, so the next call finds it 0 and two calls
// never share one.
// fused_step_launch sizes the dynamic shared memory for the base table
// alone
static_assert(!kMainSharedTable,
              "K14's verify keeps its signature tables out of shared memory");

__global__ void __launch_bounds__(
    kSigsPerBlock * kMainLanes,
    65536 / (kSigsPerBlock * kMainLanes * kRegisterCap))
    fused_step_kernel(const uint8_t* __restrict__ pk,
                      const uint8_t* __restrict__ rb,
                      const uint8_t* __restrict__ sb,
                      const uint8_t* __restrict__ hb,
                      uint8_t* __restrict__ ok_out,
                      const uint64_t* __restrict__ consts, int batch,
                      qc::Planes p, const uint32_t* __restrict__ words,
                      int N, int S, int C, int n_validators, qc::Events e,
                      unsigned int* ticket) {
  extern __shared__ uint64_t smem[];
  int item = blockIdx.x * kSigsPerBlock +
             static_cast<int>(threadIdx.x) / kMainLanes;
  const bool live = item < batch;
  if (!live) item = batch - 1;
  bool ok = false;
  if (batch > 0) {  // uniform: an empty batch only evaluates
    ok = verify_item<kMainLanes, kMainSharedTable>(pk, rb, sb, hb, consts,
                                                  smem, item);
  }
  fused_finish(ok, live, item, ok_out, p, words, N, S, C, n_validators, e,
               ticket, smem);
}

template <int L, bool kSharedTable>
void launch(const void* pk, const void* rb, const void* sb, const void* hb,
            void* ok_out, const void* consts, int batch,
            cudaStream_t stream) {
  const int grid = (batch + kSigsPerBlock - 1) / kSigsPerBlock;
  const size_t smem =
      (kTableWords + (kSharedTable ? kSigsPerBlock * kSigStride : 0)) *
      sizeof(uint64_t);
  ed25519_verify_kernel<L, kSharedTable>
      <<<grid, kSigsPerBlock * L, smem, stream>>>(
          static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(rb),
          static_cast<const uint8_t*>(sb), static_cast<const uint8_t*>(hb),
          static_cast<uint8_t*>(ok_out),
          static_cast<const uint64_t*>(consts), batch);
}

}  // namespace

// K14: the verify's operands, then ONE member's state (as
// quorum_step_launch's, M = 1), its (1, B) words, N, S, C, the real
// validator count, the one output allocation (qc::events_at at M = 1;
// the compact record is not written) and the stream's ticket (one
// uint32, 0 between calls).
extern "C" int fused_step_launch(const void* pk, const void* rb,
                                 const void* sb, const void* hb,
                                 void* ok_out, const void* consts, int batch,
                                 void* pp, void* pv, void* cv, void* ck,
                                 void* ordered, void* acked, void* frontier,
                                 const void* words, int N, int S, int C,
                                 int n_validators, int cap, void* out,
                                 void* ticket, void* stream) {
  if (batch < 0 || N < 1 || N > 65535 || S <= 0 || S > qc::kMaxSlots ||
      C < 0 || C > qc::kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t table = kTableWords * sizeof(uint64_t);
  // the tail's C int32 and 2S uint16 counts, and 3S bytes
  const size_t tail = 7 * static_cast<size_t>(S) + 4 * static_cast<size_t>(C);
  const size_t smem = table > tail ? table : tail;
  if (smem > 48 * 1024) {  // above 48 KB: the kernel's opt-in
    const cudaError_t opt = cudaFuncSetAttribute(
        fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (opt != cudaSuccess) return static_cast<int>(opt);
  }
  const int grid = batch > 0 ? (batch + kSigsPerBlock - 1) / kSigsPerBlock
                             : 1;
  fused_step_kernel<<<grid, kSigsPerBlock * kMainLanes, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(rb),
      static_cast<const uint8_t*>(sb), static_cast<const uint8_t*>(hb),
      static_cast<uint8_t*>(ok_out), static_cast<const uint64_t*>(consts),
      batch, qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
      static_cast<const uint32_t*>(words), N, S, C, n_validators,
      qc::events_at(out, 1, S, C, cap), static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ed25519_verify_launch(const void* pk, const void* rb,
                                     const void* sb, const void* hb,
                                     void* ok_out, const void* consts,
                                     int batch, void* stream) {
  if (batch > 0) {
    launch<kMainLanes, kMainSharedTable>(pk, rb, sb, hb, ok_out, consts,
                                         batch,
                                         static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
