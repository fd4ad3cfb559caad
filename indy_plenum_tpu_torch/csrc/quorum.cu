// The grouped quorum step: one thread block per member plane.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:284
// `step_compact` as the grouped compile_plan.py:186-199 step runs it
// (vmapped over members), with `unpack_words` (quorum.py:485),
// `_scatter_local`/`_quorum_events` (:145-207) and `compact_from_events`/
// `_delta_slots` (:248-281) fused into one launch.
//
// Per member m:
//   1. decode each uint32 word valid(1)|kind(2)|sender(13)|slot(16) and
//      store 1 into the hit plane; the reference's scatter is a max of
//      0/1 bytes, idempotent, so plain stores are right in any thread
//      order. PRE-PREPARE hits regardless of the sender (quorum.py:170);
//      checkpoints are bounded by C, not S (:153);
//   2. column counts over the N validator rows against n-f-1 (prepare)
//      and n-f (commit, checkpoint), f from the REAL validator count;
//      prepared / newly ordered / cumulative ordered; prepared_acked is
//      SET to prepared (:274), not or-ed;
//   3. ascending delta-slot lists capped at delta_cap and padded with S,
//      with the true counts (warp ballots + popcounts, one warp per
//      list), and the frontier max(old, leading run of ordered) (:272).
// State is updated in place (the reference donates it). QuorumEvents go
// to device memory; the host reads only the compact record, except on
// overflow or in host-eval mode.
//
// What bounds it on an H100: bytes, and at the main path's size launch
// latency. A 64 x 300-slot plane set is ~2.5 MB of uint8 votes read once
// for the counts; the arithmetic is a few adds per byte.
//
// Design: one block per member keeps the whole step of a member in one SM
// with no cross-block reduction; threads walk slots so the column reads
// of each validator row are coalesced (neighbouring threads, neighbouring
// slots); the compaction runs on three warps of the same block after a
// barrier, so the full events never leave the SM before the compact
// record is final.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 4096;  // shared flags per block (S <= this)

__global__ void quorum_step_kernel(
    uint8_t* __restrict__ pp, uint8_t* __restrict__ pv,
    uint8_t* __restrict__ cv, uint8_t* __restrict__ ck,
    uint8_t* __restrict__ ordered, uint8_t* __restrict__ acked,
    int32_t* __restrict__ frontier, const uint32_t* __restrict__ words,
    int N, int S, int C, int W, int n_validators, int cap, int compact,
    uint8_t* __restrict__ ev_prepared, uint8_t* __restrict__ ev_newly,
    uint8_t* __restrict__ ev_ordered, uint8_t* __restrict__ ev_stable,
    int32_t* __restrict__ ev_pc, int32_t* __restrict__ ev_cc,
    int32_t* __restrict__ new_prep, int32_t* __restrict__ n_prep,
    int32_t* __restrict__ new_comm, int32_t* __restrict__ n_comm,
    uint8_t* __restrict__ stable_u8) {
  __shared__ uint8_t f_newprep[kMaxSlots];
  __shared__ uint8_t f_newly[kMaxSlots];
  __shared__ uint8_t f_ordered[kMaxSlots];

  const int m = blockIdx.x;
  const size_t ms = static_cast<size_t>(m) * S;
  const size_t mns = static_cast<size_t>(m) * N * S;
  const size_t mnc = static_cast<size_t>(m) * N * C;
  uint8_t* ppm = pp + ms;
  uint8_t* pvm = pv + mns;
  uint8_t* cvm = cv + mns;
  uint8_t* ckm = ck + mnc;

  // 1. scatter
  const uint32_t* wm = words + static_cast<size_t>(m) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const uint32_t w = wm[j];
    if (!(w >> 31)) continue;
    const int kind = (w >> 29) & 0x3;
    const int sender = (w >> 16) & 0x1FFF;
    const int slot = w & 0xFFFF;
    if (kind == 0) {
      if (slot < S) ppm[slot] = 1;
    } else if (sender < N) {
      if (kind == 1) {
        if (slot < S) pvm[static_cast<size_t>(sender) * S + slot] = 1;
      } else if (kind == 2) {
        if (slot < S) cvm[static_cast<size_t>(sender) * S + slot] = 1;
      } else {
        if (slot < C) ckm[static_cast<size_t>(sender) * C + slot] = 1;
      }
    }
  }
  __syncthreads();

  // 2. counts and events
  const int f = (n_validators - 1) / 3;
  const int prepare_q = n_validators - f - 1;
  const int commit_q = n_validators - f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int pc = 0, cc = 0;
    for (int n = 0; n < N; ++n) {
      pc += pvm[static_cast<size_t>(n) * S + s];
      cc += cvm[static_cast<size_t>(n) * S + s];
    }
    const bool seen = ppm[s] != 0;
    const bool prepared = seen && pc >= prepare_q;
    const bool commit_ok = seen && cc >= commit_q && prepared;
    const bool was = ordered[ms + s] != 0;
    const bool newly = commit_ok && !was;
    const bool now = was || commit_ok;
    const bool new_p = prepared && acked[ms + s] == 0;
    ordered[ms + s] = now ? 1 : 0;
    if (compact) acked[ms + s] = prepared ? 1 : 0;
    ev_prepared[ms + s] = prepared;
    ev_newly[ms + s] = newly;
    ev_ordered[ms + s] = now;
    ev_pc[ms + s] = pc;
    ev_cc[ms + s] = cc;
    f_newprep[s] = new_p;
    f_newly[s] = newly;
    f_ordered[s] = now;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int kc = 0;
    for (int n = 0; n < N; ++n) kc += ckm[static_cast<size_t>(n) * C + c];
    const bool st = kc >= commit_q;
    ev_stable[static_cast<size_t>(m) * C + c] = st;
    stable_u8[static_cast<size_t>(m) * C + c] = st;
  }
  __syncthreads();

  // 3. compaction (warp 0: new prepared, warp 1: new committed) and the
  // frontier (warp 2)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  if (warp < 2) {
    const uint8_t* flags = warp == 0 ? f_newprep : f_newly;
    int32_t* out = (warp == 0 ? new_prep : new_comm) +
                   static_cast<size_t>(m) * cap;
    int count = 0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const bool hit = s < S && flags[s];
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
      const int pos = count + __popc(ballot & lt_mask);
      if (hit && pos < cap) out[pos] = s;
      count += __popc(ballot);
    }
    for (int pos = count + lane; pos < cap; pos += 32) out[pos] = S;
    if (lane == 0) (warp == 0 ? n_prep : n_comm)[m] = count;
  } else if (warp == 2) {
    int lead = S;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const bool gap = s < S && !f_ordered[s];
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, gap);
      if (ballot) {
        lead = base + __ffs(ballot) - 1;
        break;
      }
    }
    if (lane == 0 && compact) {
      const int old = frontier[m];
      frontier[m] = old > lead ? old : lead;
    }
  }
}

}  // namespace

extern "C" int quorum_step_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* words, int M, int N, int S, int C, int W,
    int n_validators, int cap, int compact, void* ev_prepared,
    void* ev_newly, void* ev_ordered, void* ev_stable, void* ev_pc,
    void* ev_cc, void* new_prep, void* n_prep, void* new_comm,
    void* n_comm, void* stable_u8, void* stream) {
  if (S > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    quorum_step_kernel<<<M, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(pp), static_cast<uint8_t*>(pv),
        static_cast<uint8_t*>(cv), static_cast<uint8_t*>(ck),
        static_cast<uint8_t*>(ordered), static_cast<uint8_t*>(acked),
        static_cast<int32_t*>(frontier), static_cast<const uint32_t*>(words),
        N, S, C, W, n_validators, cap, compact,
        static_cast<uint8_t*>(ev_prepared), static_cast<uint8_t*>(ev_newly),
        static_cast<uint8_t*>(ev_ordered), static_cast<uint8_t*>(ev_stable),
        static_cast<int32_t*>(ev_pc), static_cast<int32_t*>(ev_cc),
        static_cast<int32_t*>(new_prep), static_cast<int32_t*>(n_prep),
        static_cast<int32_t*>(new_comm), static_cast<int32_t*>(n_comm),
        static_cast<uint8_t*>(stable_u8));
  }
  return static_cast<int>(cudaGetLastError());
}
