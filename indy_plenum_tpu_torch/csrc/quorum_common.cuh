// Device code shared by the vote-plane kernels: the grouped quorum step
// (K7, quorum.cu), the window slide and zero (K8, window.cu) and the
// resident multi-slot step (K9, resident.cu).
//
// Every function here works on ONE member plane inside one thread block
// and is called by all threads of the block alike (some hold a barrier).
// The member-stacked VoteState leaves (tpu/quorum.py):
//   preprepare_seen, ordered, prepared_acked : (M, S) uint8
//   prepare_votes, commit_votes              : (M, N, S) uint8
//   checkpoint_votes                         : (M, N, C) uint8
//   frontier                                 : (M,) int32
// Vote words are uint32: valid(1) | kind(2) | sender(13) | slot(16).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace qc {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 4096;  // shared flags per block (S <= this)

struct Planes {
  uint8_t* pp;
  uint8_t* pv;
  uint8_t* cv;
  uint8_t* ck;
  uint8_t* ordered;
  uint8_t* acked;
  int32_t* frontier;
};

// QuorumEvents, then the CompactEvents slot lists, counts and stable flags
struct Events {
  uint8_t* prepared;
  uint8_t* newly;
  uint8_t* ordered;
  uint8_t* stable;
  int32_t* pc;
  int32_t* cc;
  int32_t* new_prep;
  int32_t* n_prep;
  int32_t* new_comm;
  int32_t* n_comm;
  uint8_t* stable_u8;
};

// row r of member m's slot-axis leaves: 0 preprepare_seen, 1 ordered,
// 2 prepared_acked, then N prepare rows, then N commit rows
__device__ __forceinline__ uint8_t* row_ptr(const Planes& p, int r, int m,
                                            int N, int S) {
  const size_t ms = static_cast<size_t>(m) * S;
  if (r == 0) return p.pp + ms;
  if (r == 1) return p.ordered + ms;
  if (r == 2) return p.acked + ms;
  r -= 3;
  uint8_t* plane = r < N ? p.pv : p.cv;
  const int n = r < N ? r : r - N;
  return plane + (static_cast<size_t>(m) * N + n) * S;
}

// Decode member m's W words and store 1 into the hit planes. The
// reference's scatter is a max of 0/1 bytes, idempotent, so plain stores
// are right in any thread order. PRE-PREPARE hits regardless of the
// sender (quorum.py:170); checkpoints are bounded by C, not S (:153).
// ``okm`` (nullable) is a per-word verdict: a word whose verdict is 0 is
// dropped like an invalid one (K14's masked decode).
__device__ __forceinline__ void scatter_member(
    const Planes& p, int m, const uint32_t* __restrict__ wm,
    const uint8_t* __restrict__ okm, int N, int S, int C, int W) {
  uint8_t* ppm = p.pp + static_cast<size_t>(m) * S;
  uint8_t* pvm = p.pv + static_cast<size_t>(m) * N * S;
  uint8_t* cvm = p.cv + static_cast<size_t>(m) * N * S;
  uint8_t* ckm = p.ck + static_cast<size_t>(m) * N * C;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const uint32_t w = wm[j];
    if (!(w >> 31)) continue;
    if (okm != nullptr && !okm[j]) continue;
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
}

// Roll rows [r0, r0 + nr) of member m left by d > 0, zero-filling the
// vacated columns: out[c] = c < S - d ? in[c + d] : 0, so d >= S clears
// the rows. The shift is in place, so the rows are staged in ``stage``
// (nr x S bytes of shared memory) before any is written back; a caller
// reusing ``stage`` for more rows must synchronize first.
__device__ __forceinline__ void slide_rows(const Planes& p, int m, int r0,
                                           int nr, int d, int N, int S,
                                           uint8_t* stage) {
  const int span = nr * S;
  const int keep = d < S ? S - d : 0;
  if (keep > 0) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int r = i / S, c = i - r * S;
      stage[i] = row_ptr(p, r0 + r, m, N, S)[c];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    row_ptr(p, r0 + r, m, N, S)[c] = c < keep ? stage[i + d] : 0;
  }
}

// The member-wide rest of a slide by d > 0: checkpoint votes cleared, the
// frontier slid with the window and clamped at 0.
__device__ __forceinline__ void slide_tail(const Planes& p, int m, int d,
                                           int N, int C) {
  uint8_t* ckm = p.ck + static_cast<size_t>(m) * N * C;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) ckm[i] = 0;
  if (threadIdx.x == 0) {
    const int f = p.frontier[m] - d;
    p.frontier[m] = f > 0 ? f : 0;
  }
}

// Quorum eval of member m over its current planes, and the compact
// record:
//   1. column counts over the N validator rows against n-f-1 (prepare)
//      and n-f (commit, checkpoint), f from the REAL validator count;
//      prepared / newly ordered / cumulative ordered; with ``compact``
//      prepared_acked is SET to prepared (quorum.py:274), not or-ed;
//   2. ascending delta-slot lists capped at ``cap`` and padded with S,
//      with the true counts (warp ballots + popcounts, one warp per
//      list), and with ``compact`` the frontier max(old, leading run of
//      ordered) (:272).
// Threads walk slots, so the reads of each validator row are coalesced.
// ``f_*`` are three kMaxSlots-byte flag arrays in shared memory.
__device__ __forceinline__ void eval_member(
    const Planes& p, const Events& e, int m, int N, int S, int C,
    int n_validators, int cap, int compact, uint8_t* f_newprep,
    uint8_t* f_newly, uint8_t* f_ordered) {
  const size_t ms = static_cast<size_t>(m) * S;
  const uint8_t* ppm = p.pp + ms;
  const uint8_t* pvm = p.pv + static_cast<size_t>(m) * N * S;
  const uint8_t* cvm = p.cv + static_cast<size_t>(m) * N * S;
  const uint8_t* ckm = p.ck + static_cast<size_t>(m) * N * C;
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
    const bool was = p.ordered[ms + s] != 0;
    const bool newly = commit_ok && !was;
    const bool now = was || commit_ok;
    const bool new_p = prepared && p.acked[ms + s] == 0;
    p.ordered[ms + s] = now ? 1 : 0;
    if (compact) p.acked[ms + s] = prepared ? 1 : 0;
    e.prepared[ms + s] = prepared;
    e.newly[ms + s] = newly;
    e.ordered[ms + s] = now;
    e.pc[ms + s] = pc;
    e.cc[ms + s] = cc;
    f_newprep[s] = new_p;
    f_newly[s] = newly;
    f_ordered[s] = now;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int kc = 0;
    for (int n = 0; n < N; ++n) kc += ckm[static_cast<size_t>(n) * C + c];
    const bool st = kc >= commit_q;
    e.stable[static_cast<size_t>(m) * C + c] = st;
    e.stable_u8[static_cast<size_t>(m) * C + c] = st;
  }
  __syncthreads();

  // compaction (warp 0: new prepared, warp 1: new committed) and the
  // frontier (warp 2)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  if (warp < 2) {
    const uint8_t* flags = warp == 0 ? f_newprep : f_newly;
    int32_t* out = (warp == 0 ? e.new_prep : e.new_comm) +
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
    if (lane == 0) (warp == 0 ? e.n_prep : e.n_comm)[m] = count;
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
      const int old = p.frontier[m];
      p.frontier[m] = old > lead ? old : lead;
    }
  }
}

inline Planes planes(void* pp, void* pv, void* cv, void* ck, void* ordered,
                     void* acked, void* frontier) {
  return Planes{static_cast<uint8_t*>(pp), static_cast<uint8_t*>(pv),
                static_cast<uint8_t*>(cv), static_cast<uint8_t*>(ck),
                static_cast<uint8_t*>(ordered), static_cast<uint8_t*>(acked),
                static_cast<int32_t*>(frontier)};
}

inline Events events(void* prepared, void* newly, void* ordered,
                     void* stable, void* pc, void* cc, void* new_prep,
                     void* n_prep, void* new_comm, void* n_comm,
                     void* stable_u8) {
  return Events{static_cast<uint8_t*>(prepared),
                static_cast<uint8_t*>(newly),
                static_cast<uint8_t*>(ordered),
                static_cast<uint8_t*>(stable),
                static_cast<int32_t*>(pc),
                static_cast<int32_t*>(cc),
                static_cast<int32_t*>(new_prep),
                static_cast<int32_t*>(n_prep),
                static_cast<int32_t*>(new_comm),
                static_cast<int32_t*>(n_comm),
                static_cast<uint8_t*>(stable_u8)};
}

}  // namespace qc
