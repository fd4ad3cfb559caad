// Device code shared by the vote-plane kernels: the grouped quorum step
// (K7, quorum.cu), the fused verify + step (K14, ed25519.cu: one word's
// scatter, the counts and the decide), the window slide and zero (K8,
// window.cu), and the resident step in its one form for every validator
// tile count (K9 at one tile, the tiled K9) with the member x validator
// fabric step (K13): one kernel in resident_tile.cu. K7, K9, K13 and K14
// decide through one path (decide_slots, decide_checkpoints; K7, K9 and
// K13 also compact_member), so they cannot drift.
//
// Every function here works on ONE member plane inside one thread block
// and is called by all threads of the block alike (some hold a barrier),
// but scatter_word, which is one thread's.
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

// QuorumEvents, then the CompactEvents slot lists, counts, stable flags
// and the frontier snapshot the host reads (a copy, never the live state)
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
  int32_t* frontier;
};

// Member m's hit planes: the bases scatter_word stores into, computed
// once a member, not once a word.
struct MemberPlanes {
  uint8_t* pp;
  uint8_t* pv;
  uint8_t* cv;
  uint8_t* ck;
};

__device__ __forceinline__ MemberPlanes member_planes(const Planes& p, int m,
                                                      int N, int S, int C) {
  return {p.pp + static_cast<size_t>(m) * S,
          p.pv + static_cast<size_t>(m) * N * S,
          p.cv + static_cast<size_t>(m) * N * S,
          p.ck + static_cast<size_t>(m) * N * C};
}

// Store word w's 1 into a member's hit planes: prepare and commit votes of
// the validator rows [row_lo, row_lo + rows) (a resident_tile.cu cluster
// block's rows; the whole plane for K7 and K14) at the slots [s_lo, s_hi)
// (a K7 cluster block's chunk; all S otherwise); a PRE-PREPARE at those
// slots when ``pp_owner`` (per slot, whatever the sender: quorum.py:170);
// a checkpoint vote of those rows when ``ck_owner`` (bounded by C, not S:
// :153). An invalid word (bit 31 clear) stores nothing. The reference's
// scatter is a max of 0/1 bytes, idempotent, so plain stores are right in
// any thread order and any number of times.
__device__ __forceinline__ void scatter_word(const MemberPlanes& mp,
                                             uint32_t w, int S, int C,
                                             int row_lo, int rows, int s_lo,
                                             int s_hi, bool pp_owner,
                                             bool ck_owner) {
  if (!(w >> 31)) return;
  const int kind = (w >> 29) & 0x3;
  const int sender = (w >> 16) & 0x1FFF;
  const int slot = w & 0xFFFF;
  const bool in_chunk = slot >= s_lo && slot < s_hi;
  if (kind == 0) {
    if (pp_owner && in_chunk) mp.pp[slot] = 1;
  } else if (sender >= row_lo && sender < row_lo + rows) {
    if (kind == 1) {
      if (in_chunk) mp.pv[static_cast<size_t>(sender) * S + slot] = 1;
    } else if (kind == 2) {
      if (in_chunk) mp.cv[static_cast<size_t>(sender) * S + slot] = 1;
    } else {
      if (ck_owner && slot < C) {
        mp.ck[static_cast<size_t>(sender) * C + slot] = 1;
      }
    }
  }
}

// Decode member m's W words and store each one's 1 (scatter_word), the
// words spread over the block's threads. So every byte has one writer.
__device__ __forceinline__ void scatter_member_rows(
    const Planes& p, int m, const uint32_t* __restrict__ wm, int N, int S,
    int C, int W, int row_lo, int rows, int s_lo, int s_hi, bool pp_owner,
    bool ck_owner) {
  const MemberPlanes mp = member_planes(p, m, N, S, C);
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    scatter_word(mp, wm[j], S, C, row_lo, rows, s_lo, s_hi, pp_owner,
                 ck_owner);
  }
}

constexpr int kSlideUnroll = 4;  // words a thread holds between barriers

// Roll the len = nr x S bytes at ``run`` (nr whole rows of S bytes, one after
// another) left by d > 0 row by row, zero-filling the vacated columns (out[c]
// = c < S - d ? in[c + d] : 0, so d >= S clears the rows), in place with no
// shared-memory stage. Called by every thread of the block (it holds
// barriers). The run moves as one flat stretch: out[i] = in[i + d] unless i's
// column i mod S is >= S - d, then 0. A thread writes whole aligned 4-byte
// words: each from one or two aligned loads joined by a funnel shift when d %
// 4 != 0, its columns walked incrementally (no division a byte); the words at
// the ends of a run, which hold bytes of a neighbouring run, are written a
// byte at a time. A read can fall outside the run (the aligned words at its
// ends, or past the run's end), but such bytes only feed bytes outside the run
// or masked columns, and a load never starts past the run's end. The run is
// moved in stretches of kSlideUnroll words a thread: every read of a stretch
// before a barrier, then its writes; a later stretch reads only words at or
// past its own, which this one does not write.
__device__ __forceinline__ void slide_run(uint8_t* run, int len, int S,
                                          int d) {
  const int pre = static_cast<int>(reinterpret_cast<uintptr_t>(run) & 3);
  uint8_t* base = run - pre;  // the aligned word holding the run's first byte
  const uint8_t* end = run + len;
  const int words = (pre + len + 3) >> 2;
  const int keep = d < S ? S - d : 0;  // columns that survive
  const int sh = 8 * (d & 3);
  const int hop = d & ~3;
  const int t = static_cast<int>(threadIdx.x);
  const int stride = static_cast<int>(blockDim.x);
  // the column of the first byte of this thread's first word, then the
  // step between its words (4 x blockDim bytes)
  int col = (4 * t - pre) % S;
  if (col < 0) col += S;
  const int step = (4 * stride) % S;
  for (int w0 = 0; w0 < words; w0 += kSlideUnroll * stride) {
    uint32_t val[kSlideUnroll];
#pragma unroll
    for (int u = 0; u < kSlideUnroll; ++u) {
      const int w = w0 + u * stride + t;
      uint32_t x = 0;
      if (w < words && keep > 0) {
        const uint8_t* src = base + 4 * w + hop;
        const uint32_t lo =
            src < end ? *reinterpret_cast<const uint32_t*>(src) : 0u;
        const uint32_t hi =
            sh != 0 && src + 4 < end
                ? *reinterpret_cast<const uint32_t*>(src + 4)
                : 0u;
        x = __funnelshift_r(lo, hi, sh);
      }
      val[u] = x;
    }
    __syncthreads();  // every read of this stretch before any write
#pragma unroll
    for (int u = 0; u < kSlideUnroll; ++u) {
      const int w = w0 + u * stride + t;
      if (w < words) {
        uint32_t mask = 0;
        int c = col;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (c < keep) mask |= 0xFFu << (8 * b);
          if (++c == S) c = 0;
        }
        const uint32_t x = val[u] & mask;
        const int o = 4 * w - pre;  // the word's first byte in the run
        uint8_t* dst = base + 4 * w;
        if (o >= 0 && o + 4 <= len) {
          *reinterpret_cast<uint32_t*>(dst) = x;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (o + b >= 0 && o + b < len) dst[b] = (x >> (8 * b)) & 0xFF;
          }
        }
      }
      col += step;
      if (col >= S) col -= S;
    }
  }
}

// Zero the len >= 0 bytes at ``run``, by every thread of the block alike:
// the bytes before the run's first 16-byte boundary one a thread, its
// aligned body as 16-byte stores, the bytes after its last whole 16-byte
// word one a thread. Every byte of the run is written once and no byte
// outside it.
__device__ __forceinline__ void zero_run(uint8_t* run, int len) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(run) & 15);
  int head = (16 - mis) & 15;
  if (head > len) head = len;
  const int body = (len - head) >> 4;
  const int tail = (len - head) & 15;
  const int t = static_cast<int>(threadIdx.x);
  if (t < head) run[t] = 0;
  uint4* words = reinterpret_cast<uint4*>(run + head);
  for (int i = t; i < body; i += static_cast<int>(blockDim.x)) {
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  uint8_t* end = run + head + 16 * body;
  if (t < tail) end[t] = 0;
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

__device__ __forceinline__ int checkpoint_count(const Planes& p, int m,
                                                int r0, int nr, int N, int C,
                                                int c) {
  const uint8_t* ckm = p.ck + (static_cast<size_t>(m) * N + r0) * C;
  int kc = 0;
  for (int n = 0; n < nr; ++n) kc += ckm[static_cast<size_t>(n) * C + c];
  return kc;
}

// Four slots' bytes of one row from slot s0 on (little-endian: slot s0 in
// bits 0-7): one aligned word load, or bytes below s_hi one at a time.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int s0,
                                          int s_hi, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(row + s0);
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (s0 + i < s_hi) v |= static_cast<uint32_t>(row[s0 + i]) << (8 * i);
  }
  return v;
}

// load4 through L2 (__ldcg): for planes other blocks of the same launch
// wrote, never read through L1 or the read-only path (K14's tail). Kept
// apart from load4: one template over both loads put K9's kernel at 64
// registers with spills (62 and none with load4 as it is).
__device__ __forceinline__ uint32_t load4_cg(const uint8_t* row, int s0,
                                             int s_hi, bool aligned) {
  if (aligned) return __ldcg(reinterpret_cast<const uint32_t*>(row + s0));
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (s0 + i < s_hi) {
      v |= static_cast<uint32_t>(__ldcg(row + s0 + i)) << (8 * i);
    }
  }
  return v;
}

// Prepare and commit column counts of member m's validator rows [r0, r0 + nr)
// at the slots [s_lo, s_hi) into pc[s - s_lo] and cc[s - s_lo] (shared memory
// the caller zeroed before a barrier). A thread takes one 4-slot word of the
// chunk and the rows g, g + G, ... of the run (G row groups), so neighbouring
// lanes read neighbouring words of a row. Bytes are summed two to a 32-bit
// lane (bytes 0 and 2, bytes 1 and 3, 16 bits each): exact for any byte values
// over 256 rows, then widened to int; the G groups meet in shared atomics.
// Rows are read a word at a time when S % 4 == 0 (every row then starts 4-byte
// aligned, and the chunk bounds are multiples of 4), else a byte at a time:
// both paths load the same bytes into the same lanes, so they give the same
// sums.
__device__ __forceinline__ void chunk_counts(const Planes& p, int m, int N,
                                             int S, int r0, int nr,
                                             int s_lo, int s_hi, int* pc,
                                             int* cc) {
  const int span = s_hi - s_lo;
  if (span <= 0) return;
  const int words = (span + 3) / 4;
  const int groups = static_cast<int>(blockDim.x) >= words
                         ? static_cast<int>(blockDim.x) / words
                         : 1;
  const bool aligned = (S & 3) == 0;
  const uint8_t* pvm = p.pv + (static_cast<size_t>(m) * N + r0) * S;
  const uint8_t* cvm = p.cv + (static_cast<size_t>(m) * N + r0) * S;
  for (int t = threadIdx.x; t < groups * words; t += blockDim.x) {
    const int g = t / words;
    if (g >= nr) continue;  // more row groups than rows
    const int s0 = s_lo + 4 * (t - g * words);
    int tp[4] = {0, 0, 0, 0};
    int tc[4] = {0, 0, 0, 0};
    uint32_t p02 = 0, p13 = 0, c02 = 0, c13 = 0;
    int k = 0;
#pragma unroll 4
    for (int n = g; n < nr; n += groups) {
      const uint32_t a = load4(pvm + static_cast<size_t>(n) * S, s0, s_hi,
                               aligned);
      const uint32_t b = load4(cvm + static_cast<size_t>(n) * S, s0, s_hi,
                               aligned);
      p02 += a & 0x00FF00FFu;
      p13 += (a >> 8) & 0x00FF00FFu;
      c02 += b & 0x00FF00FFu;
      c13 += (b >> 8) & 0x00FF00FFu;
      if (++k == 256 || n + groups >= nr) {
        tp[0] += p02 & 0xFFFF;
        tp[1] += p13 & 0xFFFF;
        tp[2] += p02 >> 16;
        tp[3] += p13 >> 16;
        tc[0] += c02 & 0xFFFF;
        tc[1] += c13 & 0xFFFF;
        tc[2] += c02 >> 16;
        tc[3] += c13 >> 16;
        p02 = p13 = c02 = c13 = 0;
        k = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (s0 + i < s_hi) {
        atomicAdd(pc + (s0 - s_lo + i), tp[i]);
        atomicAdd(cc + (s0 - s_lo + i), tc[i]);
      }
    }
  }
}

// chunk_counts for a block of few warps whose loads each cross to L2 on
// its chain (K14's tail, one warp, reading planes other blocks of its
// launch wrote: through L2, never L1 or the read-only path): a thread owns
// whole 4-slot words (no atomics: pc and cc zeroed by the caller, before
// a barrier; 16-bit, so N < 65,536 rows) and issues a batch of kRowBatch
// rows' loads of both planes before it adds any, so a batch costs one
// round trip; bytes summed straight into int lanes. The same sums as
// chunk_counts.
constexpr int kRowBatch = 16;

template <bool kAligned>
__device__ __forceinline__ void l2_word_counts(const uint8_t* pvm,
                                               const uint8_t* cvm, int S,
                                               int nr, int s0, int s_hi,
                                               int tp[4], int tc[4]) {
  for (int n0 = 0; n0 < nr; n0 += kRowBatch) {
    uint32_t a[kRowBatch], b[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const size_t row = static_cast<size_t>(n0 + u) * S;
      const bool in = n0 + u < nr;
      a[u] = in ? load4_cg(pvm + row, s0, s_hi, kAligned) : 0u;
      b[u] = in ? load4_cg(cvm + row, s0, s_hi, kAligned) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tp[i] += (a[u] >> (8 * i)) & 0xFF;
        tc[i] += (b[u] >> (8 * i)) & 0xFF;
      }
    }
  }
}

__device__ __forceinline__ void l2_chunk_counts(const Planes& p, int m,
                                                int N, int S, int r0,
                                                int nr, int s_lo, int s_hi,
                                                uint16_t* pc, uint16_t* cc) {
  const int words = (s_hi - s_lo + 3) / 4;
  const uint8_t* pvm = p.pv + (static_cast<size_t>(m) * N + r0) * S;
  const uint8_t* cvm = p.cv + (static_cast<size_t>(m) * N + r0) * S;
  for (int t = threadIdx.x; t < words; t += blockDim.x) {
    const int s0 = s_lo + 4 * t;
    int tp[4] = {0, 0, 0, 0};
    int tc[4] = {0, 0, 0, 0};
    if ((S & 3) == 0) {
      l2_word_counts<true>(pvm, cvm, S, nr, s0, s_hi, tp, tc);
    } else {
      l2_word_counts<false>(pvm, cvm, S, nr, s0, s_hi, tp, tc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (s0 + i < s_hi) {
        pc[s0 - s_lo + i] += tp[i];
        cc[s0 - s_lo + i] += tc[i];
      }
    }
  }
}

// Quorum decision of member m at the slots [s_lo, s_hi) from their column
// counts (``counts(s, &pc, &cc)``): against n-f-1 (prepare) and n-f
// (commit), f from the REAL validator count; prepared / newly ordered /
// cumulative ordered; with ``compact`` prepared_acked is SET to prepared
// (quorum.py:274), not or-ed. The three flags of slot s go to
// ``f_*[s]`` (the compacting block's shared memory: its own, or the
// cluster leader's over DSMEM).
template <class Counts>
__device__ __forceinline__ void decide_slots(
    const Planes& p, const Events& e, int m, int S, int s_lo, int s_hi,
    int n_validators, int compact, Counts counts, uint8_t* f_newprep,
    uint8_t* f_newly, uint8_t* f_ordered) {
  const size_t ms = static_cast<size_t>(m) * S;
  const uint8_t* ppm = p.pp + ms;
  const int f = (n_validators - 1) / 3;
  const int prepare_q = n_validators - f - 1;
  const int commit_q = n_validators - f;
  for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
    int pc, cc;
    counts(s, &pc, &cc);
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
}

// Stable checkpoints of member m: ``chk_count(c)`` against n-f.
template <class ChkCount>
__device__ __forceinline__ void decide_checkpoints(const Events& e, int m,
                                                   int C, int n_validators,
                                                   ChkCount chk_count) {
  const int commit_q = n_validators - (n_validators - 1) / 3;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const bool st = chk_count(c) >= commit_q;
    e.stable[static_cast<size_t>(m) * C + c] = st;
    e.stable_u8[static_cast<size_t>(m) * C + c] = st;
  }
}

// The compact record of member m from its S flags (after a barrier that
// orders every flag's write before it): ascending delta-slot lists capped
// at ``cap`` and padded with S, with the true counts (warp ballots +
// popcounts; warp 0 new prepared, warp 1 new committed), and the frontier
// max(old, leading run of ordered) (warp 2; :272) into the snapshot, and
// into the state with ``compact``.
__device__ __forceinline__ void compact_member(
    const Planes& p, const Events& e, int m, int S, int cap, int compact,
    const uint8_t* f_newprep, const uint8_t* f_newly,
    const uint8_t* f_ordered) {
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
    if (lane == 0) {
      const int old = p.frontier[m];
      const int now = old > lead ? old : lead;
      e.frontier[m] = now;
      if (compact) p.frontier[m] = now;
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

// The outputs of one step, carved from ONE allocation in this order
// (tpu/quorum.py _outputs carves the same views): int32 prepare counts
// (M, S), commit counts (M, S), new_prepared (M, cap), n_prepared (M),
// new_committed (M, cap), n_committed (M), the frontier snapshot (M); then
// bytes: prepared, newly, ordered (M, S) each, stable (M, C) for the
// events and (M, C) for the compact record.
inline Events events_at(void* out, int M, int S, int C, int cap) {
  const size_t ms = static_cast<size_t>(M) * S;
  const size_t mc = static_cast<size_t>(M) * C;
  const size_t md = static_cast<size_t>(M) * cap;
  Events e;
  int32_t* i = static_cast<int32_t*>(out);
  e.pc = i;
  e.cc = i + ms;
  e.new_prep = i + 2 * ms;
  e.n_prep = e.new_prep + md;
  e.new_comm = e.n_prep + M;
  e.n_comm = e.new_comm + md;
  e.frontier = e.n_comm + M;
  uint8_t* b = reinterpret_cast<uint8_t*>(e.frontier + M);
  e.prepared = b;
  e.newly = b + ms;
  e.ordered = b + 2 * ms;
  e.stable = b + 3 * ms;
  e.stable_u8 = e.stable + mc;
  return e;
}

}  // namespace qc
