// The grouped quorum step: one cluster of kCluster thread blocks per
// member plane.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:284
// `step_compact` as the grouped compile_plan.py:186-199 step runs it
// (vmapped over members), with `unpack_words` (quorum.py:485),
// `_scatter_local`/`_quorum_events` (:145-207) and `compact_from_events`/
// `_delta_slots` (:248-281) fused into one launch.
//
// Per member m (the device functions of quorum_common.cuh, shared with
// K8, K9 and K13):
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
//      list), and the frontier max(old, leading run of ordered) (:272),
//      written to the state and to the snapshot the host reads.
// State is updated in place (the reference donates it). All outputs go to
// one device allocation (qc::events_at); the host reads only the compact
// record, except on overflow or in host-eval mode.
//
// What bounds it on an H100: bytes, and at the main path's size launch
// latency. A 64 x 300-slot plane set is ~2.5 MB of uint8 votes read once
// for the counts; the arithmetic is a few adds per byte.
//
// Design: a member's slots split into kCluster chunks of a multiple of 4
// slots, one per block of the member's cluster, so M = 64 members fill
// 256 blocks on the 132 SMs. A slot's counts need no other block: each
// block scatters the words of its own chunk (block 0 also the checkpoint
// votes, whose counts it takes), counts its chunk a 4-byte word of slots
// at a time (packed byte sums, row groups meeting in shared atomics;
// quorum_common.cuh chunk_counts) and decides its slots, writing each
// slot's three flags into the LEADER block's shared memory over DSMEM.
// After cluster.sync() the leader compacts the whole member as K9 and K13
// do (compact_member), and writes the frontier snapshot, so a step is one
// launch and the host's snapshot is never the live state.
#include <cooperative_groups.h>

#include "quorum_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;
constexpr int kMaxChunk = ((qc::kMaxSlots + kCluster - 1) / kCluster + 3) &
                          ~3;

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(qc::kThreads)
        quorum_step_kernel(qc::Planes p, const uint32_t* __restrict__ words,
                           int N, int S, int C, int W, int n_validators,
                           int cap, int compact, qc::Events e) {
  __shared__ uint8_t f_newprep[qc::kMaxSlots];  // the leader's: whole member
  __shared__ uint8_t f_newly[qc::kMaxSlots];
  __shared__ uint8_t f_ordered[qc::kMaxSlots];
  __shared__ int pc_s[kMaxChunk];  // this block's chunk
  __shared__ int cc_s[kMaxChunk];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int m = blockIdx.y;
  const int chunk = ((S + kCluster - 1) / kCluster + 3) & ~3;
  const int lo = static_cast<int>(rank) * chunk;
  const int s_lo = lo < S ? lo : S;
  const int s_hi = s_lo + chunk < S ? s_lo + chunk : S;
  // the leader's flags are written over DSMEM below: every block of the
  // cluster must have started before any writes them
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const size_t mw = static_cast<size_t>(m) * W;
  qc::scatter_member_rows(p, m, words + mw, N, S, C, W, 0, N, s_lo, s_hi,
                          true, rank == 0);
  for (int i = threadIdx.x; i < s_hi - s_lo; i += blockDim.x) {
    pc_s[i] = 0;
    cc_s[i] = 0;
  }
  __syncthreads();
  qc::chunk_counts(p, m, N, S, 0, N, s_lo, s_hi, pc_s, cc_s);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  qc::decide_slots(
      p, e, m, S, s_lo, s_hi, n_validators, compact,
      [&](int s, int* pc, int* cc) {
        *pc = pc_s[s - s_lo];
        *cc = cc_s[s - s_lo];
      },
      cluster.map_shared_rank(f_newprep, 0),
      cluster.map_shared_rank(f_newly, 0),
      cluster.map_shared_rank(f_ordered, 0));
  if (rank == 0) {
    qc::decide_checkpoints(e, m, C, n_validators, [&](int c) {
      return qc::checkpoint_count(p, m, 0, N, N, C, c);
    });
  }
  cluster.sync();
  if (rank == 0) {
    qc::compact_member(p, e, m, S, cap, compact, f_newprep, f_newly,
                       f_ordered);
  }
}

}  // namespace

extern "C" int quorum_step_launch(void* pp, void* pv, void* cv, void* ck,
                                  void* ordered, void* acked, void* frontier,
                                  const void* words, int M, int N, int S,
                                  int C, int W,
                                  int n_validators, int cap, int compact,
                                  void* out, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || M > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    quorum_step_kernel<<<dim3(kCluster, M), qc::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const uint32_t*>(words), N, S, C, W, n_validators, cap,
        compact, qc::events_at(out, M, S, C, cap));
  }
  return static_cast<int>(cudaGetLastError());
}
