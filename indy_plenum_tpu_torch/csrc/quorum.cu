// The grouped quorum step: one thread block per member plane.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:284
// `step_compact` as the grouped compile_plan.py:186-199 step runs it
// (vmapped over members), with `unpack_words` (quorum.py:485),
// `_scatter_local`/`_quorum_events` (:145-207) and `compact_from_events`/
// `_delta_slots` (:248-281) fused into one launch.
//
// Per member m (the device functions of quorum_common.cuh, shared with
// K8 and K9):
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
// ``ok`` (nullable) is K14's verdict operand (tpu/step.py, replacing
// indy_plenum_tpu/tpu/step.py:29 `fused_step`): one byte per word, laid
// out as the words; a word whose verdict is 0 is dropped in the decode,
// as the reference's ``valid &= ok``. Every other call passes NULL.
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
#include "quorum_common.cuh"

namespace {

__global__ void quorum_step_kernel(qc::Planes p,
                                   const uint32_t* __restrict__ words,
                                   const uint8_t* __restrict__ ok, int N,
                                   int S, int C, int W, int n_validators,
                                   int cap, int compact, qc::Events e) {
  __shared__ uint8_t f_newprep[qc::kMaxSlots];
  __shared__ uint8_t f_newly[qc::kMaxSlots];
  __shared__ uint8_t f_ordered[qc::kMaxSlots];
  const int m = blockIdx.x;
  const size_t mw = static_cast<size_t>(m) * W;
  qc::scatter_member(p, m, words + mw, ok != nullptr ? ok + mw : nullptr,
                     N, S, C, W);
  __syncthreads();
  qc::eval_member(p, e, m, N, S, C, n_validators, cap, compact, f_newprep,
                  f_newly, f_ordered);
}

}  // namespace

extern "C" int quorum_step_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* words, const void* ok, int M, int N, int S,
    int C, int W, int n_validators, int cap, int compact, void* ev_prepared,
    void* ev_newly, void* ev_ordered, void* ev_stable, void* ev_pc,
    void* ev_cc, void* new_prep, void* n_prep, void* new_comm,
    void* n_comm, void* stable_u8, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    quorum_step_kernel<<<M, qc::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const uint32_t*>(words),
        static_cast<const uint8_t*>(ok), N, S, C, W, n_validators, cap,
        compact,
        qc::events(ev_prepared, ev_newly, ev_ordered, ev_stable, ev_pc,
                   ev_cc, new_prep, n_prep, new_comm, n_comm, stable_u8));
  }
  return static_cast<int>(cudaGetLastError());
}
