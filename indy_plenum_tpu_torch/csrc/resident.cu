// The resident multi-slot quorum step (K9): one thread block per member
// plane consumes k ring slots, then evaluates quorums once.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/compile_plan.py:100
// `resident_plan_for`, its unsharded body (:119-130): for each slot k,
// `slide_state` (quorum.py:358, vmapped over members) by slides[k], then
// `unpack_words` (:485) + `scatter_batch` (:322) of words[k]; then ONE
// `eval_compact` (:342) with the compact deltas.
//
// Per member m, in this order (the order is the contract: a vote staged
// before a slide lands in pre-slide coordinates and is rolled with the
// window, which is what the residency ring's slide_member relies on):
//   for k in 0 .. K-1:
//     - d = slides[k][m]; when d > 0, K8's slide: every slot-axis row
//       rolled left by d with the vacated columns zeroed (d >= S clears),
//       checkpoint votes cleared, frontier = max(frontier - d, 0); d == 0
//       is a strict identity;
//     - K7's decode and scatter of words[k][m] (an all-invalid row is a
//       no-op);
//   then the column counts over all N rows and the decide K7 and K13
//   share (prepared_acked / ordered / frontier update and compaction,
//   with compact = 1).
// All of it is quorum_common.cuh's device code, shared with K7 and K8, so
// the three agree bit for bit. State is updated in place.
//
// What bounds it on an H100: bytes. A consume at the main path's size
// (M = 64, N = 64, S = 300, C = 3, W = 128, k = 4) reads the words
// (131 KB) and the planes once for the eval (~2.5 MB), plus each sliding
// member's 131 rows read and written (~79 KB); at 3.35 TB/s that is under
// a microsecond, so one launch's latency is the real cost - which is the
// point of the kernel: k ticks ride one launch and one readback.
//
// Design: one block per member, as K7, so a member's slides, scatters and
// eval never meet another member's and no cross-block synchronisation is
// needed; barriers order the phases inside the block. A slide stages the
// member's rows through dynamic shared memory in chunks of up to 32 KB
// (all 131 rows at S = 300 in two chunks), as K8 does. Known later work:
// hold a member's whole plane set (~40 KB at n = 64) in shared memory
// across the k slots, so a consume reads and writes the state once.
//
// The tiled K9 is resident_tile.cu.
#include "quorum_common.cuh"

namespace {

constexpr int kStageBytes = 32 * 1024;  // + 12 KB of flags: no opt-in

__global__ void resident_step_kernel(qc::Planes p,
                                     const int32_t* __restrict__ slides,
                                     const uint32_t* __restrict__ words,
                                     int K, int M, int N, int S, int C,
                                     int W, int n_validators, int cap,
                                     int rows_per_chunk, qc::Events e) {
  extern __shared__ uint8_t stage[];  // rows_per_chunk x S bytes
  __shared__ uint8_t f_newprep[qc::kMaxSlots];
  __shared__ uint8_t f_newly[qc::kMaxSlots];
  __shared__ uint8_t f_ordered[qc::kMaxSlots];
  const int m = blockIdx.x;
  const int rows = 2 * N + 3;
  for (int k = 0; k < K; ++k) {
    const size_t km = static_cast<size_t>(k) * M + m;
    const int d = slides[km];
    if (d > 0) {
      for (int r0 = 0; r0 < rows; r0 += rows_per_chunk) {
        const int nr = rows - r0 < rows_per_chunk ? rows - r0
                                                  : rows_per_chunk;
        qc::slide_rows(p, m, r0, nr, d, N, S, stage);
        __syncthreads();  // the stage is reused by the next chunk
      }
      qc::slide_tail(p, m, d, N, C);
      __syncthreads();
    }
    qc::scatter_member(p, m, words + km * W, nullptr, N, S, C, W);
    __syncthreads();
  }
  qc::eval_member(p, e, m, N, S, C, n_validators, cap, 1, f_newprep,
                  f_newly, f_ordered);
}

}  // namespace

extern "C" int resident_step_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, int K, int M,
    int N, int S, int C, int W, int n_validators, int cap, void* out,
    void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = 2 * N + 3;
  const int fit = kStageBytes / S;
  const int per = fit < rows ? fit : rows;
  if (M > 0) {
    resident_step_kernel<<<M, qc::kThreads, per * S,
                           static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const int32_t*>(slides),
        static_cast<const uint32_t*>(words), K, M, N, S, C, W,
        n_validators, cap, per, qc::events_at(out, M, S, C, cap));
  }
  return static_cast<int>(cudaGetLastError());
}
