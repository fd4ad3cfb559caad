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
// The tiled K9 (resident_tile_kernel, then fabric.cu's decide) replaces
// compile_plan.py:141-173, resident_plan_for's mesh branches: the same
// slots on the fabric's tiles (see fabric.cu for the one-device layout).
// Block (m, j) of grid (M, v), per slot in the same slide-then-scatter
// order: K8's slide of tile j's prepare, commit and checkpoint rows (and,
// for tile 0, of the member's preprepare_seen / ordered / prepared_acked
// rows and frontier), then the scatter of the tile's senders (the
// PRE-PREPARE by tile 0, the block that slides it); after the last slot,
// the tile's partial counts. fabric.cu's decide kernel then sums the v
// partials and decides with compact = 1, as K13 does. Bound: bytes, as
// the unsharded K9 plus the partials' write and read (2 x M x v x (2S +
// C) x 4 bytes).
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

__global__ void resident_tile_kernel(qc::Planes p,
                                     const int32_t* __restrict__ slides,
                                     const uint32_t* __restrict__ words,
                                     int K, int M, int N, int S, int C,
                                     int W, int v, int rows_per_chunk,
                                     int32_t* __restrict__ pc_part,
                                     int32_t* __restrict__ cc_part,
                                     int32_t* __restrict__ kc_part) {
  extern __shared__ uint8_t stage[];  // rows_per_chunk x S bytes
  const int m = blockIdx.x;
  const int j = blockIdx.y;
  const int nv = N / v;
  const int r0 = j * nv;
  const bool owner = j == 0;
  for (int k = 0; k < K; ++k) {
    const size_t km = static_cast<size_t>(k) * M + m;
    const int d = slides[km];
    if (d > 0) {
      qc::slide_tile(p, m, r0, nv, owner, d, N, S, C, rows_per_chunk,
                     stage);
      __syncthreads();
    }
    qc::scatter_member_rows(p, m, words + km * W, nullptr, N, S, C, W, r0,
                            nv, 0, S, owner, true);
    __syncthreads();
  }
  qc::tile_partials(p, m, j, v, r0, nv, N, S, C, pc_part, cc_part,
                    kc_part);
}

}  // namespace

extern "C" int resident_tile_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, int K, int M,
    int N, int S, int C, int W, int v, int n_validators, int cap,
    void* pc_part, void* cc_part, void* kc_part, void* out, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || K < 0 || v < 1 || N % v != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qc::Planes p = qc::planes(pp, pv, cv, ck, ordered, acked, frontier);
  const int fit = kStageBytes / S;
  const int most = N / v > 3 ? N / v : 3;  // rows of a tile's largest group
  const int per = fit < most ? fit : most;
  if (M > 0) {
    resident_tile_kernel<<<dim3(M, v), qc::kThreads, per * S, st>>>(
        p, static_cast<const int32_t*>(slides),
        static_cast<const uint32_t*>(words), K, M, N, S, C, W, v, per,
        static_cast<int32_t*>(pc_part), static_cast<int32_t*>(cc_part),
        static_cast<int32_t*>(kc_part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return qc::fabric_decide(
      p, qc::events_at(out, M, S, C, cap),
      static_cast<const int32_t*>(pc_part),
      static_cast<const int32_t*>(cc_part),
      static_cast<const int32_t*>(kc_part), M, v, S, C, n_validators, cap,
      1, st);
}

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
