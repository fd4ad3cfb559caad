// The vote window's rare-path ops: the checkpoint slide and the view-change
// zero, a grid of (member, chunk of rows) blocks, both in place.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:358
// `slide_state` (vmapped over members as compile_plan.py:83 `_slide_body`,
// jitted at compile_plan.py:196, and for the standalone plane at
// vote_plane.py:173) and compile_plan.py:83 `_zero_body` (jitted at :197).
//
// slide_kernel, per member m with d = deltas[m] (d >= 0: a window only
// moves forward):
//   - d == 0 returns at once: a strict identity (the grouped slide passes 0
//     for every member but the one that stabilized a checkpoint);
//   - each row of preprepare_seen, ordered, prepared_acked (S bytes) and of
//     prepare_votes, commit_votes (N rows of S bytes) becomes
//     out[c] = c < S - d ? in[c + d] : 0, so d >= S clears the rows;
//   - checkpoint_votes is zeroed; frontier = max(frontier - d, 0).
// zero_kernel, per member m with mask[m] != 0: every leaf row is zeroed.
//
// What bounds it on an H100: bytes. A sliding member at the main path's
// size (N = 64, S = 300, C = 3) moves 2 x 131 x 300 + 192 bytes, ~79 KB,
// 24 ns of HBM time; with one sliding member per launch the launch itself
// (a few microseconds) is the real cost.
//
// Design: a row's shift never leaves the row, so blocks are independent.
// The shift is in place, so a thread must not overwrite a column that
// another thread has still to read: each block stages its rows
// (kRowsPerBlock of them, fewer when S is large) in shared memory,
// synchronizes, then writes the shifted rows back. Neighbour threads touch
// neighbour bytes of a row on both passes (coalesced). A member with d >=
// S skips the read pass. Spreading one member's rows over many blocks
// keeps the lone sliding member of the pool's pattern from running on one
// SM. The row roll itself is quorum_common.cuh's, which K9 runs for the
// slides it folds in.
//   - Host deltas (every pool path): the wrapper keeps the members whose
//     delta is positive and passes their (row, delta) pairs in the
//     kernel's parameters, kMaxPairs a launch (2 KB of the 4 KB parameter
//     space), so no operand crosses to the card. The grid is (pair, chunk
//     of rows), a chunk about kThreads bytes so that each thread loads
//     about one byte: at 64 x 64 x 300 one sliding member is 131 blocks
//     of one row (a block of 8 rows loads 10 bytes a thread, one after
//     another, and took 5.9 us on an H100).
//   - Device deltas: the grid is (member, chunk of rows) and every block
//     reads deltas[m]; a member with d <= 0 leaves at once.
// The zero uses the (member, chunk of rows) grid with a device mask.
#include "quorum_common.cuh"

namespace {

constexpr int kThreads = qc::kThreads;
constexpr int kStageBytes = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr int kRowsPerBlock = 8;
constexpr int kMaxPairs = 256;

// the sliding members of a host-deltas slide, in the kernel's parameters
struct SlidePairs {
  int32_t row[kMaxPairs];
  int32_t delta[kMaxPairs];  // > 0
};

// block (., blockIdx.y)'s rows of member m's slide by d > 0
__device__ __forceinline__ void slide_block(const qc::Planes& p, int m,
                                            int d, int N, int S, int C,
                                            int rows_per_block) {
  extern __shared__ uint8_t stage[];  // rows_per_block x S bytes
  const int rows = 2 * N + 3;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = rows - r0 < rows_per_block ? rows - r0 : rows_per_block;
  qc::slide_rows(p, m, r0, nr, d, N, S, stage);
  if (blockIdx.y == 0) qc::slide_tail(p, m, d, N, C);
}

__global__ void slide_kernel(qc::Planes p,
                             const int32_t* __restrict__ deltas, int N,
                             int S, int C, int rows_per_block) {
  const int m = blockIdx.x;
  const int d = deltas[m];
  if (d <= 0) return;
  slide_block(p, m, d, N, S, C, rows_per_block);
}

__global__ void slide_pairs_kernel(qc::Planes p,
                                   const __grid_constant__ SlidePairs pairs,
                                   int N, int S, int C, int rows_per_block) {
  slide_block(p, pairs.row[blockIdx.x], pairs.delta[blockIdx.x], N, S, C,
              rows_per_block);
}

__global__ void zero_kernel(qc::Planes p, const uint8_t* __restrict__ mask,
                            int N, int S, int C, int rows_per_block) {
  const int m = blockIdx.x;
  if (!mask[m]) return;
  const int rows = 2 * N + 3;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = rows - r0 < rows_per_block ? rows - r0 : rows_per_block;
  for (int i = threadIdx.x; i < nr * S; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    qc::row_ptr(p, r0 + r, m, N, S)[c] = 0;
  }
  if (blockIdx.y == 0) {
    uint8_t* ckm = p.ck + static_cast<size_t>(m) * N * C;
    for (int i = threadIdx.x; i < N * C; i += blockDim.x) ckm[i] = 0;
    if (threadIdx.x == 0) p.frontier[m] = 0;
  }
}

// (member, row chunk) grid shared by both kernels
dim3 window_grid(int M, int N, int S, int* rows_per_block) {
  int per = kStageBytes / S;
  *rows_per_block = per < kRowsPerBlock ? per : kRowsPerBlock;
  const int rows = 2 * N + 3;
  return dim3(M, (rows + *rows_per_block - 1) / *rows_per_block);
}

}  // namespace

extern "C" int window_slide_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* deltas, int M, int N, int S, int C,
    void* stream) {
  if (S <= 0 || S > kStageBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    int per;
    const dim3 grid = window_grid(M, N, S, &per);
    slide_kernel<<<grid, kThreads, per * S,
                   static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const int32_t*>(deltas), N, S, C, per);
  }
  return static_cast<int>(cudaGetLastError());
}

// ``pairs``: host int32 (row, delta) pairs, each delta > 0 and each row a
// member of the state; 1 <= n_pairs <= kMaxPairs
extern "C" int window_slide_pairs_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* pairs, int n_pairs, int N, int S, int C,
    void* stream) {
  if (S <= 0 || S > kStageBytes || n_pairs < 1 || n_pairs > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in = static_cast<const int32_t*>(pairs);
  SlidePairs t;
  for (int i = 0; i < n_pairs; ++i) {
    t.row[i] = in[2 * i];
    t.delta[i] = in[2 * i + 1];
  }
  // about one row element a thread: the rows' loads run in one round
  int per = kThreads / S;
  per = per < 1 ? 1 : (per > kRowsPerBlock ? kRowsPerBlock : per);
  const int rows = 2 * N + 3;
  const dim3 grid(n_pairs, (rows + per - 1) / per);
  slide_pairs_kernel<<<grid, kThreads, per * S,
                       static_cast<cudaStream_t>(stream)>>>(
      qc::planes(pp, pv, cv, ck, ordered, acked, frontier), t, N, S, C, per);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int window_zero_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* mask, int M, int N, int S, int C,
    void* stream) {
  if (S <= 0 || S > kStageBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    int per;
    const dim3 grid = window_grid(M, N, S, &per);
    zero_kernel<<<grid, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const uint8_t*>(mask), N, S, C, per);
  }
  return static_cast<int>(cudaGetLastError());
}
