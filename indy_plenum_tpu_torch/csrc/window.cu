// The vote window's rare-path ops: the checkpoint slide and the view-change
// zero, one thread block per member plane, both in place.
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
// Design: the grid is (member, chunk of rows). A row's shift never leaves
// the row, so blocks are independent. The shift is in place, so a thread
// must not overwrite a column that another thread has still to read: each
// block stages its rows (kRowsPerBlock of them, fewer when S is large) in
// shared memory, synchronizes, then writes the shifted rows back.
// Neighbour threads touch neighbour bytes of a row on both passes
// (coalesced). A member with d >= S skips the read pass. Spreading one
// member's rows over many blocks keeps the lone sliding member of the
// pool's pattern from running on one SM; the other members' blocks exit
// at once. The zero uses the same grid.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr int kRowsPerBlock = 8;

// row r of member m's shifted leaves: 0 preprepare_seen, 1 ordered,
// 2 prepared_acked, then N prepare rows, then N commit rows
__device__ __forceinline__ uint8_t* row_ptr(
    int r, int m, int N, int S, uint8_t* pp, uint8_t* ordered,
    uint8_t* acked, uint8_t* pv, uint8_t* cv) {
  const size_t ms = static_cast<size_t>(m) * S;
  if (r == 0) return pp + ms;
  if (r == 1) return ordered + ms;
  if (r == 2) return acked + ms;
  r -= 3;
  uint8_t* plane = r < N ? pv : cv;
  const int n = r < N ? r : r - N;
  return plane + (static_cast<size_t>(m) * N + n) * S;
}

__global__ void slide_kernel(
    uint8_t* __restrict__ pp, uint8_t* __restrict__ pv,
    uint8_t* __restrict__ cv, uint8_t* __restrict__ ck,
    uint8_t* __restrict__ ordered, uint8_t* __restrict__ acked,
    int32_t* __restrict__ frontier, const int32_t* __restrict__ deltas,
    int N, int S, int C, int rows_per_block) {
  extern __shared__ uint8_t stage[];  // rows_per_block x S bytes
  const int m = blockIdx.x;
  const int d = deltas[m];
  if (d <= 0) return;
  const int rows = 2 * N + 3;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = rows - r0 < rows_per_block ? rows - r0 : rows_per_block;
  const int span = nr * S;
  const int keep = d < S ? S - d : 0;
  if (keep > 0) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int r = i / S, c = i - r * S;
      stage[i] = row_ptr(r0 + r, m, N, S, pp, ordered, acked, pv, cv)[c];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    row_ptr(r0 + r, m, N, S, pp, ordered, acked, pv, cv)[c] =
        c < keep ? stage[i + d] : 0;
  }
  if (blockIdx.y == 0) {
    uint8_t* ckm = ck + static_cast<size_t>(m) * N * C;
    for (int i = threadIdx.x; i < N * C; i += blockDim.x) ckm[i] = 0;
    if (threadIdx.x == 0) {
      const int f = frontier[m] - d;
      frontier[m] = f > 0 ? f : 0;
    }
  }
}

__global__ void zero_kernel(
    uint8_t* __restrict__ pp, uint8_t* __restrict__ pv,
    uint8_t* __restrict__ cv, uint8_t* __restrict__ ck,
    uint8_t* __restrict__ ordered, uint8_t* __restrict__ acked,
    int32_t* __restrict__ frontier, const uint8_t* __restrict__ mask,
    int N, int S, int C, int rows_per_block) {
  const int m = blockIdx.x;
  if (!mask[m]) return;
  const int rows = 2 * N + 3;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = rows - r0 < rows_per_block ? rows - r0 : rows_per_block;
  for (int i = threadIdx.x; i < nr * S; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    row_ptr(r0 + r, m, N, S, pp, ordered, acked, pv, cv)[c] = 0;
  }
  if (blockIdx.y == 0) {
    uint8_t* ckm = ck + static_cast<size_t>(m) * N * C;
    for (int i = threadIdx.x; i < N * C; i += blockDim.x) ckm[i] = 0;
    if (threadIdx.x == 0) frontier[m] = 0;
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
        static_cast<uint8_t*>(pp), static_cast<uint8_t*>(pv),
        static_cast<uint8_t*>(cv), static_cast<uint8_t*>(ck),
        static_cast<uint8_t*>(ordered), static_cast<uint8_t*>(acked),
        static_cast<int32_t*>(frontier),
        static_cast<const int32_t*>(deltas), N, S, C, per);
  }
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
        static_cast<uint8_t*>(pp), static_cast<uint8_t*>(pv),
        static_cast<uint8_t*>(cv), static_cast<uint8_t*>(ck),
        static_cast<uint8_t*>(ordered), static_cast<uint8_t*>(acked),
        static_cast<int32_t*>(frontier),
        static_cast<const uint8_t*>(mask), N, S, C, per);
  }
  return static_cast<int>(cudaGetLastError());
}
