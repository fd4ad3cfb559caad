// The vote window's rare-path ops: the checkpoint slide and the view-change
// zero, each a grid of (member, run of its bytes) blocks, both in place.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:358
// `slide_state` (vmapped over members as compile_plan.py:83 `_slide_body`,
// jitted at compile_plan.py:196, and for the standalone plane at
// vote_plane.py:173) and compile_plan.py:83 `_zero_body` (jitted at :197).
//
// The slide, per member m with d = deltas[m] (d >= 0: a window only moves
// forward):
//   - d == 0 returns at once: a strict identity (the grouped slide passes 0
//     for every member but the one that stabilized a checkpoint);
//   - each row of preprepare_seen, ordered, prepared_acked (S bytes) and of
//     prepare_votes, commit_votes (N rows of S bytes) becomes
//     out[c] = c < S - d ? in[c + d] : 0, so d >= S clears the rows;
//   - checkpoint_votes is zeroed; frontier = max(frontier - d, 0).
// The zero, per member m it resets: every leaf of m becomes 0.
//
// What bounds it on an H100: bytes. A sliding member at the main path's
// size (N = 64, S = 300, C = 3) moves 2 x 131 x 300 + 192 bytes, ~79 KB,
// a reset member writes ~39 KB: tens of ns of HBM time, so with one member
// a launch the launch itself (a few microseconds) is the real cost.
//
// Design. A member's bytes are six contiguous runs in five allocations:
// preprepare_seen, ordered and prepared_acked (S bytes each, at m S),
// prepare_votes and commit_votes (N S bytes each, at m N S) and
// checkpoint_votes (N C bytes, at m N C), and its frontier word.
//   - The slide: a row's shift never leaves the row, so blocks are
//     independent. Block 0, 1 and 2 of a member roll its three slot-axis
//     rows, the others ``per`` validator rows of one vote plane (about one
//     4-byte word a thread), each its own run with quorum_common.cuh's
//     slide_run (word loads joined by a funnel shift, no stage, no
//     division a byte); block 0 also clears the checkpoint votes and
//     slides the frontier. A run's reads that fall past its ends only feed
//     bytes outside it or masked columns, so neighbouring runs moved by
//     other blocks at the same time cannot change the result.
//   - The zero: block y of a member zeroes bytes [y kZeroChunk, (y + 1)
//     kZeroChunk) of the six runs laid end to end, each piece with
//     quorum_common.cuh's zero_run (16-byte stores over its aligned body,
//     bytes at its unaligned head and tail: the S-byte rows at m S are
//     not 16-byte aligned when S % 16 != 0); block 0 also zeroes the
//     frontier.
//   - Host deltas and host masks (every pool path): the wrapper passes the
//     sliding members' (row, delta) pairs, or the reset members' rows, in
//     the kernel's parameters (kMaxPairs and kMaxZeroRows a launch, 2 KB
//     and 1 KB of the 4 KB parameter space), so no operand crosses to the
//     card and the grid covers only those members.
//   - Device deltas and device masks: the grid covers every member and
//     each block reads deltas[m] or mask[m]; a member with nothing to do
//     leaves at once.
#include "quorum_common.cuh"

namespace {

constexpr int kThreads = qc::kThreads;
constexpr int kMaxPairs = 256;
constexpr int kMaxZeroRows = 256;
constexpr int kZeroChunk = 16 * kThreads;  // one 16-byte store a thread

// the sliding members of a host-deltas slide, in the kernel's parameters
struct SlidePairs {
  int32_t row[kMaxPairs];
  int32_t delta[kMaxPairs];  // > 0
};

// the reset members of a host-mask zero, in the kernel's parameters
struct ZeroRows {
  int32_t row[kMaxZeroRows];
};

// validator rows of one vote plane a slide block rolls: about one 4-byte
// word a thread, at least one row, at most the plane's N
int rows_per_slide_block(int N, int S) {
  int per = 4 * kThreads / S;
  if (per > N) per = N;
  return per < 1 ? 1 : per;
}

// blocks a member's slide takes: its three slot-axis rows, then the row
// groups of the prepare and of the commit plane
int slide_blocks(int N, int per) { return 3 + 2 * ((N + per - 1) / per); }

// block blockIdx.y's run of member m's slide by d > 0
__device__ __forceinline__ void slide_block(const qc::Planes& p, int m,
                                            int d, int N, int S, int C,
                                            int per) {
  const int y = static_cast<int>(blockIdx.y);
  uint8_t* run;
  int len;
  if (y < 3) {
    uint8_t* leaf = y == 0 ? p.pp : (y == 1 ? p.ordered : p.acked);
    run = leaf + static_cast<size_t>(m) * S;
    len = S;
  } else {
    const int groups = (N + per - 1) / per;
    const int g = (y - 3) % groups;
    const int r0 = g * per;
    const int nr = N - r0 < per ? N - r0 : per;
    uint8_t* plane = y - 3 < groups ? p.pv : p.cv;
    run = plane + (static_cast<size_t>(m) * N + r0) * S;
    len = nr * S;
  }
  qc::slide_run(run, len, S, d);
  if (y == 0) qc::slide_tail(p, m, d, N, C);
}

__global__ void __launch_bounds__(kThreads)
    slide_kernel(qc::Planes p, const int32_t* __restrict__ deltas, int N,
                 int S, int C, int per) {
  const int m = blockIdx.x;
  const int d = deltas[m];
  if (d <= 0) return;
  slide_block(p, m, d, N, S, C, per);
}

__global__ void __launch_bounds__(kThreads)
    slide_pairs_kernel(qc::Planes p, const __grid_constant__ SlidePairs pairs,
                       int N, int S, int C, int per) {
  slide_block(p, pairs.row[blockIdx.x], pairs.delta[blockIdx.x], N, S, C,
              per);
}

// bytes of a member's six runs laid end to end
long long member_bytes(int N, int S, int C) {
  return 3LL * S + 2LL * N * S + static_cast<long long>(N) * C;
}

// block blockIdx.y's chunk of member m's zero: the part of each run that
// falls in [y kZeroChunk, (y + 1) kZeroChunk) of the runs laid end to end
__device__ __forceinline__ void zero_block(const qc::Planes& p, int m, int N,
                                           int S, int C) {
  const long long ms = static_cast<long long>(m) * S;
  const long long mns = static_cast<long long>(m) * N * S;
  const long long ns = static_cast<long long>(N) * S;
  uint8_t* runs[6] = {p.pp + ms, p.ordered + ms, p.acked + ms, p.pv + mns,
                      p.cv + mns, p.ck + static_cast<long long>(m) * N * C};
  const long long lens[6] = {S, S, S, ns, ns, static_cast<long long>(N) * C};
  const long long lo = static_cast<long long>(blockIdx.y) * kZeroChunk;
  const long long hi = lo + kZeroChunk;
  long long at = 0;  // the first byte of run i, end to end
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const long long a = lo > at ? lo : at;
    const long long b = hi < at + lens[i] ? hi : at + lens[i];
    if (a < b) qc::zero_run(runs[i] + (a - at), static_cast<int>(b - a));
    at += lens[i];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) p.frontier[m] = 0;
}

__global__ void __launch_bounds__(kThreads)
    zero_kernel(qc::Planes p, const uint8_t* __restrict__ mask, int N, int S,
                int C) {
  const int m = blockIdx.x;
  if (!mask[m]) return;
  zero_block(p, m, N, S, C);
}

__global__ void __launch_bounds__(kThreads)
    zero_rows_kernel(qc::Planes p, const __grid_constant__ ZeroRows rows,
                     int N, int S, int C) {
  zero_block(p, rows.row[blockIdx.x], N, S, C);
}

// chunks of a member's zero, or 0 when the grid would be too tall
int zero_chunks(int N, int S, int C) {
  const long long chunks =
      (member_bytes(N, S, C) + kZeroChunk - 1) / kZeroChunk;
  return chunks < 1 ? 1 : (chunks > 65535 ? 0 : static_cast<int>(chunks));
}

bool window_shape_ok(int N, int S, int C) {
  return S > 0 && N >= 0 && C >= 0;
}

// the slide's row groups a member, or 0 when the grid would be too tall
int slide_grid_y(int N, int S) {
  const int blocks = slide_blocks(N, rows_per_slide_block(N, S));
  return blocks > 65535 ? 0 : blocks;
}

}  // namespace

extern "C" int window_slide_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* deltas, int M, int N, int S, int C,
    void* stream) {
  if (!window_shape_ok(N, S, C) || slide_grid_y(N, S) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    const int per = rows_per_slide_block(N, S);
    slide_kernel<<<dim3(M, slide_blocks(N, per)), kThreads, 0,
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
  if (!window_shape_ok(N, S, C) || slide_grid_y(N, S) == 0 ||
      n_pairs < 1 || n_pairs > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in = static_cast<const int32_t*>(pairs);
  SlidePairs t;
  for (int i = 0; i < n_pairs; ++i) {
    t.row[i] = in[2 * i];
    t.delta[i] = in[2 * i + 1];
  }
  const int per = rows_per_slide_block(N, S);
  slide_pairs_kernel<<<dim3(n_pairs, slide_blocks(N, per)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      qc::planes(pp, pv, cv, ck, ordered, acked, frontier), t, N, S, C, per);
  return static_cast<int>(cudaGetLastError());
}

// ``mask``: (M,) uint8 on the card, nonzero for a member to reset
extern "C" int window_zero_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* mask, int M, int N, int S, int C,
    void* stream) {
  const int chunks = zero_chunks(N, S, C);
  if (!window_shape_ok(N, S, C) || chunks == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    zero_kernel<<<dim3(M, chunks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
        static_cast<const uint8_t*>(mask), N, S, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// ``rows``: host int32 rows of the members to reset, each a member of the
// state; 1 <= n_rows <= kMaxZeroRows
extern "C" int window_zero_rows_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* rows, int n_rows, int N, int S, int C,
    void* stream) {
  const int chunks = zero_chunks(N, S, C);
  if (!window_shape_ok(N, S, C) || chunks == 0 || n_rows < 1 ||
      n_rows > kMaxZeroRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* in = static_cast<const int32_t*>(rows);
  ZeroRows t;
  for (int i = 0; i < n_rows; ++i) t.row[i] = in[i];
  zero_rows_kernel<<<dim3(n_rows, chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      qc::planes(pp, pv, cv, ck, ordered, acked, frontier), t, N, S, C);
  return static_cast<int>(cudaGetLastError());
}
