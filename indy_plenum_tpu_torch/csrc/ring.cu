// Member-plane migration on the fabric: the ring shift (K1) and the
// rotation's shard-local merge (K15). Both copy bytes, out of place, for
// every leaf of a member-stacked state in ONE launch over a table of
// leaves passed by value, so any dtype works (the uint8 planes, the int32
// frontier, float32 in the tests).
//
// Replaces (JAX reference):
// - K1: indy_plenum_tpu/tpu/ring_exchange.py:101, the repo's only
//   `pl.pallas_call` (`_ring_kernel` :67, `_pallas_ring_fn` :89,
//   `ring_shift_pallas` :118), behind the dispatcher `ring_shift_planes`
//   (:127) whose oracle is `ring_shift_reference` (:47, lax.ppermute):
//   member block b of every leaf moves to block (b + shift) mod m. The
//   TPU kernel RDMAs each device's block to its ring neighbour. In the
//   one-device layout every block lives in the same leaf, and the member
//   blocks are contiguous rows, so the shift is a rotation of each leaf's
//   bytes by shift x R x row_bytes: dst[(i + offset) mod total] = src[i].
//   Any shift and both mesh ranks (the validator tiles of a member block
//   move with it, inside its rows). In that layout the rotation of
//   ``rotate_planes`` is this kernel too, once, by ``rows`` rows
//   (tpu/ring_exchange.py ``ring_shift_rows``).
// - K15: indy_plenum_tpu/tpu/rebalance.py:207-221, `rotate_planes`' merge:
//   for rows = b R + s, two ring shifts (K1 by b and by b + 1) give arms A
//   and B; new row k R + r of shard k takes A's row k R + r - s when
//   r >= s, else B's row k R + r - s + R. Without a mesh the rotation is
//   this merge alone with m = 1 (A = B = the state, R = M): a roll of the
//   member axis. The one-device layout rolls instead (K1 above); the
//   per-tile layout runs the reference's shape: two K1 shifts of the tiles
//   (below), then this merge on every tile, on the tile's own device.
//
// K1's peer form (tpu/ring_exchange.py ``_peer_copy``): in the per-tile
// layout (tpu/quorum.py TileState) each tile is its own set of leaves on
// its own device, so a ring step moves tile (i, j) whole to tile
// ((i + shift) mod m, j). The move is this kernel at offset 0 (one linear
// segment a leaf), launched on the DESTINATION tile's device with its
// source pointers on the ring neighbour's device, read through peer
// access (enable_peer_access below) - the counterpart of the reference's
// RDMA to the neighbour. With every tile on one card the same launch gets
// local pointers.
//
// What bounds them on an H100: bytes. K1 reads and writes each leaf once:
// at the fabric bench's state (256 x 256 x 300 uint8 planes x 2, the
// checkpoint votes, three slot rows and the frontier) ~39.7 MB each way,
// ~79 MB, 24 us at 3.35 TB/s. At phase R's state (64 x 64 x 15, ~130 KB)
// a launch is bound by its latency instead. K15's merge moves the same
// bytes: it reads one arm's row for each row it writes.
//
// Design of K1: each leaf's rotation by ``offset`` granules is two linear
// copies, dst[offset:] <- src[:units - offset] and dst[:offset] <-
// src[units - offset:], with no wrap test on any element. Each leaf moves
// in the widest granule (16, 4 or 1 bytes) that divides its size, its
// offset and both addresses, so the big planes move as 16-byte vectors
// and the int32 frontier and odd-sized leaves still work. The segments of
// every leaf are cut into tiles of kRingThreads x kRingLoads granules;
// the grid is one row of blocks a segment, each block striding over its
// segment's tiles (at most kMaxBlocks a row, the longest segment's tiles
// spread evenly over them). A thread issues its kRingLoads loads
// (neighbouring threads on neighbouring addresses) before its stores,
// offsets 32-bit inside a tile, with streaming hints (__ldcs/__stcs:
// phase H's ~80 MB pass through the 50 MB L2 once). PERF.md has its
// times beside a flat grid's over all segments.
//
// K15 (the merge): a grid-stride copy, grid (blocks, leaves), in the same
// granules; it divides once per granule to find the row.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kMaxSegments = 2 * kMaxLeaves;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kRingThreads = 256;
constexpr int kRingLoads = 2;  // loads in flight a thread

// the segments of a rotation, each ``units`` granules of ``granule``
// bytes
struct RingTable {
  const uint8_t* src[kMaxSegments];
  uint8_t* dst[kMaxSegments];
  long long units[kMaxSegments];
  int granule[kMaxSegments];
  int n;
};

struct MergeTable {
  const uint8_t* a[kMaxLeaves];
  const uint8_t* b[kMaxLeaves];
  uint8_t* dst[kMaxLeaves];
  int row_units[kMaxLeaves];  // one member row in granules
  int granule[kMaxLeaves];
};

// tile ``tile`` of a segment of ``units`` granules
template <class T>
__device__ __forceinline__ void copy_tile(const T* __restrict__ src,
                                          T* __restrict__ dst,
                                          long long units, long long tile) {
  constexpr int kTile = kRingThreads * kRingLoads;
  const long long base = tile * kTile;
  const long long rest = units - base;
  const int left = rest < kTile ? static_cast<int>(rest) : kTile;
  src += base;
  dst += base;
  T v[kRingLoads];
#pragma unroll
  for (int j = 0; j < kRingLoads; ++j) {
    const int i = threadIdx.x + j * kRingThreads;
    if (i < left) v[j] = __ldcs(src + i);
  }
#pragma unroll
  for (int j = 0; j < kRingLoads; ++j) {
    const int i = threadIdx.x + j * kRingThreads;
    if (i < left) __stcs(dst + i, v[j]);
  }
}

template <class T>
__device__ __forceinline__ void copy_segment(const T* src, T* dst,
                                             long long units) {
  const long long tiles = (units + kRingThreads * kRingLoads - 1) /
                          (kRingThreads * kRingLoads);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    copy_tile(src, dst, units, tile);
  }
}

// row y of the grid copies segment y
__global__ void __launch_bounds__(kRingThreads)
    ring_shift_kernel(const __grid_constant__ RingTable t) {
  const int s = blockIdx.y;
  switch (t.granule[s]) {
    case 16:
      copy_segment(reinterpret_cast<const uint4*>(t.src[s]),
                   reinterpret_cast<uint4*>(t.dst[s]), t.units[s]);
      break;
    case 4:
      copy_segment(reinterpret_cast<const unsigned int*>(t.src[s]),
                   reinterpret_cast<unsigned int*>(t.dst[s]), t.units[s]);
      break;
    default:
      copy_segment(t.src[s], t.dst[s], t.units[s]);
  }
}

template <class T>
__device__ __forceinline__ void merge_leaf(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           T* __restrict__ dst, int rows,
                                           int row_units, int shard_rows,
                                           int s) {
  const long long units = static_cast<long long>(rows) * row_units;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < units; i += step) {
    const int g = static_cast<int>(i / row_units);
    const int col = static_cast<int>(i - static_cast<long long>(g) *
                                             row_units);
    const int r = g % shard_rows;
    const bool from_a = r >= s;
    const int src_row = g - r + (from_a ? r - s : r - s + shard_rows);
    const T* from = from_a ? a : b;
    dst[i] = from[static_cast<long long>(src_row) * row_units + col];
  }
}

__global__ void rotate_merge_kernel(MergeTable t, int rows, int shard_rows,
                                    int s) {
  const int l = blockIdx.y;
  switch (t.granule[l]) {
    case 16:
      merge_leaf(reinterpret_cast<const uint4*>(t.a[l]),
                 reinterpret_cast<const uint4*>(t.b[l]),
                 reinterpret_cast<uint4*>(t.dst[l]), rows, t.row_units[l],
                 shard_rows, s);
      break;
    case 4:
      merge_leaf(reinterpret_cast<const uint32_t*>(t.a[l]),
                 reinterpret_cast<const uint32_t*>(t.b[l]),
                 reinterpret_cast<uint32_t*>(t.dst[l]), rows,
                 t.row_units[l], shard_rows, s);
      break;
    default:
      merge_leaf(t.a[l], t.b[l], t.dst[l], rows, t.row_units[l], shard_rows,
                 s);
  }
}

// the widest of 16, 4 and 1 bytes that divides every value given
int granule_of(const long long* values, int n) {
  const int widths[2] = {16, 4};
  for (int g : widths) {
    bool fits = true;
    for (int i = 0; i < n; ++i) fits = fits && values[i] % g == 0;
    if (fits) return g;
  }
  return 1;
}

int blocks_for(long long most_units) {
  const long long b = (most_units + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// K1's blocks a row: the longest segment's tiles spread evenly over at
// most kMaxBlocks blocks, so each of its blocks walks the same count of
// tiles and none is left with one more at the end
int ring_blocks(long long most_units) {
  constexpr int kTile = kRingThreads * kRingLoads;
  const long long tiles = (most_units + kTile - 1) / kTile;
  const long long per_block = (tiles + kMaxBlocks - 1) / kMaxBlocks;
  return static_cast<int>(per_block < 1 ? 1
                                        : (tiles + per_block - 1) / per_block);
}

void add_segment(RingTable& t, const uint8_t* src, uint8_t* dst,
                 long long units, int granule) {
  if (units <= 0) return;
  t.src[t.n] = src;
  t.dst[t.n] = dst;
  t.units[t.n] = units;
  t.granule[t.n] = granule;
  ++t.n;
}

}  // namespace

// ``table``: host int64 triples (src, dst, row_bytes) per leaf, each leaf
// ``rows`` member rows of row_bytes; block b -> b + shift of m blocks of
// rows / m rows each is a rotation by shift_rows = shift x rows / m rows,
// and rotate_planes' roll by ``rows`` rows is shift_rows = rows.
extern "C" int ring_shift_launch(const void* table, int n_leaves, int rows,
                                 int shift_rows, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* in = static_cast<const long long*>(table);
  const int sr = ((shift_rows % rows) + rows) % rows;
  RingTable t = {};
  for (int l = 0; l < n_leaves; ++l) {
    const long long src = in[3 * l], dst = in[3 * l + 1];
    const long long row_bytes = in[3 * l + 2];
    const long long total = row_bytes * rows;
    const long long offset = row_bytes * sr;
    const long long vals[4] = {src, dst, total, offset};
    const int g = granule_of(vals, 4);
    const auto* s = reinterpret_cast<const uint8_t*>(src);
    auto* d = reinterpret_cast<uint8_t*>(dst);
    // dst[offset:] <- src[:total - offset]; dst[:offset] <- src[total -
    // offset:]
    add_segment(t, s, d + offset, (total - offset) / g, g);
    add_segment(t, s + (total - offset), d, offset / g, g);
  }
  if (t.n == 0) return static_cast<int>(cudaGetLastError());
  long long most = 0;
  for (int i = 0; i < t.n; ++i) most = t.units[i] > most ? t.units[i] : most;
  const dim3 grid(ring_blocks(most), t.n);
  ring_shift_kernel<<<grid, kRingThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// Let the current thread's kernels on device ``dev`` read device ``peer``'s
// memory (cudaDeviceEnablePeerAccess from ``dev``): 0, or the CUDA error.
// Access already enabled (by this call or by PyTorch's own peer copies)
// counts as done. The calling thread's current device is restored.
extern "C" int enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free "already" report
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// ``table``: host int64 quadruples (a, b, dst, row_bytes) per leaf, each
// leaf ``rows`` member rows in shards of ``shard_rows``; 0 < s < shard_rows.
extern "C" int rotate_merge_launch(const void* table, int n_leaves,
                                   int rows, int shard_rows, int s,
                                   void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || shard_rows < 1 ||
      rows % shard_rows != 0 || s < 1 || s >= shard_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* in = static_cast<const long long*>(table);
  MergeTable t = {};
  long long most = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long vals[4] = {in[4 * l], in[4 * l + 1], in[4 * l + 2],
                               in[4 * l + 3]};
    const int g = granule_of(vals, 4);
    t.a[l] = reinterpret_cast<const uint8_t*>(vals[0]);
    t.b[l] = reinterpret_cast<const uint8_t*>(vals[1]);
    t.dst[l] = reinterpret_cast<uint8_t*>(vals[2]);
    t.row_units[l] = static_cast<int>(vals[3] / g);
    t.granule[l] = g;
    const long long units = static_cast<long long>(rows) * t.row_units[l];
    most = units > most ? units : most;
  }
  rotate_merge_kernel<<<dim3(blocks_for(most), n_leaves), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, rows,
                                                             shard_rows, s);
  return static_cast<int>(cudaGetLastError());
}
