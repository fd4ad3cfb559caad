// The resident step (K9 at one validator tile, the tiled K9 at v tiles)
// and the member x validator fabric step (K13): k ring slots (K13: one)
// consumed over the fabric's tiles, one launch a consume, a thread-block
// cluster a member.
//
// Replaces (JAX reference):
//   - K9: indy_plenum_tpu/tpu/compile_plan.py:100 `resident_plan_for`,
//     its unsharded body (:119-130): the tiled K9 below at v = 1;
//   - the tiled K9: indy_plenum_tpu/tpu/compile_plan.py:141-173,
//     `resident_plan_for`'s mesh branches: per slot, `slide_state` by the
//     slot's deltas, then every tile's `_scatter_local` of its senders;
//     then the tiles' column counts, their `psum` over the validator axis,
//     and ONE `_quorum_events` + `compact_from_events` with the compact
//     deltas;
//   - K13: indy_plenum_tpu/tpu/quorum.py:306 `step_compact_local` as
//     compile_plan.py:201-245's shard_map step runs it on every (member
//     block, validator block) tile, and quorum.py:402 `make_sharded_step`
//     (one plane, full events, no compact record): the same consume at
//     k = 1 with no slide and a ``compact`` flag (0: prepared_acked and
//     the frontier stay).
// On one card every tile lives in one member-stacked VoteState whose N
// validator rows are padded to a multiple of v; the tiles' counts sum to
// the counts over all N rows, so the result does not depend on v, and v
// is only checked (N % v == 0). Thresholds come from the REAL validator
// count: pad rows receive only what a sender addresses to them.
//
// Per member m, in the reference's order (slot by slot, slide then
// scatter; a vote staged before a slide is rolled with the window):
//   1. for each slot k: d = slides[k][m] (no slides: 0); when d > 0 every
//      slot-axis row is rolled left by d with the vacated columns zeroed
//      (d >= S clears), the checkpoint votes cleared and the frontier set
//      to max(frontier - d, 0); then words[k][m] decoded and scattered,
//      (quorum_common.cuh scatter_member_rows);
//   2. the prepare, commit and checkpoint column counts over all N rows;
//   3. the decide K7, K9 and K13 share (decide_slots, decide_checkpoints,
//      compact_member).
//
// Design: a cluster of B <= 8 blocks (the portable cluster size; the
// wrapper picks B) owns member m. Block b owns
// the validator rows [b N / B, (b + 1) N / B): their prepare, commit and
// checkpoint rows, and it alone slides and scatters them; block 0 also
// owns the member's preprepare_seen / ordered / prepared_acked rows, the
// PRE-PREPAREs and the frontier. So the k slot passes need no cluster
// barrier: a block's slides and scatters touch only its own bytes, and
// __syncthreads orders slide before scatter and one slot before the next.
// After the last slot each block counts its rows over every slot, a
// 4-slot word a load with two byte sums packed in each 32-bit lane
// (quorum_common.cuh chunk_counts), into its own shared memory (2S + C
// int32). cluster.sync(); then block b sums the B partials of the slots
// of its chunk (a multiple of 4 slots, as K7's) over distributed shared
// memory, decides them and writes their flags into block 0's shared
// memory; block 0 also decides the checkpoints. cluster.sync(); block 0
// compacts the member and writes the frontier snapshot. No partial count
// reaches device memory. A one-block cluster (B = 1) decides from its own
// shared memory behind block barriers: no cluster barrier (~0.5 us each).
//
// The slide is quorum_common.cuh's slide_run: a block's row run of a plane
// moved a 4-byte word at a time.
//
// What bounds it on an H100: bytes. Phase H's consume (M = N = 256, S =
// 300, C = 3, W = 512, k = 4, no slide) reads the planes once for the
// counts (39 MB) and the words, and writes the hits, the events and the
// compact record: ~12 us of HBM time; K13 at that shape (k = 1) the same
// less three slots of words. K9 at phase F1's consume (M = N = 64, S =
// 300, W = 128, k = 4) moves ~2.9 MB, under 1 us, so there a launch's
// latency and the cluster's two barriers are the real cost.
//
// The per-tile layout (tpu/quorum.py TileState: every tile its own
// tensors on its own device) runs the same consume in two kernels:
//   - the partials mode (``Out``): one tile's launch slides and scatters
//     its V validator rows [row0, row0 + V) (a word's sender is global;
//     the planes' bases are moved back by row0 rows so it indexes them),
//     counts them, and writes the tile's (M, S) prepare and commit and
//     (M, C) checkpoint partials to device memory instead of deciding.
//     Only the block's home tile (``home``) holds the slot-axis rows: it
//     alone stores PRE-PREPAREs and slides preprepare_seen, ordered,
//     prepared_acked and the frontier. An optional verdict operand ``ok``
//     ((M, W) bytes; K = 1) drops the words whose signature failed (the
//     split K14);
//   - decide_partials_kernel, on the home tile's device: the v tiles'
//     partials (copied there) summed and decided by decide_slots,
//     decide_checkpoints and compact_member, one block a member. It is
//     the reference's psum over the validator axis
//     (indy_plenum_tpu/tpu/quorum.py:183-186) followed by its decide.
// Both are bound by bytes: a tile's launch moves its own share of the
// consume's bytes plus its partials (4 (2S + C) bytes a member), the
// decide the v partials and the events and compact record.
#include <cooperative_groups.h>

#include "quorum_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlocks = 8;  // the portable cluster size

// ``Step`` instantiates K13 (one slot, no slide, ``compact`` read at run
// time); the resident step's (K9, the tiled K9) fixes compact at 1.
// ``Out`` is the per-tile layout's partials mode (the header): ``ok``,
// ``row0``, ``home`` and ``part`` are read only there.
template <bool Step, bool Out>
__global__ void __launch_bounds__(qc::kThreads)
    resident_tile_kernel(qc::Planes p, const int32_t* __restrict__ slides,
                         const uint32_t* __restrict__ words,
                         const uint8_t* __restrict__ ok, int K, int M,
                         int N, int S, int C, int W, int n_validators,
                         int cap, int compact, int row0, int home,
                         qc::Events e, int32_t* __restrict__ part_out) {
  // this block's partial counts, then the member's flags (block 0's are
  // the ones written)
  extern __shared__ int32_t part[];
  int32_t* pc_s = part;
  int32_t* cc_s = part + S;
  int32_t* kc_s = part + 2 * S;
  uint8_t* f_newprep = reinterpret_cast<uint8_t*>(part + 2 * S + C);
  uint8_t* f_newly = f_newprep + S;
  uint8_t* f_ordered = f_newly + S;
  cg::cluster_group cluster = cg::this_cluster();
  const int B = static_cast<int>(gridDim.x);  // the cluster spans x
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = blockIdx.y;
  const int r_lo = rank * N / B;
  const int nr = (rank + 1) * N / B - r_lo;
  const bool lead = Out ? rank == 0 && home != 0 : rank == 0;
  const size_t ms = static_cast<size_t>(m) * S;
  for (int k = 0; k < K; ++k) {
    const size_t km = static_cast<size_t>(k) * M + m;
    const int d = Step ? 0 : slides[km];
    if (d > 0) {
      __syncthreads();  // the earlier slots' scatters before the slide
      const size_t run = (static_cast<size_t>(m) * N + r_lo) * S;
      qc::slide_run(p.pv + run, nr * S, S, d);
      qc::slide_run(p.cv + run, nr * S, S, d);
      if (lead) {
        qc::slide_run(p.pp + ms, S, S, d);
        qc::slide_run(p.ordered + ms, S, S, d);
        qc::slide_run(p.acked + ms, S, S, d);
      }
      uint8_t* ckm = p.ck + (static_cast<size_t>(m) * N + r_lo) * C;
      for (int i = threadIdx.x; i < nr * C; i += blockDim.x) ckm[i] = 0;
      if (lead && threadIdx.x == 0) {
        const int f = p.frontier[m] - d;
        p.frontier[m] = f > 0 ? f : 0;
      }
      __syncthreads();  // the slide before this slot's scatter
    }
    // the scatter stores 1s only, so the stores of slots that no slide
    // separates may land in any order: no barrier between them
    if constexpr (Out) {
      // the tile's rows are the validators [row0, row0 + N): the bases
      // move back row0 rows so a word's global sender indexes them (no
      // byte outside the tile's own rows is stored)
      qc::MemberPlanes mp = qc::member_planes(p, m, N, S, C);
      mp.pv -= static_cast<size_t>(row0) * S;
      mp.cv -= static_cast<size_t>(row0) * S;
      mp.ck -= static_cast<size_t>(row0) * C;
      const uint32_t* wm = words + km * W;
      const uint8_t* okm = ok == nullptr ? nullptr : ok + km * W;
      for (int j = threadIdx.x; j < W; j += blockDim.x) {
        if (okm != nullptr && okm[j] == 0) continue;
        qc::scatter_word(mp, wm[j], S, C, row0 + r_lo, nr, 0, S, lead,
                         true);
      }
    } else {
      qc::scatter_member_rows(p, m, words + km * W, N, S, C, W, r_lo, nr,
                              0, S, lead, true);
    }
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    pc_s[i] = 0;
    cc_s[i] = 0;
  }
  __syncthreads();  // every scatter, and the zeroed counts, before counting
  qc::chunk_counts(p, m, N, S, r_lo, nr, 0, S, pc_s, cc_s);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    kc_s[c] = qc::checkpoint_count(p, m, r_lo, nr, N, C, c);
  }
  if constexpr (Out) {
    // the tile's partials to device memory: (M, S) prepare, (M, S)
    // commit, (M, C) checkpoint counts, one after another
    int32_t* pc_o = part_out + ms;
    int32_t* cc_o = part_out + static_cast<size_t>(M) * S + ms;
    int32_t* kc_o = part_out + 2 * static_cast<size_t>(M) * S +
                    static_cast<size_t>(m) * C;
    if (B == 1) {
      __syncthreads();  // every count in before it is written out
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        pc_o[s] = pc_s[s];
        cc_o[s] = cc_s[s];
      }
      for (int c = threadIdx.x; c < C; c += blockDim.x) kc_o[c] = kc_s[c];
      return;
    }
    cluster.sync();  // every block's counts in before any is summed
    const int chunk = (S + B - 1) / B;
    const int s_lo = rank * chunk < S ? rank * chunk : S;
    const int s_hi = s_lo + chunk < S ? s_lo + chunk : S;
    for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
      int a = 0, b = 0;
      for (int r = 0; r < B; ++r) {
        a += cluster.map_shared_rank(pc_s, r)[s];
        b += cluster.map_shared_rank(cc_s, r)[s];
      }
      pc_o[s] = a;
      cc_o[s] = b;
    }
    if (rank == 0) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        int kc = 0;
        for (int r = 0; r < B; ++r) kc += cluster.map_shared_rank(kc_s, r)[c];
        kc_o[c] = kc;
      }
    }
    cluster.sync();  // every partial read before any block exits
    return;
  }
  if (B == 1) {
    // one block a member: its partials are the counts, and a block
    // barrier orders what the cluster barriers order below
    __syncthreads();
    qc::decide_slots(
        p, e, m, S, 0, S, n_validators, Step ? compact : 1,
        [&](int s, int* pc, int* cc) {
          *pc = pc_s[s];
          *cc = cc_s[s];
        },
        f_newprep, f_newly, f_ordered);
    qc::decide_checkpoints(e, m, C, n_validators,
                           [&](int c) { return kc_s[c]; });
    __syncthreads();
    qc::compact_member(p, e, m, S, cap, Step ? compact : 1, f_newprep,
                       f_newly, f_ordered);
    return;
  }
  // every block's partials (and block 0's slides and PRE-PREPAREs) before
  // any block reads them
  cluster.sync();
  const int chunk = ((S + B - 1) / B + 3) & ~3;
  const int lo = rank * chunk;
  const int s_lo = lo < S ? lo : S;
  const int s_hi = s_lo + chunk < S ? s_lo + chunk : S;
  qc::decide_slots(
      p, e, m, S, s_lo, s_hi, n_validators, Step ? compact : 1,
      [&](int s, int* pc, int* cc) {
        int a = 0, b = 0;
        for (int r = 0; r < B; ++r) {
          a += cluster.map_shared_rank(pc_s, r)[s];
          b += cluster.map_shared_rank(cc_s, r)[s];
        }
        *pc = a;
        *cc = b;
      },
      cluster.map_shared_rank(f_newprep, 0),
      cluster.map_shared_rank(f_newly, 0),
      cluster.map_shared_rank(f_ordered, 0));
  if (lead) {
    qc::decide_checkpoints(e, m, C, n_validators, [&](int c) {
      int kc = 0;
      for (int r = 0; r < B; ++r) kc += cluster.map_shared_rank(kc_s, r)[c];
      return kc;
    });
  }
  // every flag written, and every partial read, before block 0 compacts
  // and any block exits
  cluster.sync();
  if (lead) {
    qc::compact_member(p, e, m, S, cap, Step ? compact : 1, f_newprep,
                       f_newly, f_ordered);
  }
}

// the dynamic shared memory of a block: 2S + C int32 partials, 3S flags
size_t shared_bytes(int S, int C) {
  return 4 * static_cast<size_t>(2 * S + C) + 3 * static_cast<size_t>(S);
}

// above 48 KB a block's dynamic shared memory needs the kernel's opt-in
template <bool Step, bool Out = false>
cudaError_t allow_shared(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(resident_tile_kernel<Step, Out>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One launch of the kernel: a cluster of ``blocks`` blocks a member.
// ``part`` (the partials mode) takes the tile's partials; ``out`` the
// events otherwise.
template <bool Step, bool Out>
int launch(void* pp, void* pv, void* cv, void* ck, void* ordered,
           void* acked, void* frontier, const void* slides, const void* words,
           const void* ok, int K, int M, int N, int S, int C, int W, int v,
           int blocks, int n_validators, int cap, int compact, int row0,
           int home, void* out, void* part, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || K < 0 || C < 0 || v < 1 || N < 1 ||
      N % v != 0 || blocks < 1 || blocks > kMaxBlocks || blocks > N ||
      M > 65535 || row0 < 0 || (Step && K != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = shared_bytes(S, C);
  const cudaError_t opt = allow_shared<Step, Out>(smem);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, M, 1);
  cfg.blockDim = dim3(qc::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const qc::Events e =
      Out ? qc::Events{} : qc::events_at(out, M, S, C, cap);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, resident_tile_kernel<Step, Out>,
      qc::planes(pp, pv, cv, ck, ordered, acked, frontier),
      static_cast<const int32_t*>(slides),
      static_cast<const uint32_t*>(words),
      static_cast<const uint8_t*>(ok), K, M, N, S, C, W, n_validators, cap,
      compact, row0, home, e, static_cast<int32_t*>(part));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many blocks of the kernel (K13's instantiation when ``step``) one
// SM holds at S slots and C checkpoints (its registers and shared
// memory), into *blocks_per_sm: the wrapper sizes the cluster so that
// every member's blocks fit the card at once.
extern "C" int resident_tile_occupancy(int S, int C, int step,
                                       void* blocks_per_sm) {
  int n = 0;
  const size_t smem = shared_bytes(S, C);
  cudaError_t err =
      step ? allow_shared<true>(smem) : allow_shared<false>(smem);
  if (err == cudaSuccess) {
    err = step ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, resident_tile_kernel<true, false>, qc::kThreads,
                     smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, resident_tile_kernel<false, false>, qc::kThreads,
                     smem);
  }
  *static_cast<int*>(blocks_per_sm) = n;
  return static_cast<int>(err);
}

// K9 (v = 1) and the tiled K9: K slots, their (K, M) slides, the compact
// record.
extern "C" int resident_tile_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, int K, int M,
    int N, int S, int C, int W, int v, int blocks, int n_validators,
    int cap, void* out, void* stream) {
  return launch<false, false>(pp, pv, cv, ck, ordered, acked, frontier,
                              slides, words, nullptr, K, M, N, S, C, W, v,
                              blocks, n_validators, cap, 1, 0, 1, out,
                              nullptr, stream);
}

// K13: one slot, no slide; ``compact`` 0 leaves prepared_acked and the
// frontier as they are.
extern "C" int fabric_step_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* words, int M, int N, int S, int C, int W,
    int v, int blocks, int n_validators, int cap, int compact, void* out,
    void* stream) {
  return launch<true, false>(pp, pv, cv, ck, ordered, acked, frontier,
                             nullptr, words, nullptr, 1, M, N, S, C, W, v,
                             blocks, n_validators, cap, compact, 0, 1, out,
                             nullptr, stream);
}

// The partials mode on one tile of the per-tile layout: the tile's N
// validator rows are [row0, row0 + N); ``home`` when it is its block's
// home tile (the slot-axis rows). Without ``slides`` it is K13's form
// (K = 1, no slide; ``ok`` the optional (M, W) verdict bytes), with them
// the tiled K9's (K slots). ``part``: the tile's (M, 2S + C) int32
// partials, prepare then commit then checkpoint counts.
extern "C" int resident_partials_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, const void* ok,
    int K, int M, int N, int S, int C, int W, int row0, int home,
    int blocks, void* part, void* stream) {
  if (slides == nullptr) {
    return launch<true, true>(pp, pv, cv, ck, ordered, acked, frontier,
                              nullptr, words, ok, K, M, N, S, C, W, 1,
                              blocks, 1, 1, 1, row0, home, nullptr, part,
                              stream);
  }
  if (ok != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, true>(pp, pv, cv, ck, ordered, acked, frontier,
                             slides, words, nullptr, K, M, N, S, C, W, 1,
                             blocks, 1, 1, 1, row0, home, nullptr, part,
                             stream);
}

namespace {

constexpr int kMaxTiles = 16;  // validator tiles a decide sums, at most

struct PartialTable {
  const int32_t* part[kMaxTiles];
};

// The decide of the per-tile layout on a block's home tile: member m
// sums the v tiles' partials of every slot and checkpoint, then decides
// and compacts as K7, K9 and K13 do. One block a member.
__global__ void __launch_bounds__(qc::kThreads)
    decide_partials_kernel(qc::Planes p,
                           const __grid_constant__ PartialTable t, int v,
                           int M, int S, int C, int n_validators, int cap,
                           int compact, qc::Events e) {
  extern __shared__ uint8_t flags[];
  uint8_t* f_newprep = flags;
  uint8_t* f_newly = flags + S;
  uint8_t* f_ordered = flags + 2 * S;
  const int m = blockIdx.x;
  const size_t ms = static_cast<size_t>(m) * S;
  const size_t plane = static_cast<size_t>(M) * S;
  qc::decide_slots(
      p, e, m, S, 0, S, n_validators, compact,
      [&](int s, int* pc, int* cc) {
        int a = 0, b = 0;
        for (int r = 0; r < v; ++r) {
          a += t.part[r][ms + s];
          b += t.part[r][plane + ms + s];
        }
        *pc = a;
        *cc = b;
      },
      f_newprep, f_newly, f_ordered);
  qc::decide_checkpoints(e, m, C, n_validators, [&](int c) {
    int kc = 0;
    for (int r = 0; r < v; ++r) {
      kc += t.part[r][2 * plane + static_cast<size_t>(m) * C + c];
    }
    return kc;
  });
  __syncthreads();  // every flag before the compact
  qc::compact_member(p, e, m, S, cap, compact, f_newprep, f_newly,
                     f_ordered);
}

}  // namespace

// ``table``: host int64 pointers of the v partials ((M, 2S + C) int32
// each, on this device); the home tile's slot-axis leaves; the events and
// compact record into ``out`` (tpu/quorum.py _outputs' allocation).
extern "C" int decide_partials_launch(void* pp, void* ordered, void* acked,
                                      void* frontier, const void* table,
                                      int v, int M, int S, int C,
                                      int n_validators, int cap,
                                      int compact, void* out, void* stream) {
  if (v < 1 || v > kMaxTiles || S <= 0 || S > qc::kMaxSlots || C < 0 ||
      M < 0 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const long long* in = static_cast<const long long*>(table);
  PartialTable t = {};
  for (int r = 0; r < v; ++r) {
    t.part[r] = reinterpret_cast<const int32_t*>(in[r]);
  }
  decide_partials_kernel<<<M, qc::kThreads, 3 * static_cast<size_t>(S),
                           static_cast<cudaStream_t>(stream)>>>(
      qc::planes(pp, nullptr, nullptr, nullptr, ordered, acked, frontier),
      t, v, M, S, C, n_validators, cap, compact,
      qc::events_at(out, M, S, C, cap));
  return static_cast<int>(cudaGetLastError());
}
