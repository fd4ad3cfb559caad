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
//      to max(frontier - d, 0); then words[k][m] decoded and scattered
//      (quorum_common.cuh scatter_word, a word a thread);
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
// compacts the member and writes the frontier snapshot. In one state no
// partial count reaches device memory. A one-block cluster (B = 1)
// decides from its own shared memory behind block barriers: no cluster
// barrier (~0.5 us each).
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
// tensors on its own device) runs the same consume as v launches a member
// block, one a tile, and no other kernel: the reference's psum over the
// validator axis (indy_plenum_tpu/tpu/quorum.py:182-186) followed by its
// decide.
//   - the partials mode (``Out``), on each non-home tile (i, j > 0): the
//     launch slides and scatters its V validator rows [row0, row0 + V) (a
//     word's sender is global; the planes' bases are moved back by row0
//     rows so it indexes them), counts them, sums its B blocks over
//     distributed shared memory, and stores the tile's (M, S) prepare and
//     commit and (M, C) checkpoint partials straight into its slot of a
//     (v - 1, M, 2S + C) int32 buffer on the block's HOME card: a peer
//     store over NVLink from another card, a local store on one. It holds
//     no slot-axis row: no PRE-PREPARE, no slide of preprepare_seen,
//     ordered, prepared_acked or the frontier.
//   - the home form, on the home tile (i, 0), launched after every
//     non-home launch of the step (tpu/quorum.py tiles_step orders it
//     with events where the streams differ): K13's or the tiled K9's body
//     on the tile's own rows, whose sums add the ``n_parts`` stored
//     partials to the cluster's own counts, then the decide and the
//     compact record as K13 does. At n_parts = 0 it is K13 or the tiled
//     K9 on the tile. An optional verdict operand ``ok`` ((M, W) bytes; K
//     = 1) drops the words whose signature failed in either form (the
//     split K14).
// What bounds each form: bytes, but at phase H's (4, 2) tile (R = 64, V =
// 128, S = 300: ~5 MB of planes, under 2 us of HBM time) a launch's
// latency and the cluster's two barriers cost more. The design keeps the
// pair to v launches a block and no copy: the partials cross to the home
// once, in the non-home launch's own stores (4 (2S + C) bytes a member),
// and the decide runs inside the home's launch, spread over its cluster's
// B blocks (a chunk of slots each) instead of one block a member in a
// launch of its own.
#include <cooperative_groups.h>

#include "quorum_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlocks = 8;  // the portable cluster size

// ``Step`` instantiates K13 and the home form without slides (one slot,
// no slide); the resident step's (K9, the tiled K9) takes k slots and
// their slides. ``Out`` is the partials mode (the header): ``part`` its
// destination. Otherwise ``part`` holds the ``n_parts`` other tiles'
// partials ((n_parts, M, 2S + C), read only) that the sums add.
template <bool Step, bool Out>
__global__ void __launch_bounds__(qc::kThreads)
    resident_tile_kernel(qc::Planes p, const int32_t* __restrict__ slides,
                         const uint32_t* __restrict__ words,
                         const uint8_t* __restrict__ ok, int K, int M,
                         int N, int S, int C, int W, int n_validators,
                         int cap, int compact, int row0, qc::Events e,
                         int32_t* __restrict__ part, int n_parts) {
  // this block's partial counts, then the member's flags (block 0's are
  // the ones written)
  extern __shared__ int32_t counts[];
  int32_t* pc_s = counts;
  int32_t* cc_s = counts + S;
  int32_t* kc_s = counts + 2 * S;
  uint8_t* f_newprep = reinterpret_cast<uint8_t*>(counts + 2 * S + C);
  uint8_t* f_newly = f_newprep + S;
  uint8_t* f_ordered = f_newly + S;
  cg::cluster_group cluster = cg::this_cluster();
  const int B = static_cast<int>(gridDim.x);  // the cluster spans x
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = blockIdx.y;
  const int r_lo = rank * N / B;
  const int nr = (rank + 1) * N / B - r_lo;
  // block 0 of a deciding launch owns the slot-axis rows; a partials
  // launch (a non-home tile) holds none
  const bool lead = !Out && rank == 0;
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
    // separates may land in any order: no barrier between them. The
    // tile's rows are the validators [row0, row0 + N): the bases move
    // back row0 rows so a word's global sender indexes them (no byte
    // outside the tile's own rows is stored)
    qc::MemberPlanes mp = qc::member_planes(p, m, N, S, C);
    mp.pv -= static_cast<size_t>(row0) * S;
    mp.cv -= static_cast<size_t>(row0) * S;
    mp.ck -= static_cast<size_t>(row0) * C;
    const uint32_t* wm = words + km * W;
    const uint8_t* okm = ok == nullptr ? nullptr : ok + km * W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      if (okm != nullptr && okm[j] == 0) continue;
      qc::scatter_word(mp, wm[j], S, C, row0 + r_lo, nr, 0, S, lead, true);
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
  // one tile's partials: (M, S) prepare, (M, S) commit, (M, C)
  // checkpoint counts, one after another
  const size_t plane = static_cast<size_t>(M) * S;
  const size_t tile = static_cast<size_t>(M) * (2 * S + C);
  const size_t mc = 2 * plane + static_cast<size_t>(m) * C;
  if constexpr (Out) {
    // the tile's partials into its slot on the home card
    if (B == 1) {
      __syncthreads();  // every count in before it is written out
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        part[ms + s] = pc_s[s];
        part[plane + ms + s] = cc_s[s];
      }
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        part[mc + c] = kc_s[c];
      }
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
      part[ms + s] = a;
      part[plane + ms + s] = b;
    }
    if (rank == 0) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        int kc = 0;
        for (int r = 0; r < B; ++r) kc += cluster.map_shared_rank(kc_s, r)[c];
        part[mc + c] = kc;
      }
    }
    cluster.sync();  // every partial read before any block exits
    return;
  }
  // the other tiles' stored counts at ``at`` of a partials layout (none
  // outside the home form)
  const int32_t* others = part;
  auto stored = [&](size_t at) {
    int x = 0;
    for (int t = 0; t < n_parts; ++t) x += others[t * tile + at];
    return x;
  };
  if (B == 1) {
    // one block a member: its counts are the cluster's, and a block
    // barrier orders what the cluster barriers order below
    __syncthreads();
    qc::decide_slots(
        p, e, m, S, 0, S, n_validators, compact,
        [&](int s, int* pc, int* cc) {
          *pc = pc_s[s] + stored(ms + s);
          *cc = cc_s[s] + stored(plane + ms + s);
        },
        f_newprep, f_newly, f_ordered);
    qc::decide_checkpoints(e, m, C, n_validators,
                           [&](int c) { return kc_s[c] + stored(mc + c); });
    __syncthreads();
    qc::compact_member(p, e, m, S, cap, compact, f_newprep, f_newly,
                       f_ordered);
    return;
  }
  // every block's counts (and block 0's slides and PRE-PREPAREs) before
  // any block reads them
  cluster.sync();
  const int chunk = ((S + B - 1) / B + 3) & ~3;
  const int lo = rank * chunk;
  const int s_lo = lo < S ? lo : S;
  const int s_hi = s_lo + chunk < S ? s_lo + chunk : S;
  qc::decide_slots(
      p, e, m, S, s_lo, s_hi, n_validators, compact,
      [&](int s, int* pc, int* cc) {
        int a = stored(ms + s), b = stored(plane + ms + s);
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
      int kc = stored(mc + c);
      for (int r = 0; r < B; ++r) kc += cluster.map_shared_rank(kc_s, r)[c];
      return kc;
    });
  }
  // every flag written, and every count read, before block 0 compacts
  // and any block exits
  cluster.sync();
  if (lead) {
    qc::compact_member(p, e, m, S, cap, compact, f_newprep, f_newly,
                       f_ordered);
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
// ``part`` takes the tile's partials in the partials mode (``Out``);
// otherwise it holds ``n_parts`` stored partials to add, and ``out``
// takes the events.
template <bool Step, bool Out>
int launch(void* pp, void* pv, void* cv, void* ck, void* ordered,
           void* acked, void* frontier, const void* slides, const void* words,
           const void* ok, int K, int M, int N, int S, int C, int W, int v,
           int blocks, int n_validators, int cap, int compact, int row0,
           void* out, void* part, int n_parts, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || K < 0 || C < 0 || v < 1 || N < 1 ||
      N % v != 0 || blocks < 1 || blocks > kMaxBlocks || blocks > N ||
      M > 65535 || row0 < 0 || n_parts < 0 || (Step && K != 1) ||
      (ok != nullptr && !Step) ||
      (part == nullptr && (Out || n_parts > 0))) {
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
      compact, row0, e, static_cast<int32_t*>(part), n_parts);
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
                              blocks, n_validators, cap, 1, 0, out, nullptr,
                              0, stream);
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
                             blocks, n_validators, cap, compact, 0, out,
                             nullptr, 0, stream);
}

// The partials mode on a non-home tile of the per-tile layout: the
// tile's N validator rows are [row0, row0 + N). Without ``slides`` it is
// K13's form (K = 1, no slide; ``ok`` the optional (M, W) verdict bytes),
// with them the tiled K9's (K slots). ``part``: the tile's (M, 2S + C)
// int32 partials, prepare then commit then checkpoint counts, on this
// card or on a peer card (the block's home).
extern "C" int resident_partials_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, const void* ok,
    int K, int M, int N, int S, int C, int W, int row0, int blocks,
    void* part, void* stream) {
  if (slides == nullptr) {
    return launch<true, true>(pp, pv, cv, ck, ordered, acked, frontier,
                              nullptr, words, ok, K, M, N, S, C, W, 1,
                              blocks, 1, 1, 1, row0, nullptr, part, 0,
                              stream);
  }
  return launch<false, true>(pp, pv, cv, ck, ordered, acked, frontier,
                             slides, words, ok, K, M, N, S, C, W, 1, blocks,
                             1, 1, 1, row0, nullptr, part, 0, stream);
}

// The home form on a block's home tile (its validator rows are [0, N)):
// K13's body without ``slides`` (K = 1; ``ok`` the optional verdict
// bytes; ``compact`` as K13's), the tiled K9's with them, the counts
// summed with the ``n_parts`` partials at ``parts`` ((n_parts, M, 2S + C)
// int32 on this card, stored by the block's other tiles), then the
// decide and the compact record into ``out``.
extern "C" int resident_home_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* slides, const void* words, const void* ok,
    int K, int M, int N, int S, int C, int W, int blocks, int n_validators,
    int cap, int compact, const void* parts, int n_parts, void* out,
    void* stream) {
  void* in = const_cast<void*>(parts);
  if (slides == nullptr) {
    return launch<true, false>(pp, pv, cv, ck, ordered, acked, frontier,
                               nullptr, words, ok, K, M, N, S, C, W, 1,
                               blocks, n_validators, cap, compact, 0, out,
                               in, n_parts, stream);
  }
  return launch<false, false>(pp, pv, cv, ck, ordered, acked, frontier,
                              slides, words, ok, K, M, N, S, C, W, 1, blocks,
                              n_validators, cap, compact, 0, out, in,
                              n_parts, stream);
}
