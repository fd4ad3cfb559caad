// The member x validator quorum fabric step (K13), on one device: two
// kernels launched in stream order.
//
// Replaces (JAX reference): indy_plenum_tpu/tpu/quorum.py:306
// `step_compact_local` as compile_plan.py:201-245's shard_map step runs
// it on every (member block, validator block) tile of the fabric mesh, and
// quorum.py:402 `make_sharded_step` (one plane, no compact record): per
// tile, `_scatter_local` (:145-173) of the senders in the tile's validator
// row block, the local column counts, their `psum` over the validator axis
// (:186-190), then `_quorum_events` + `compact_from_events` (:248-281).
//
// One device holds every tile: the group's state is ONE member-stacked
// VoteState whose N validator rows are padded to a multiple of v, so tile
// j of member m is rows [j V, (j+1) V), V = N / v. Member blocks need no
// code here - members are independent planes - so the grid only cuts the
// validator axis.
//   (a) fabric_tile_kernel, grid (M, v): block (m, j) decodes member m's
//       words, stores the hits whose sender lies in its row block (the
//       PRE-PREPARE, per slot and not per validator, by tile 0 only),
//       then writes the tile's int32 partial prepare and commit counts
//       (M, v, S) and checkpoint counts (M, v, C). A block touches only
//       its own rows, so blocks need no synchronisation with each other.
//   (b) fabric_decide_kernel, grid M: block m sums its v partials (the
//       reference's psum; the stream order after (a) is the grid-wide
//       barrier) and runs quorum_common.cuh's decide_member, the decide +
//       compact + frontier path K7 and K9 run too, with thresholds from
//       the REAL validator count (pad rows receive only what a sender
//       addresses to them, as in the reference).
// ``ok`` (nullable) is the per-word verdict operand of the sharded fused
// step (tpu/step.py, replacing indy_plenum_tpu/tpu/step.py:46
// `make_sharded_fused_step`); on one device the reference's all_gather of
// the verdicts is the identity. ``compact`` 0 leaves prepared_acked and
// the frontier as they are (make_sharded_step's full-events step).
//
// What bounds it on an H100: bytes. At the fabric bench's size (M = N =
// 256, S = 300, C = 4, v = 2, W = 512 words) the planes are 39 MB, read
// once for the partial counts; the partials are 1.2 MB written by (a) and
// read by (b); the events ~1.2 MB. About 12 us of HBM time; the words'
// decode is a few instructions per word.
//
// Design: (a) gives every tile its own block, so v tiles of one member run
// on v SMs and a block reads only V rows per slot column; threads walk
// slots, so each row read is coalesced (neighbouring threads,
// neighbouring slots). (b) keeps K7's one block per member, and its
// decide is K7's code, so K7, K9 and K13 decide alike bit for bit. Known
// later work: the tiled K9's one-launch cluster kernel
// (resident_tile.cu: partials in distributed shared memory, no round trip
// through HBM) at k = 1 with the ``ok`` operand.
#include "quorum_common.cuh"

namespace {

__global__ void fabric_tile_kernel(qc::Planes p,
                                   const uint32_t* __restrict__ words,
                                   const uint8_t* __restrict__ ok, int N,
                                   int S, int C, int W, int v,
                                   int32_t* __restrict__ pc_part,
                                   int32_t* __restrict__ cc_part,
                                   int32_t* __restrict__ kc_part) {
  const int m = blockIdx.x;
  const int j = blockIdx.y;
  const int nv = N / v;
  const size_t mw = static_cast<size_t>(m) * W;
  qc::scatter_member_rows(p, m, words + mw,
                          ok != nullptr ? ok + mw : nullptr, N, S, C, W,
                          j * nv, nv, 0, S, j == 0, true);
  __syncthreads();
  qc::tile_partials(p, m, j, v, j * nv, nv, N, S, C, pc_part, cc_part,
                    kc_part);
}

__global__ void fabric_decide_kernel(qc::Planes p,
                                     const int32_t* __restrict__ pc_part,
                                     const int32_t* __restrict__ cc_part,
                                     const int32_t* __restrict__ kc_part,
                                     int v, int S, int C, int n_validators,
                                     int cap, int compact, qc::Events e) {
  __shared__ uint8_t f_newprep[qc::kMaxSlots];
  __shared__ uint8_t f_newly[qc::kMaxSlots];
  __shared__ uint8_t f_ordered[qc::kMaxSlots];
  const int m = blockIdx.x;
  const size_t row0 = static_cast<size_t>(m) * v;
  qc::decide_member(
      p, e, m, S, C, n_validators, cap, compact,
      [&](int s, int* pc, int* cc) {
        int a = 0, b = 0;
        for (int j = 0; j < v; ++j) {
          a += pc_part[(row0 + j) * S + s];
          b += cc_part[(row0 + j) * S + s];
        }
        *pc = a;
        *cc = b;
      },
      [&](int c) {
        int k = 0;
        for (int j = 0; j < v; ++j) k += kc_part[(row0 + j) * C + c];
        return k;
      },
      f_newprep, f_newly, f_ordered);
}

// one block per member sums the v tile partials and decides
int fabric_decide(const qc::Planes& p, const qc::Events& e,
                  const int32_t* pc_part, const int32_t* cc_part,
                  const int32_t* kc_part, int M, int v, int S, int C,
                  int n_validators, int cap, int compact,
                  cudaStream_t stream) {
  if (M > 0) {
    fabric_decide_kernel<<<M, qc::kThreads, 0, stream>>>(
        p, pc_part, cc_part, kc_part, v, S, C, n_validators, cap, compact,
        e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fabric_step_launch(
    void* pp, void* pv, void* cv, void* ck, void* ordered, void* acked,
    void* frontier, const void* words, const void* ok, int M, int N, int S,
    int C, int W, int v, int n_validators, int cap, int compact,
    void* pc_part, void* cc_part, void* kc_part, void* out, void* stream) {
  if (S <= 0 || S > qc::kMaxSlots || v < 1 || N % v != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const qc::Planes p = qc::planes(pp, pv, cv, ck, ordered, acked, frontier);
  if (M > 0) {
    fabric_tile_kernel<<<dim3(M, v), qc::kThreads, 0, st>>>(
        p, static_cast<const uint32_t*>(words),
        static_cast<const uint8_t*>(ok), N, S, C, W, v,
        static_cast<int32_t*>(pc_part), static_cast<int32_t*>(cc_part),
        static_cast<int32_t*>(kc_part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return fabric_decide(
      p, qc::events_at(out, M, S, C, cap),
      static_cast<const int32_t*>(pc_part),
      static_cast<const int32_t*>(cc_part),
      static_cast<const int32_t*>(kc_part), M, v, S, C, n_validators, cap,
      compact, st);
}
