// K12's forms, for utils/sha256_fixed_probe.py: the kernel of ../sha256.cu
// (each thread's words from aligned 32-bit loads of its row, the next
// block's in flight, padding word-wise, unrolled rounds) in its other
// round and load forms and at any block size, beside the forms it was
// measured against: the block's rows staged into shared memory by
// coalesced 16-byte loads and the words read from there, and the form it
// replaced (one byte load a padded byte behind a test of the position
// against msg_len). Built on its own by the probe from the library's
// helpers (fixed_row, fixed_load, fixed_join, fixed_pad), never into the
// port's library, which holds sha256_fixed_kernel only.
#include "../sha256.cu"

namespace {

// the replaced kernel, as it was: FIPS 180-4 padding built per byte
__global__ void sha256_fixed_bytes_kernel(const uint8_t* __restrict__ msg,
                                          uint8_t* __restrict__ out,
                                          int batch, int msg_len) {
  int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  const uint8_t* m = msg + static_cast<size_t>(item) * msg_len;
  const int n_blocks = (msg_len + 9 + 63) / 64;
  const int total = n_blocks * 64;
  const uint64_t bitlen = static_cast<uint64_t>(msg_len) * 8;
  uint32_t st[8];
  init_state(st);
  for (int blk = 0; blk < n_blocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int p = blk * 64 + 4 * i + j;
        uint32_t byte;
        if (p < msg_len) {
          byte = m[p];
        } else if (p == msg_len) {
          byte = 0x80;
        } else if (p >= total - 8) {
          byte = static_cast<uint32_t>(
              (bitlen >> (8 * (total - 1 - p))) & 0xFF);
        } else {
          byte = 0;
        }
        word = (word << 8) | byte;
      }
      w[i] = word;
    }
    compress(st, w);
  }
  store_words(out + static_cast<size_t>(item) * 32, st);
}

constexpr int kFixedMaxThreads = 256;

inline bool fixed_threads_ok(int threads) {
  return threads >= 32 && threads <= kFixedMaxThreads && threads % 32 == 0;
}

template <bool Rolled>
__device__ __forceinline__ void fixed_compress(uint32_t st[8],
                                               uint32_t w[16]) {
  if (Rolled) {
    compress_rolled(st, w);
  } else {
    compress(st, w);
  }
}

// The words loaded from the row, as sha256_fixed_kernel loads them, with
// rolled or unrolled rounds and with or without block b + 1's words in
// flight during block b's rounds: <false, true> is the library's kernel
// at any block size.
template <bool Rolled, bool Pipelined>
__global__ void __launch_bounds__(kFixedMaxThreads)
    sha256_fixed_words_kernel(const uint8_t* __restrict__ msg,
                              uint8_t* __restrict__ out, int batch,
                              int msg_len) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= batch) return;
  int s;
  uint32_t sel;
  const uint32_t* g = fixed_row(msg, item, msg_len, s, sel);
  const int n_blocks = (msg_len + 9 + 63) / 64;
  const uint64_t bitlen = static_cast<uint64_t>(msg_len) * 8;
  uint32_t st[8];
  init_state(st);
  uint32_t lo[16], hi[16];
  fixed_load(g, s, msg_len, 0, lo, hi);
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t w[16];
    fixed_join(lo, hi, sel, msg_len, n_blocks, bitlen, b, w);
    if (Pipelined && b + 1 < n_blocks) {
      fixed_load(g, s, msg_len, b + 1, lo, hi);
    }
    fixed_compress<Rolled>(st, w);
    if (!Pipelined && b + 1 < n_blocks) {
      fixed_load(g, s, msg_len, b + 1, lo, hi);
    }
  }
  store_words(out + static_cast<size_t>(item) * 32, st);
}

template <bool Rolled, bool Pipelined>
int fixed_launch(const void* msg, void* out, int batch, int msg_len,
                 int threads, cudaStream_t stream) {
  if (!fixed_threads_ok(threads) || msg_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    sha256_fixed_words_kernel<Rolled, Pipelined>
        <<<(batch + threads - 1) / threads, threads, 0, stream>>>(
            static_cast<const uint8_t*>(msg), static_cast<uint8_t*>(out),
            batch, msg_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged form. A block's rows are one contiguous span of blockDim x L
// bytes: the block stages it into shared memory a round of
// ``round_blocks`` message blocks at a time (every row's bytes of those
// blocks), with coalesced 16-byte loads of the aligned chunks that cover
// each row's part, then each thread builds its big-endian words from two
// aligned 32-bit shared reads joined by __byte_perm at the row's byte
// offset. A chunk is read whole (a 16-byte aligned load never leaves the
// page of a byte it holds); its bytes outside the row only meet the
// padding masks. A row's stage is 4 x (4 x round_blocks + 1) + 1 words:
// the chunks of any offset, and an odd word stride so that the 32 rows of
// a warp read 32 banks. Words past the message are never read from the
// stage (a round with no message byte stages nothing). ``Pipelined``
// builds block b + 1's words before block b's rounds run.
__device__ __forceinline__ uint32_t fixed_word(const uint32_t* row, int a,
                                               uint32_t sel, int q) {
  return fixed_pad(q > 0 ? __byte_perm(row[a], row[a + 1], sel) : 0u, q);
}

// block b's 16 words, from the row's stage (a0: the stage word that holds
// the round's first byte of this row; b0: the round's first block)
__device__ __forceinline__ void fixed_block(const uint32_t* row, int a0,
                                           uint32_t sel, int msg_len,
                                           int n_blocks, uint64_t bitlen,
                                           int b, int b0, uint32_t w[16]) {
  const int a = a0 + 16 * (b - b0);
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = fixed_word(row, a + i, sel,
                                                 msg_len - 64 * b - 4 * i);
  if (b == n_blocks - 1) {
    w[14] = static_cast<uint32_t>(bitlen >> 32);
    w[15] = static_cast<uint32_t>(bitlen);
  }
}

constexpr int kFixedStageBytes = 48 * 1024;  // no opt-in needed

// a row's stage, in 32-bit words, at ``round_blocks`` blocks a round
__host__ __device__ constexpr int fixed_row_words(int round_blocks) {
  return 4 * (4 * round_blocks + 1) + 1;
}

template <bool Rolled, bool Pipelined>
__global__ void __launch_bounds__(kFixedMaxThreads)
    sha256_fixed_staged_kernel(const uint8_t* __restrict__ msg,
                               uint8_t* __restrict__ out, int batch,
                               int msg_len, int round_blocks) {
  extern __shared__ uint32_t stage[];
  const int row_words = fixed_row_words(round_blocks);
  const int first = blockIdx.x * blockDim.x;
  const int rows = min(static_cast<int>(blockDim.x), batch - first);
  const int item = first + threadIdx.x;
  const bool live = item < batch;
  const int n_blocks = (msg_len + 9 + 63) / 64;
  const uint64_t bitlen = static_cast<uint64_t>(msg_len) * 8;
  const int chunks = 4 * round_blocks + 1;  // a row's chunks, at most
  const uint32_t* row = stage + threadIdx.x * row_words;
  const uintptr_t own =
      reinterpret_cast<uintptr_t>(msg) + static_cast<size_t>(item) * msg_len;
  const uint32_t s = static_cast<uint32_t>(own & 3);
  const uint32_t sel =
      ((s + 3) | ((s + 2) << 4) | ((s + 1) << 8) | (s << 12)) & 0xFFFFu;
  uint32_t st[8];
  init_state(st);
  for (int b0 = 0; b0 < n_blocks; b0 += round_blocks) {
    const int b1 = min(b0 + round_blocks, n_blocks);
    const int lo = 64 * b0;
    const int hi = min(64 * b1, msg_len);
    if (hi > lo) {  // uniform: this round holds message bytes
      if (b0 > 0) __syncthreads();  // the last round's reads first
      for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
        const int r = i / chunks;
        const int c = i - r * chunks;
        const uintptr_t start = reinterpret_cast<uintptr_t>(msg) +
                                static_cast<size_t>(first + r) * msg_len;
        const uintptr_t at = ((start + lo) & ~uintptr_t(15)) + 16 * c;
        if (at < start + hi) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(at));
          uint32_t* dst = stage + r * row_words + 4 * c;
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        }
      }
      __syncthreads();
    }
    if (!live) continue;
    const int a0 = static_cast<int>((own + lo) & 15) >> 2;
    uint32_t w[16];
    fixed_block(row, a0, sel, msg_len, n_blocks, bitlen, b0, b0, w);
    for (int b = b0; b < b1; ++b) {
      if (Pipelined) {
        uint32_t next[16];
        if (b + 1 < b1) {
          fixed_block(row, a0, sel, msg_len, n_blocks, bitlen, b + 1, b0,
                      next);
        }
        fixed_compress<Rolled>(st, w);
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = next[i];
      } else {
        fixed_compress<Rolled>(st, w);
        if (b + 1 < b1) {
          fixed_block(row, a0, sel, msg_len, n_blocks, bitlen, b + 1, b0,
                      w);
        }
      }
    }
  }
  if (live) store_words(out + static_cast<size_t>(item) * 32, st);
}


// The blocks of a round for ``threads`` rows of msg_len bytes: every
// block that holds message bytes, as far as the stage fits
// kFixedStageBytes; *smem gets the stage's bytes.
inline int fixed_round_blocks(int msg_len, int threads, size_t* smem) {
  const int with_bytes = (msg_len + 63) / 64;
  int g = with_bytes > 0 ? with_bytes : 1;
  while (g > 1 && static_cast<size_t>(threads) * fixed_row_words(g) * 4 >
                      static_cast<size_t>(kFixedStageBytes)) {
    --g;
  }
  *smem = static_cast<size_t>(threads) * fixed_row_words(g) * 4;
  return g;
}


template <bool Rolled, bool Pipelined>
int staged_launch(const void* msg, void* out, int batch, int msg_len,
                  int threads, cudaStream_t stream) {
  if (!fixed_threads_ok(threads) || msg_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    size_t smem = 0;
    const int g = fixed_round_blocks(msg_len, threads, &smem);
    sha256_fixed_staged_kernel<Rolled, Pipelined>
        <<<(batch + threads - 1) / threads, threads, smem, stream>>>(
            static_cast<const uint8_t*>(msg), static_cast<uint8_t*>(out),
            batch, msg_len, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: 0 the replaced byte kernel; staged words: 1 unrolled rounds, 2
// rolled rounds, 3 rolled with the next block in flight, 4 unrolled with
// the next block in flight; words loaded straight from the row: 5
// unrolled, 6 rolled, 7 unrolled with the next block in flight (the
// library's kernel), 8 rolled with the next block in flight
extern "C" int sha256_fixed_variant_launch(const void* msg, void* out,
                                           int batch, int msg_len,
                                           int threads, int form,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      if (!fixed_threads_ok(threads)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (batch > 0) {
        sha256_fixed_bytes_kernel<<<(batch + threads - 1) / threads,
                                    threads, 0, s>>>(
            static_cast<const uint8_t*>(msg), static_cast<uint8_t*>(out),
            batch, msg_len);
      }
      return static_cast<int>(cudaGetLastError());
    case 1:
      return staged_launch<false, false>(msg, out, batch, msg_len, threads,
                                         s);
    case 2:
      return staged_launch<true, false>(msg, out, batch, msg_len, threads,
                                        s);
    case 3:
      return staged_launch<true, true>(msg, out, batch, msg_len, threads, s);
    case 4:
      return staged_launch<false, true>(msg, out, batch, msg_len, threads,
                                        s);
    case 5:
      return fixed_launch<false, false>(msg, out, batch, msg_len, threads,
                                        s);
    case 6:
      return fixed_launch<true, false>(msg, out, batch, msg_len, threads, s);
    case 7:
      return fixed_launch<false, true>(msg, out, batch, msg_len, threads, s);
    case 8:
      return fixed_launch<true, true>(msg, out, batch, msg_len, threads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
