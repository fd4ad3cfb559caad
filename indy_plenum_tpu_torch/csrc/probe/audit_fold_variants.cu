// K10's compression variants, for utils/audit_fold_probe.py: the indexed
// kernel of ../sha256.cu with its node hash's compressions rolled (the
// library's) or fully unrolled (K11's form). Built on its own by the
// probe, never into the port's library, whose entry points launch the
// rolled kernel only.
#include "../sha256.cu"

extern "C" int audit_fold_variant_launch(
    const void* leaf, const void* index, const void* table,
    const void* path_idx, const void* path_len, const void* tree_size,
    const void* root, void* ok, int batch, int depth, int threads,
    int rolled, void* stream) {
  if (!fold_threads_ok(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    const auto kernel =
        rolled ? &audit_fold_kernel<true, true>
               : &audit_fold_kernel<false, true>;
    kernel<<<grid_for(batch, threads), threads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(leaf), static_cast<const int32_t*>(index),
        nullptr, static_cast<const uint8_t*>(table),
        static_cast<const int32_t*>(path_idx),
        static_cast<const int32_t*>(path_len),
        static_cast<const int32_t*>(tree_size),
        static_cast<const uint8_t*>(root), static_cast<uint8_t*>(ok), batch,
        depth);
  }
  return static_cast<int>(cudaGetLastError());
}
