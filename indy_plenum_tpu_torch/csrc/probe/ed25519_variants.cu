// K-c's launch variants, for utils/verify_lanes_probe.py and the card
// tests: the kernel of ../ed25519.cu at 2 or 4 lanes a signature, with its
// table of multiples of -A in shared or local memory. Built on its own by
// the probe, never into the port's library, whose entry point launches
// the main path's variant only.
#include "../ed25519.cu"

extern "C" int ed25519_verify_variant_launch(
    const void* pk, const void* rb, const void* sb, const void* hb,
    void* ok_out, const void* consts, int batch, int lanes,
    int shared_table, void* stream) {
  if (lanes != 2 && lanes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lanes == 4 && shared_table) {
      launch<4, true>(pk, rb, sb, hb, ok_out, consts, batch, s);
    } else if (lanes == 4) {
      launch<4, false>(pk, rb, sb, hb, ok_out, consts, batch, s);
    } else if (shared_table) {
      launch<2, true>(pk, rb, sb, hb, ok_out, consts, batch, s);
    } else {
      launch<2, false>(pk, rb, sb, hb, ok_out, consts, batch, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
