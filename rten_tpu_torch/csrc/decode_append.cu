// The split append for Hopper (sm_90a): one decode step (S == 1) that
// writes the step's new K/V row into the cache and attends it, with the
// group's query rows folded into one block and the slot's keys split over
// several blocks (decode_fold.cuh, decode_mha_fold_kernel's APPEND
// instances, which say how it is designed).
//
// Replaces rten_tpu/kernels/flash_attention.py:2597 decode_mha_append_cat
// (cat caches [B, cap, Hkv*D]) and :1442 decode_mha_append (head-major
// caches [B, Hkv, cap, D]), for every group and split count (GPT-2's
// headline, group 1 at 1440 units, runs its one-row instance at one split).
// Bound on the H100: bytes (each live K/V row read once, the new row and
// its scale written).
//
// This library holds s8 caches; f32 is in decode_append_f32.cu and bf16 in
// decode_append_bf16.cu, translation units of their own so that nvcc builds
// them in parallel. The entry point takes only KV_S8.

#include "decode_fold.cuh"

extern "C" int rten_decode_append_split(int kind, RTEN_APPEND_PARAMS) {
  if (kind != KV_S8) return (int)cudaErrorInvalidValue;
  return launch_decode_append<int8_t>(RTEN_APPEND_NAMES);
}
