// paged_decode_mha on bf16 block pools (no scales): the same fold as
// paged_decode_mha.cu (decode_fold.cuh), which says what it replaces and how
// it is designed, built as a library of its own so that nvcc compiles it in
// parallel with paged_decode_mha.cu. The entry point takes only KV_BF16.

#include "decode_fold.cuh"

extern "C" int rten_paged_decode_mha(int kind, RTEN_PAGED_PARAMS) {
  if (kind != KV_BF16) return (int)cudaErrorInvalidValue;
  return launch_paged_decode_mha<__nv_bfloat16>(RTEN_PAGED_NAMES);
}
