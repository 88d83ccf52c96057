// paged_decode_mha on f32 block pools (no scales): the same fold as
// paged_decode_mha.cu (decode_fold.cuh), which says what it replaces and how
// it is designed, built as a library of its own so that nvcc compiles it in
// parallel with paged_decode_mha.cu. The entry point takes only KV_F32.

#include "decode_fold.cuh"

extern "C" int rten_paged_decode_mha(int kind, RTEN_PAGED_PARAMS) {
  if (kind != KV_F32) return (int)cudaErrorInvalidValue;
  return launch_paged_decode_mha<float>(RTEN_PAGED_NAMES);
}
