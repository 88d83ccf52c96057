// The split append on f32 caches (no scales): the same fold as
// decode_append.cu (decode_fold.cuh), which says what it replaces and how
// it is designed, built as a library of its own so that nvcc compiles it in
// parallel with decode_append.cu. The entry point takes only KV_F32.

#include "decode_fold.cuh"

extern "C" int rten_decode_append_split(int kind, RTEN_APPEND_PARAMS) {
  if (kind != KV_F32) return (int)cudaErrorInvalidValue;
  return launch_decode_append<float>(RTEN_APPEND_NAMES);
}
