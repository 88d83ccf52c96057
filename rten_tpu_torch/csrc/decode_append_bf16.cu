// The split append on bf16 caches (no scales): the same fold as
// decode_append.cu (decode_fold.cuh), which says what it replaces and how
// it is designed, built as a library of its own so that nvcc compiles it in
// parallel with decode_append.cu. The entry point takes only KV_BF16.

#include "decode_fold.cuh"

extern "C" int rten_decode_append_split(int kind, RTEN_APPEND_PARAMS) {
  if (kind != KV_BF16) return (int)cudaErrorInvalidValue;
  return launch_decode_append<__nv_bfloat16>(RTEN_APPEND_NAMES);
}
