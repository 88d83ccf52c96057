// decode_mha's two launch forms on bf16 head-major caches [B, Hkv, cap, D]
// (no scales): the same kernels as decode_mha.cu (decode_mha.cuh), which
// says what they replace and how they are designed, built as a library of
// their own so that nvcc compiles them in parallel with decode_mha.cu. The
// entry points take only KV_BF16.

#include "decode_mha.cuh"

extern "C" int rten_decode_mha_folded(int kind, RTEN_DECODE_MHA_PARAMS) {
  if (kind != KV_BF16) return (int)cudaErrorInvalidValue;
  return launch_decode_mha_folded<__nv_bfloat16>(RTEN_DECODE_MHA_NAMES);
}

extern "C" int rten_decode_mha_heads(int kind, RTEN_DECODE_MHA_PARAMS) {
  if (kind != KV_BF16) return (int)cudaErrorInvalidValue;
  return launch_decode_mha_heads<__nv_bfloat16>(RTEN_DECODE_MHA_NAMES);
}
