// decode_mha's CUDA-core fold on int4 head-major caches (KV_U4) with an f32
// recent window (deferred KV: decode_attention_deferred), up to D 128: the
// general instances of decode_fold.cuh's kernel (decode_mha.cuh), a library
// of their own so that nvcc compiles them in parallel. Its other entry
// points take nothing (the tensor-core fold and the per-head form are in
// decode_mha_u4.cu).

#define RTEN_FOLD_FAST 0
#define RTEN_HEADS 0
#define RTEN_FOLD_TC 0
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_U4, uint8_t, 64) M(KV_U4, uint8_t, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
