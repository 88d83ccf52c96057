// decode_mha's fold on int4 head-major caches (KV_U4) with a recent window
// (deferred KV: decode_attention_deferred) or at a head dim other than 64
// and 128, up to 128: the general instances of decode_mha_u4.cu's fold
// (decode_mha.cuh, decode_fold.cuh), a library of their own so that nvcc
// compiles them in parallel. Its per-head entry point takes nothing (that
// form is in decode_mha_u4.cu).

#define RTEN_FOLD_FAST 0
#define RTEN_HEADS 0
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_U4, uint8_t, 64) M(KV_U4, uint8_t, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
