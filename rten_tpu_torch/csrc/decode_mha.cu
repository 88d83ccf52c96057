// decode_mha for Hopper (sm_90a): attention of S query rows per serving
// slot over head-major KV caches [B, Hkv, cap, D], either s8 with
// per-position scales [B, Hkv, cap] f32, or f32 or bf16 with no scales
// (bf16 in decode_mha_bf16.cu, a translation unit of its own so that nvcc
// builds it in parallel with this one; both instantiate decode_mha.cuh).
//
// Query row s of slot b, head h, sits at position lens[b] + s and reads KV
// head h / (H / Hkv) (heads are kv-major, as in the TPU kernel's GQA
// fold). It attends columns j with j <= lens[b] + s, j < cap and, when
// window > 0, j > lens[b] + s - window. A row with no such column gives 0.
// The K scale multiplies the score and the V scale the probability, as on
// the TPU: s = (q . k_int) * scale * ks[j], out = sum_j p_j vs[j] v_int[j]
// / sum_j p_j. K, V and the scales are addressed through strides, so the
// same code reads the head-major layout here and could read cat rows.
//
// Two launch forms; the wrapper (kernels/flash_attention.py, decode_mha)
// routes by rows per KV head: the fold when group * S <= 16 (a decode
// step, S == 1, of any model with group <= 16), per head otherwise (an
// admission, S = the bucket).
//
// 1. decode_mha_fold_kernel replaces rten_tpu/kernels/flash_attention.py:772
//    _decode_mha_folded (the S <= 8 pallas_call that folds every head of a
//    slot into one grid step).
//    Bound on the H100: bytes. A decode step reads each live KV row once
//    (2 * lens * Hkv * D bytes per slot, plus scales) and does 4 * group
//    flops per byte of an s8 row.
//    Design (decode_fold.cuh, shared with paged_decode_mha.cu): one
//    128-thread block per (slot, kv head) holds the group * S query rows
//    that share the head and reads each K/V row once for all of them (at
//    TinyLlama's 32 / 4 heads, eight rows read one stream); four warps
//    split the 32-key tiles of the live range. With 64 blocks at slots 16
//    the card is far from full and a call is latency-bound; split-K across
//    blocks is later work.
//
// 2. decode_mha_heads_kernel replaces rten_tpu/kernels/flash_attention.py:935
//    decode_mha (the per-(slot, head, key block) pallas_call for larger S).
//    Bound on the H100: operations at admission sizes (4 * S * keys * D
//    flops per head against S * D * 8 + keys * D bytes).
//    Design: one 128-thread block per (32-row query tile, head, slot). The
//    key loop runs inside the block up to lens[b] + the tile's last row,
//    with K/V tiles converted to f32 in shared memory beside their scales;
//    four threads share a query row (scores for BK / 4 columns each, then
//    D / 4 output dims each), and the online softmax runs in registers.
//    For D = 128 the key tile is 16 columns, keeping static shared memory
//    at 35 KB (< 48 KB).
//
// bf16 values widen to f32 exactly as they are loaded (8 a 16-byte load in
// the fold, one a thread in the per-head form's tile fill); every product
// and sum is f32.
//
// f32 on CUDA cores; tensor cores, split-K across blocks and cp.async are
// later work. Built without --use_fast_math (IEEE expf and division), like
// the other kernels of the port.

#include "decode_mha.cuh"

extern "C" int rten_decode_mha_folded(int kind, RTEN_DECODE_MHA_PARAMS) {
  switch (kind) {
    case KV_S8: return launch_decode_mha_folded<int8_t>(RTEN_DECODE_MHA_NAMES);
    case KV_F32: return launch_decode_mha_folded<float>(RTEN_DECODE_MHA_NAMES);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rten_decode_mha_heads(int kind, RTEN_DECODE_MHA_PARAMS) {
  switch (kind) {
    case KV_S8: return launch_decode_mha_heads<int8_t>(RTEN_DECODE_MHA_NAMES);
    case KV_F32: return launch_decode_mha_heads<float>(RTEN_DECODE_MHA_NAMES);
    default: return (int)cudaErrorInvalidValue;
  }
}
