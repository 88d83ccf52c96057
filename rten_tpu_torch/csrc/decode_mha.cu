// decode_mha for Hopper (sm_90a): attention of S query rows per serving
// slot over head-major KV caches [B, Hkv, cap, D], either s8 with
// per-position scales [B, Hkv, cap] f32, int4 (u8 [B, Hkv, cap, D/2], two
// split-half codes a byte, decode_fold.cuh) with the same scales, or f32 or
// bf16 with no scales. This library holds s8 at D <= 128; f32 is in
// decode_mha_f32.cu, bf16 in decode_mha_bf16.cu, int4 in decode_mha_u4.cu
// (its deferred folds and masked head dims in decode_mha_u4_win.cu) and
// every kind at D 129-512 in decode_mha_wide.cu (the folds),
// decode_mha_wide_heads.cu and decode_mha_wide_heads_f32.cu (the per-head
// form), translation units of their own so that nvcc builds them in
// parallel with this one; all instantiate decode_mha.cuh.
//
// Query row s of slot b, head h, sits at position lens[b] + s and reads KV
// head h / (H / Hkv) (heads are kv-major, as in the TPU kernel's GQA
// fold). It attends columns j with j <= lens[b] + s, j < cap and, when
// window > 0, j > lens[b] + s - window. A row with no such column gives 0.
// The K scale multiplies the score and the V scale the probability, as on
// the TPU: s = (q . k_int) * scale * ks[j], out = sum_j p_j vs[j] v_int[j]
// / sum_j p_j. K, V and the scales are addressed through strides, so the
// same code reads the head-major layout here and cat rows [B, cap, Hkv*D]
// (strides (cap*Hkv*D, D, Hkv*D)): the per-head form is also
// prefill_mha_cat's kernel (rten_tpu/kernels/flash_attention.py:3301
// prefill_mha_cat, whose function is decode_mha's on those views).
//
// Two launch forms; the wrapper (kernels/flash_attention.py, decode_mha)
// routes by rows per KV head: the fold when group * S <= 16 (a decode
// step, S == 1, of any model with group <= 16), per head otherwise (an
// admission, S = the bucket).
//
// 1. The fold replaces rten_tpu/kernels/flash_attention.py:772
//    _decode_mha_folded (the S <= 8 pallas_call that folds every head of a
//    slot into one grid step).
//    Bound on the H100: bytes. A decode step reads each live KV row once
//    (2 * lens * Hkv * D bytes per slot, plus scales; half that for int4)
//    and does 4 * group flops per byte of an s8 row.
//    Deferred KV (decode_attention_deferred, the reference's
//    decode_mha(recent_k=...) with k_new): the fold also attends a recent
//    window of the dispatch's rows (f32 or bf16) after the cache's rows
//    strictly below lens0, writing the step's new row into the window
//    first.
//    Design: a block per (slot, kv head, split of its columns) holds the
//    group * S query rows that share the kv head and reads each K/V row
//    once for all of them; the wrapper's decode_split_plan cuts the
//    columns so that a 16-slot step fills the card (4 splits at
//    TinyLlama's 16 x 4 heads), the last block of a (slot, kv head)
//    merging the splits' states in split order. Two kernels; the
//    wrapper's fold_form picks one:
//    a. decode_fold_tc_kernel (decode_fold_tc.cuh, which says how it is
//       designed): s8, int4 and bf16 caches at D <= 128 with no window or
//       a bf16 one, on tensor cores (keys on the M side, q and p * vs in
//       three bf16 parts, f32 accumulation).
//    b. decode_mha_fold_kernel (decode_fold.cuh): f32 caches, f32 windows
//       and D 129-512, on CUDA cores, its four warps taking 32-key tiles
//       staged by cp.async.
//
// 2. The per-head form replaces rten_tpu/kernels/flash_attention.py:935
//    decode_mha (the per-(slot, head, key block) pallas_call for larger S).
//    Three kernels, all on tensor cores; the wrapper's heads_plan names
//    the one a cache dtype and head dim take:
//    a. decode_mha_heads_tc_kernel (decode_heads_tc.cuh, which says how it
//       is designed): s8, int4 and bf16 caches at D <= 128 (bf16 mma.sync,
//       q and p * vs split into three bf16 parts, f32 accumulation).
//       Bound on the H100 at an admission: bytes (the f32 q and output).
//    b. decode_mha_heads_tf32_kernel (decode_heads_tf32.cuh): f32 caches at
//       D <= 128, in 3xTF32. Bound: bytes, as 2a.
//    c. decode_mha_heads_wide_kernel (decode_heads_wide.cuh): every kind at
//       D 129-512, the arithmetic of 2a (s8, int4, bf16) or 2b (f32), the
//       output dims split over the warps that share 16 query rows. Bound:
//       bytes, as 2a.
//
// Head dims: instances for DP = 64, 128 (here), 256 and 512 (decode_mha_wide.cu);
// any even D runs in the smallest instance that holds it, the dims past D
// zero in shared memory (a masked tail).
//
// In the CUDA-core fold, bf16 values widen to f32 exactly as they are
// loaded (8 a 16-byte load), int4 codes as they are unpacked (nibble - 8);
// every product and sum is f32. Built without --use_fast_math (IEEE expf
// and division), like the other kernels of the port.

// s8 without a window or with a bf16 one runs on tensor cores: the
// CUDA-core fold keeps only its general instances (f32 windows).
#define RTEN_FOLD_FAST 0
#include "decode_mha.cuh"

#define RTEN_CASES(M) M(KV_S8, int8_t, 64) M(KV_S8, int8_t, 128)
RTEN_DECODE_MHA_ENTRIES(RTEN_CASES)
