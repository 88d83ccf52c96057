// decode_mha's launch forms for one cache element type T and head-dim
// instance DP, shared by decode_mha.cu (s8 caches, D <= 128),
// decode_mha_f32.cu (f32, D <= 128), decode_mha_bf16.cu (bf16, D <= 128),
// decode_mha_u4.cu and decode_mha_u4_win.cu (int4, D <= 128),
// decode_mha_wide.cu (the folds of every kind at D 129-512) and
// decode_mha_wide_heads.cu / decode_mha_wide_heads_f32.cu (the per-head
// form at D 129-512), which nvcc builds in parallel: the fold on tensor
// cores (decode_fold_tc.cuh: s8, int4 and bf16 at D <= 128, no window or a
// bf16 one) and on CUDA cores (decode_fold.cuh: f32 caches, f32 windows,
// D 129-512), both split over blocks; the per-head form on tensor cores
// for every kind and head dim (decode_heads_tc.cuh: s8, int4 and bf16 at
// D <= 128; decode_heads_tf32.cuh: f32 at D <= 128, 3xTF32;
// decode_heads_wide.cuh: every kind at D 129-512). decode_mha.cu says what
// each form replaces and how it is designed.

#pragma once

#include <type_traits>

#include "decode_fold.cuh"
#include "decode_fold_tc.cuh"
#include "decode_heads_tc.cuh"
#include "decode_heads_tf32.cuh"
#include "decode_heads_wide.cuh"

// What a library holds (each source may set these before the include): the
// CUDA-core fold's instances with D fixed and no recent window
// (RTEN_FOLD_FAST), its general ones (RTEN_FOLD_GENERAL: a recent window, a
// masked tail; the only ones past DP 128), the tensor-core fold
// (RTEN_FOLD_TC: s8, int4 and bf16 up to DP 128), the per-head form
// (RTEN_HEADS: on tensor cores at every DP). An
// entry point asked for a form its library does not hold returns
// cudaErrorInvalidValue.
#ifndef RTEN_FOLD_FAST
#define RTEN_FOLD_FAST 1
#endif
#ifndef RTEN_FOLD_GENERAL
#define RTEN_FOLD_GENERAL 1
#endif
#ifndef RTEN_FOLD_TC
#define RTEN_FOLD_TC 1
#endif
#ifndef RTEN_HEADS
#define RTEN_HEADS 1
#endif

// The C entry points' parameters after the element kind, and their names:
// q [B, H, S, D] f32, the caches and scales through strides (elements;
// bytes for int4 rows), lens, out through strides; vec: 16-byte K loads in
// the fold; the recent window (deferred KV, the fold only): rk/rv through
// strides r_sb, r_sh, r_sj, W rows (0: none), wbf16 (bf16 rows, else f32),
// wvec, the step t [1] int32 on the device, and the new row kn/vn
// [B, Hkv, 1, D] f32 through strides n_sb, n_sh (null: none); the fold's
// split (splits, chunk, the workspace ws and counters count: SplitArgs;
// the per-head form reads none of them).
#define RTEN_DECODE_MHA_PARAMS                                                   \
  const void *q, long long q_sb, long long q_sh, long long q_ss, const void *k,  \
      const void *v, long long kv_sb, long long kv_sh, long long kv_sj,          \
      const void *ks, const void *vs, long long sc_sb, long long sc_sh,          \
      long long sc_sj, const void *lens, void *out, long long o_sb,              \
      long long o_sh, long long o_ss, int B, int H, int Hkv, int S, int D,       \
      int cap, int window, float scale, int vec, void *rk, void *rv,             \
      long long r_sb, long long r_sh, long long r_sj, int W, int wbf16,          \
      int wvec, const void *t, const void *kn, const void *vn, long long n_sb,   \
      long long n_sh, int splits, int chunk, void *ws, void *count, void *stream
#define RTEN_DECODE_MHA_NAMES                                                    \
  q, q_sb, q_sh, q_ss, k, v, kv_sb, kv_sh, kv_sj, ks, vs, sc_sb, sc_sh, sc_sj,   \
      lens, out, o_sb, o_sh, o_ss, B, H, Hkv, S, D, cap, window, scale, vec, rk, \
      rv, r_sb, r_sh, r_sj, W, wbf16, wvec, t, kn, vn, n_sb, n_sh, splits, chunk, \
      ws, count, stream

#define RTEN_KV_ARGS(TT)                                                         \
  (const float*)q, q_sb, q_sh, q_ss, (const TT*)k, (const TT*)v, kv_sb, kv_sh,   \
      kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj
#define RTEN_OUT_ARGS                                                            \
  (const int32_t*)lens, (float*)out, o_sb, o_sh, o_ss, H, Hkv, S, D, cap, window, \
      scale

#define RTEN_WINDOW                                                              \
  RecentWindow {                                                                 \
    rk, rv, r_sb, r_sh, r_sj, W, wbf16, wvec, (const int32_t*)t, (const float*)kn, \
        (const float*)vn, n_sb, n_sh                                             \
  }
#define RTEN_SPLIT SplitArgs{chunk, (float*)ws, (unsigned*)count}

template <typename T, int DP, int RR, bool WIN, bool EXACT>
cudaError_t launch_fold(RTEN_DECODE_MHA_PARAMS) {
  return launch_fold_kernel<DP, T, RR, false, WIN, EXACT, false>(
      dim3(B, Hkv, splits), (cudaStream_t)stream, RTEN_KV_ARGS(T), nullptr, 0, 0, RTEN_OUT_ARGS,
      vec, RTEN_WINDOW, RTEN_SPLIT, AppendArgs{});
}

template <typename T, int DP, bool WIN, bool EXACT>
cudaError_t launch_fold_rows(int rows, RTEN_DECODE_MHA_PARAMS) {
  if (rows == 1) return launch_fold<T, DP, 1, WIN, EXACT>(RTEN_DECODE_MHA_NAMES);
  if (rows <= 8) return launch_fold<T, DP, 8, WIN, EXACT>(RTEN_DECODE_MHA_NAMES);
  return launch_fold<T, DP, 16, WIN, EXACT>(RTEN_DECODE_MHA_NAMES);
}

// The CUDA-core fold at head-dim instance DP, split over blocks: group * S
// rows up to FoldRows<DP> (a one-row instance for the decode steps of
// models without GQA, such as GPT-2, whose 8-row instance would hold
// registers for rows it does not have). Up to DP 128 two kinds of
// instance: D == DP without a recent window (no window code, D fixed at
// compile time), and the general one (a recent window, a masked tail).
template <typename T, int DP>
int launch_decode_mha_folded(RTEN_DECODE_MHA_PARAMS) {
  const int rows = (H / Hkv) * S;
  if (rows < 1 || rows > FoldRows<DP>::value || rten_dp_of(D) != DP ||
      !rten_split_ok(splits, chunk, cap, ws, count))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (DP <= 128 && W == 0 && D == DP) {
    if constexpr (DP <= 128 && RTEN_FOLD_FAST)
      e = launch_fold_rows<T, DP, false, true>(rows, RTEN_DECODE_MHA_NAMES);
    else
      return (int)cudaErrorInvalidValue;
  } else if constexpr (RTEN_FOLD_GENERAL) {
    if constexpr (DP <= 128)
      e = launch_fold_rows<T, DP, true, false>(rows, RTEN_DECODE_MHA_NAMES);
    else
      e = launch_fold<T, DP, FoldRows<DP>::value, true, false>(RTEN_DECODE_MHA_NAMES);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return rten_launch_error(e);
}

// The tensor-core fold (decode_fold_tc.cuh): s8, int4 and bf16 caches at
// DP 64 and 128, group * S rows up to 16 (one 8-row n-tile, or two), no
// recent window or a bf16 one; any other call returns cudaErrorInvalidValue.
template <typename T, int DP>
int launch_decode_mha_folded_tc(RTEN_DECODE_MHA_PARAMS) {
  if constexpr (RTEN_FOLD_TC && DP <= 128 && !std::is_same<T, float>::value) {
    const int rows = (H / Hkv) * S;
    if (rows < 1 || rows > 16 || rten_dp_of(D) != DP || (W > 0 && !wbf16) ||
        !rten_split_ok(splits, chunk, cap, ws, count))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(B, Hkv, splits);
    const cudaError_t e =
        rows <= 8 ? launch_fold_tc_kernel<DP, T, 1>(grid, (cudaStream_t)stream, RTEN_KV_ARGS(T),
                                                    RTEN_OUT_ARGS, vec, RTEN_WINDOW, RTEN_SPLIT)
                  : launch_fold_tc_kernel<DP, T, 2>(grid, (cudaStream_t)stream, RTEN_KV_ARGS(T),
                                                    RTEN_OUT_ARGS, vec, RTEN_WINDOW, RTEN_SPLIT);
    return rten_launch_error(e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The per-head form on tensor cores: at DP 64 and 128 s8, int4 and bf16
// caches in bf16 parts (decode_heads_tc.cuh), f32 caches in 3xTF32
// (decode_heads_tf32.cuh); at DP 256 and 512 every kind
// (decode_heads_wide.cuh); an instance the library was not built for
// returns cudaErrorInvalidValue.
template <typename T, int DP>
int launch_decode_mha_heads_tc(RTEN_DECODE_MHA_PARAMS) {
  if constexpr (RTEN_HEADS) {
    if (S < 1 || rten_dp_of(D) != DP) return (int)cudaErrorInvalidValue;
    if constexpr (DP > 128) {
      using WT = WideTile<DP, T>;
      auto* kernel = decode_mha_heads_wide_kernel<DP, T>;
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WT::SMEM);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid(H, B, (S + WT::ROWS - 1) / WT::ROWS);
      kernel<<<grid, WD_THREADS, WT::SMEM, (cudaStream_t)stream>>>(RTEN_KV_ARGS(T),
                                                                   RTEN_OUT_ARGS, vec);
    } else if constexpr (std::is_same<T, float>::value) {
      const dim3 grid((S + TC_ROWS - 1) / TC_ROWS, H, B);
      constexpr int smem = Tf32Tile<DP>::SMEM;
      const cudaError_t e = cudaFuncSetAttribute(
          decode_mha_heads_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      decode_mha_heads_tf32_kernel<DP><<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)q, q_sb, q_sh, q_ss, (const float*)k, (const float*)v, kv_sb, kv_sh,
          kv_sj, RTEN_OUT_ARGS, vec);
    } else {
      const dim3 grid((S + TC_ROWS - 1) / TC_ROWS, H, B);
      auto* kernel = decode_mha_heads_tc_kernel<DP, T>;
      constexpr int smem = TcTile<DP, T>::SMEM;
      if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
      }
      kernel<<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(RTEN_KV_ARGS(T), RTEN_OUT_ARGS,
                                                               vec);
    }
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Defines the three C entry points of a library for the kinds it lists:
// RTEN_DECODE_MHA_ENTRIES(CASES) with CASES(M) expanding M(kind, T, DP) for
// every (kind, head-dim instance) the library was built for.
#define RTEN_DECODE_MHA_CASE(KIND, TT, DPP, FORM)                                \
  if (kind == KIND && dp == DPP) return launch_decode_mha_##FORM<TT, DPP>(RTEN_DECODE_MHA_NAMES);
#define RTEN_FOLDED_CASE(KIND, TT, DPP) RTEN_DECODE_MHA_CASE(KIND, TT, DPP, folded)
#define RTEN_FOLDED_TC_CASE(KIND, TT, DPP) RTEN_DECODE_MHA_CASE(KIND, TT, DPP, folded_tc)
#define RTEN_HEADS_TC_CASE(KIND, TT, DPP) RTEN_DECODE_MHA_CASE(KIND, TT, DPP, heads_tc)
#define RTEN_DECODE_MHA_ENTRIES(CASES_)                                          \
  RTEN_DECODE_MHA_ENTRY_OF(CASES_, folded, RTEN_FOLDED_CASE)                     \
  RTEN_DECODE_MHA_ENTRY_OF(CASES_, folded_tc, RTEN_FOLDED_TC_CASE)               \
  RTEN_DECODE_MHA_ENTRY_OF(CASES_, heads_tc, RTEN_HEADS_TC_CASE)
#define RTEN_DECODE_MHA_ENTRY_OF(CASES_, NAME, CASE)                             \
  extern "C" int rten_decode_mha_##NAME(int kind, RTEN_DECODE_MHA_PARAMS) {      \
    const int dp = rten_dp_of(D);                                                \
    CASES_(CASE)                                                                 \
    return (int)cudaErrorInvalidValue;                                           \
  }
