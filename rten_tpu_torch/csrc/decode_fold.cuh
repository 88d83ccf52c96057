// The fold form of decode attention, shared by decode_mha.cu and
// decode_mha_bf16.cu (slot-major caches), paged_decode_mha.cu and
// paged_decode_mha_bf16.cu (block pools read through a block table) and
// flash_attention.cu (the block-table append's attention over s8
// cat-layout pools: the same strides, rows of Hkv * D; over f32/bf16 cat
// pools the append attends through the paged entry point with those
// strides).
//
// One 128-thread block per (slot, kv head) holds the group * S query rows
// that share the head in shared memory and reads each K/V row once for all
// of them. Its four warps split the 32-key tiles of the live range
// [lo, min(lens + S - 1, cap - 1)] and stop there; a lane scores one key
// against every row (16-byte vector loads of its K row), the warp reduces
// each row's tile max and sum with shuffles, each lane accumulates D / 32
// output dims of P.V for every row (the V values of 4 or 8 keys loaded
// together, so their latencies overlap), and the warps' online-softmax
// states merge in shared memory.
//
// Query row s of slot b, head h, sits at position lens[b] + s and reads KV
// head h / (H / Hkv) (kv-major GQA). It attends columns j with
// j <= lens[b] + s, j < cap and, when window > 0, j > lens[b] + s - window.
// A row with no such column gives 0. The K scale multiplies the score and
// the V scale the probability: s = (q . k_int) * scale * ks[j],
// out = sum_j p_j vs[j] v_int[j] / sum_j p_j.
//
// Cache elements T: s8 codes with per-position f32 scales, or f32 or bf16
// values read as they are (no scales; the K scale is 1).
//
// Addressing (all strides in elements):
// * PAGED = false: row j of slot b, kv head hk at kc + b * kv_sb + hk * kv_sh
//   + j * kv_sj, its scale at ks[b * sc_sb + hk * sc_sh + j * sc_sj].
// * PAGED = true: the pools hold blocks of BS rows and slot b's position j
//   lives in block blk = bt[b * MB + j / BS], row r = j % BS: the K row at
//   kc + blk * kv_sb + hk * kv_sh + r * kv_sj, its scale at
//   ks[blk * sc_sb + hk * sc_sh + r * sc_sj]; cap = MB * BS. Each lane
//   resolves the table entry of its own key (the row is in L1 after the
//   first lane), and the P.V loop takes key u's row offset from lane u by a
//   shuffle, so no address is computed twice.
// Built without --use_fast_math (IEEE expf and division).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The cache element types, by the code the wrappers pass
// (kernels/flash_attention.py, KV_KINDS).
enum KvKind { KV_S8 = 0, KV_F32 = 1, KV_BF16 = 2 };

// Expands M(T) for the element type of ``kind``; any other kind returns
// cudaErrorInvalidValue from the enclosing entry point.
#define RTEN_BY_KIND(kind, M)                                                    \
  switch (kind) {                                                                \
    case KV_S8: M(int8_t); break;                                                \
    case KV_F32: M(float); break;                                                \
    case KV_BF16: M(__nv_bfloat16); break;                                       \
    default: return (int)cudaErrorInvalidValue;                                  \
  }

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A value as an f32 or bf16 cache element; bf16 rounds to nearest, ties to
// even, as jnp.astype(bfloat16) and torch's .to(torch.bfloat16) do.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// 16 bytes of a cache row as floats: 16 s8, 4 f32 or 8 bf16 values.
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 w = *reinterpret_cast<const int4*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int u = 0; u < 16; ++u) out[u] = (float)e[u];
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(e[u]);
    out[2 * u] = f.x;
    out[2 * u + 1] = f.y;
  }
}

constexpr int FOLD_WARPS = 4;

template <int D, typename T, int MAXR, bool PAGED>
__global__ void __launch_bounds__(FOLD_WARPS * 32) decode_mha_fold_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc,
    long long kv_sb, long long kv_sh, long long kv_sj,
    const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj,
    const int32_t* __restrict__ bt, int MB, int BS,
    const int32_t* __restrict__ lens, float* __restrict__ out,
    long long o_sb, long long o_sh, long long o_ss,
    int H, int Hkv, int S, int cap, int window, float scale) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int DPL = D / 32;          // output dims per lane
  // V keys whose loads are in flight together (fewer when the
  // accumulators already take most of the registers).
  constexpr int VB = MAXR * DPL >= 64 ? 4 : 8;
  __shared__ float q_s[MAXR][D];
  __shared__ float part_m[FOLD_WARPS][MAXR], part_l[FOLD_WARPS][MAXR];
  __shared__ float part_acc[FOLD_WARPS][MAXR][D];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = H / Hkv;
  const int R = group * S;  // row r = g * S + s: head hk * group + g, position lens[b] + s
  const int len = lens[b];
  const int hi = min(len + S - 1, cap - 1);  // the slot's last live column
  const int lo = window > 0 ? max(0, len - window + 1) : 0;
  const long long slot_kv = PAGED ? 0 : b * kv_sb;
  const T* kb = kc + slot_kv + hk * kv_sh;
  const T* vb = vc + slot_kv + hk * kv_sh;
  const long long sc_base = (PAGED ? 0 : b * sc_sb) + hk * sc_sh;

  for (int idx = tid; idx < MAXR * D; idx += FOLD_WARPS * 32) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < R) {
      const int g = r / S, s = r % S;
      x = q[b * q_sb + (long long)(hk * group + g) * q_sh + s * q_ss + d];
    }
    q_s[r][d] = x;
  }
  __syncthreads();

  float m[MAXR], l[MAXR], acc[MAXR][DPL];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int ntiles = hi >= lo ? (hi - lo) / 32 + 1 : 0;
  for (int t = warp; t < ntiles; t += FOLD_WARPS) {
    const int j0 = lo + 32 * t;
    const int j = j0 + lane;
    const bool live = j <= hi;
    // This lane's key: its row offset in kc/vc and its scale's in ks/vs.
    long long roff = 0, soff = 0;
    if (live) {
      if constexpr (PAGED) {
        const long long blk = bt[(long long)b * MB + j / BS];
        const int r = j % BS;
        roff = blk * kv_sb + r * kv_sj;
        soff = blk * sc_sb + r * sc_sj;
      } else {
        roff = j * kv_sj;
        soff = j * sc_sj;
      }
    }
    // Scores of key j against every row of the block.
    float sc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
    float vsc = 1.f;
    if (live) {
      const T* krow = kb + roff;
#pragma unroll
      for (int c = 0; c < D / VEC; ++c) {
        float kv[VEC];
        load16(krow + c * VEC, kv);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
#pragma unroll
            for (int u = 0; u < VEC; ++u) sc[r] += q_s[r][c * VEC + u] * kv[u];
          }
        }
      }
      if (QUANT) {
        const float ksc = ks[sc_base + soff];
        vsc = vs[sc_base + soff];
#pragma unroll
        for (int r = 0; r < MAXR; ++r) sc[r] = sc[r] * scale * ksc;
      } else {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) sc[r] *= scale;
      }
    }
    // Online softmax per row (R is uniform, so every lane takes the same
    // branches and the shuffles stay converged).
    float pv[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      pv[r] = 0.f;
      if (r < R) {
        const int qpos = len + r % S;
        const bool ok = live && j <= qpos && (window <= 0 || j > qpos - window);
        const float s = ok ? sc[r] : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(s));
        if (m_new != -INFINITY) {
          const float alpha = expf(m[r] - m_new);  // 0 while m[r] is -inf
          const float p = ok ? expf(s - m_new) : 0.f;
          l[r] = l[r] * alpha + warp_sum(p);
          m[r] = m_new;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
          pv[r] = p * vsc;
        }
      }
    }
    // P.V: lane owns output dims lane + 32 i of every row. The V values
    // of VB keys are loaded before any is used, so their global-memory
    // latencies overlap instead of adding up key by key.
    const int nk = min(32, hi - j0 + 1);
    for (int u0 = 0; u0 < nk; u0 += VB) {
      float vv[VB][DPL];
#pragma unroll
      for (int uu = 0; uu < VB; ++uu) {
        long long voff;
        if constexpr (PAGED) {
          voff = __shfl_sync(FULL, roff, (u0 + uu) & 31);
        } else {
          voff = (j0 + u0 + uu) * kv_sj;
        }
        const T* vrow = vb + voff;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vv[uu][i] = u0 + uu < nk ? to_f32(vrow[lane + 32 * i]) : 0.f;
      }
#pragma unroll
      for (int uu = 0; uu < VB; ++uu) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
            // pv is 0 on lanes past nk, and so is vv.
            const float pt = __shfl_sync(FULL, pv[r], u0 + uu);
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] += pt * vv[uu][i];
          }
        }
      }
    }
  }

  // Merge the warps' partial states.
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      if (lane == 0) {
        part_m[warp][r] = m[r];
        part_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) part_acc[warp][r][lane + 32 * i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += FOLD_WARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = part_m[0][r];
#pragma unroll
    for (int w = 1; w < FOLD_WARPS; ++w) mx = fmaxf(mx, part_m[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) {
      const float c = part_m[w][r] == -INFINITY ? 0.f : expf(part_m[w][r] - mx);
      lsum += part_l[w][r] * c;
      o += part_acc[w][r][d] * c;
    }
    const int g = r / S, s = r % S;
    out[b * o_sb + (long long)(hk * group + g) * o_sh + s * o_ss + d] =
        lsum > 0.f ? o / lsum : 0.f;
  }
}

}  // namespace

// The paged form's C entry point (paged_decode_mha.cu and
// paged_decode_mha_bf16.cu): q [B, H, 1, D] f32 against pools read through
// the table bt [B, MB] with the strides given, out [B, 1, H*D] at strides
// (o_sb, o_sh); cap = MB * BS; group H / Hkv <= 16; D 64 or 128.
#define RTEN_PAGED_PARAMS                                                        \
  const void *q, long long q_sb, long long q_sh, const void *k, const void *v,   \
      long long kv_sb, long long kv_sh, long long kv_sj, const void *ks,         \
      const void *vs, long long sc_sb, long long sc_sh, long long sc_sj,         \
      const void *bt, int MB, int BS, const void *lens, void *out,               \
      long long o_sb, long long o_sh, int B, int H, int Hkv, int D, int window,  \
      float scale, void *stream
#define RTEN_PAGED_NAMES                                                         \
  q, q_sb, q_sh, k, v, kv_sb, kv_sh, kv_sj, ks, vs, sc_sb, sc_sh, sc_sj, bt, MB, \
      BS, lens, out, o_sb, o_sh, B, H, Hkv, D, window, scale, stream

template <typename T>
int launch_paged_decode_mha(RTEN_PAGED_PARAMS) {
  const int rows = H / Hkv;
  if (rows < 1 || rows > 16 || (D != 64 && D != 128) || MB < 1 || BS < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define RTEN_PAGED(DD, RR)                                                       \
  decode_mha_fold_kernel<DD, T, RR, true><<<grid, FOLD_WARPS * 32, 0, st>>>(     \
      (const float*)q, q_sb, q_sh, 0, (const T*)k, (const T*)v, kv_sb, kv_sh,    \
      kv_sj, (const float*)ks, (const float*)vs, sc_sb, sc_sh, sc_sj,            \
      (const int32_t*)bt, MB, BS, (const int32_t*)lens, (float*)out, o_sb, o_sh, \
      0, H, Hkv, 1, MB * BS, window, scale)
  if (D == 64) {
    if (rows <= 8) RTEN_PAGED(64, 8); else RTEN_PAGED(64, 16);
  } else {
    if (rows <= 8) RTEN_PAGED(128, 8); else RTEN_PAGED(128, 16);
  }
#undef RTEN_PAGED
  return (int)cudaGetLastError();
}
