// decode_mha's per-head form on f32 head-major caches at head dims up to
// 128 (instances DP 64 and 128), on tensor cores in 3xTF32: the admissions
// of graphs on f32 caches (and of GPT-2's bf16 paged graphs, whose
// gathered pools the reference widens to f32), and prefill_mha_cat's on f32
// cat caches through the strides of their head-major views. Included by
// decode_mha.cuh; D 129-512 runs in decode_heads_wide.cuh.
//
// Replaces rten_tpu/kernels/flash_attention.py:935 decode_mha (the
// per-(slot, head, key block) pallas_call) on f32 caches, and :3301
// prefill_mha_cat on f32 cat caches.
//
// Function: decode_heads_tc.cuh's (query row s of slot b at position
// lens[b] + s attends columns j <= lens[b] + s, j < cap, and j > lens[b] +
// s - window with a window; a row with no column gives 0), with no scales.
//
// Bound on the H100 at TinyLlama's admission (16 slots x 128 rows, H 32,
// D 64, cap 256): the f32 q read and output written (33.5 MB) and the f32
// K/V (up to 8.4 MB) against 0.6 GFLOP at the TF32 peak: bytes, about 13
// us a call at 3.35 TB/s. The CUDA-core kernel it replaces took 250 us:
// every product on f32 FMAs out of shared memory.
//
// Arithmetic: both products in 3xTF32 on mma.sync.m16n8k8 (mma_tf32.cuh:
// big.big + big.small + small.big, about 22 bits an operand), f32
// accumulation, as mha.cu's f32 path does; the softmax in base 2 (the scale
// carries log2(e); ex2.approx). The result stays within a few 1e-6 of
// decode_mha_plain's f32 sums; one TF32 pass (about 3 decimal digits)
// misses the 1e-4 the port holds the kernels to.
//
// Tiling (mha.cu's KW = 1 tiling): one 128-thread block per (64-row query
// tile, head, slot), each warp owning 16 query rows; the key loop runs
// inside the block over 32-key tiles from the block's first window column
// to its last row's position, double-buffered by cp.async (16-byte copies
// where the rows are 16-byte aligned whole words, 4-byte ones otherwise;
// keys past the block's last position and dims past D zero-filled, not
// read). Each tile is split into its TF32 parts once for every warp (big in
// place, small in a third plane) behind one more barrier, so the warps
// read both parts with ldmatrix of the 4-byte words. At DP 64 each warp's
// q fragments are split once, before the loop, and kept in registers (64
// of them); at DP 128 that would take 128, so they are re-split from
// shared memory each tile. P goes from the score accumulators into the
// value product's A fragment with the keys of each 8-key step in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (the accumulator's own), V's rows read in
// the same order. Shared memory: the query tile, two K/V buffers and the
// small plane, 68 KB at DP 64 (three blocks an SM), 132 KB at DP 128. A
// warp skips the tiles none of its rows attends and the 8-key n-tiles past
// its last row. No atomics: two calls give the same bits. Built without
// --use_fast_math.

#pragma once

#include "decode_heads_tc.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TF_KEYS = 32;  // key columns a tile

template <int DP>
struct Tf32Tile {
  static constexpr int PITCH = DP + 4;  // floats a shared row: ldmatrix rows in 8 bank groups
  static constexpr int ROW_BYTES = PITCH * 4;
  static constexpr int KV = 2 * TF_KEYS * PITCH;  // floats of a K and a V tile
  static constexpr int SMEM = (TC_ROWS * PITCH + 3 * KV) * 4;
  static constexpr bool QREG = DP <= 64;  // q's parts kept in registers
};

// Rows [r0, r0 + n) of a [.., D] f32 tensor (rows st floats apart) into dst
// (rows P floats apart), every DP column, by a block of NTHREADS threads:
// rows at or past ``valid`` and dims past D zero-filled. 16-byte cp.async
// when ``vec``, else 4-byte. (decode_heads_wide.cuh stages q with it too.)
template <int DP, int P = Tf32Tile<DP>::PITCH, int NTHREADS = TC_THREADS>
__device__ __forceinline__ void tf32_rows(float* dst, const float* src, long long st, int r0,
                                          int n, int valid, int D, bool vec, int tid) {
  if (vec) {
    constexpr int CPR = DP / 4;  // 16-byte chunks a row
    for (int i = tid; i < n * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR, row = r0 + r;
      const bool in = row < valid && 4 * c < D;
      cp_async16(dst + r * P + 4 * c, in ? src + row * st + 4 * c : src, in);
    }
  } else {
    for (int i = tid; i < n * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP, row = r0 + r;
      const bool in = row < valid && c < D;
      cp_async4(dst + r * P + c, in ? src + row * st + c : src, in);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS) decode_mha_heads_tf32_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const float* __restrict__ kc, const float* __restrict__ vc, long long kv_sb, long long kv_sh,
    long long kv_sj, const int32_t* __restrict__ lens, float* __restrict__ out, long long o_sb,
    long long o_sh, long long o_ss, int H, int Hkv, int S, int D, int cap, int window,
    float scale, int vec) {
  using TT = Tf32Tile<DP>;
  constexpr int P = TT::PITCH;
  constexpr int NT = TF_KEYS / 8;  // 8-key n-tiles of a score block
  constexpr int DT = DP / 8;       // 8-dim steps of the score, n-tiles of the output
  extern __shared__ __align__(16) unsigned char tf_smem[];
  float* qs = reinterpret_cast<float*>(tf_smem);
  float* kv0 = qs + TC_ROWS * P;  // two buffers of K then V
  float* small = kv0 + 2 * TT::KV;  // the small parts of the tile in use (K, then V)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = h / (H / Hkv);
  const float* kb = kc + b * kv_sb + hk * kv_sh;
  const float* vb = vc + b * kv_sb + hk * kv_sh;
  const int len = lens[b];
  const int r0 = qt * TC_ROWS;
  const int w0 = r0 + 16 * warp;  // the warp's first query row

  const int last_row = min(S - 1, r0 + TC_ROWS - 1);
  const int kmax = min(len + last_row, cap - 1);
  const int kmin = window > 0 ? max(0, len + r0 - window + 1) : 0;
  const int kstart = (kmin / TF_KEYS) * TF_KEYS;
  const int ntiles = kmax >= kstart ? (kmax - kstart) / TF_KEYS + 1 : 0;
  const int kend = kmax + 1;  // keys from here on are not read (zero fill)
  const bool vq = vec != 0;  // K/V rows (the wrapper's check); q's here
  const float* qb = q + b * q_sb + h * q_sh;
  const bool qvec = reinterpret_cast<uintptr_t>(qb) % 16 == 0 && q_ss % 4 == 0 && D % 4 == 0;

  tf32_rows<DP>(qs, qb, q_ss, r0, TC_ROWS, S, D, qvec, tid);
  auto load_tile = [&](int buf, int k0) {
    float* dk = kv0 + buf * TT::KV;
    tf32_rows<DP>(dk, kb, kv_sj, k0, TF_KEYS, kend, D, vq, tid);
    tf32_rows<DP>(dk + TF_KEYS * P, vb, kv_sj, k0, TF_KEYS, kend, D, vq, tid);
  };
  if (ntiles > 0) load_tile(0, kstart);
  cp_async_commit();

  // The columns each of the thread's two rows (g, g + 8) attends: [lo, hi]
  // (hi < lo for a row past S).
  int clo[2], chi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = w0 + g + 8 * i, qpos = len + s;
    chi[i] = s < S ? min(qpos, cap - 1) : -1;
    clo[i] = window > 0 ? max(0, qpos - window + 1) : 0;
  }
  const float scale2 = scale * 1.4426950408889634f;
  const int wlast = min(S - 1, w0 + 15);
  const bool warp_live = w0 < S;
  // The lane's ldmatrix rows of q: the warp's rows 0-7 / 8-15 (A
  // fragments, row g / g + 8) at dims 0 / 4 of an 8-dim step.
  const float* q_l = qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * P + 4 * (lane >> 4);
  uint32_t qbig[TT::QREG ? DT : 1][4], qsml[TT::QREG ? DT : 1][4];

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, k0 = kstart + it * TF_KEYS;
    cp_async_wait<0>();  // tile it (and, first, q) has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile it - 1 is consumed
    if (it + 1 < ntiles) load_tile(buf ^ 1, k0 + TF_KEYS);
    cp_async_commit();
    if constexpr (TT::QREG) {
      if (it == 0) {  // q's parts, once
#pragma unroll
        for (int kk = 0; kk < DT; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, q_l + kk * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(qa[i], qbig[kk][i], qsml[kk][i]);
        }
      }
    }
    float* tk = kv0 + buf * TT::KV;  // the tile's K; its V at + TF_KEYS rows
    // The tile's TF32 parts, once for every warp: big in place, small beside.
    constexpr int Q4 = DP / 4;
    for (int i = tid; i < 2 * TF_KEYS * Q4; i += TC_THREADS) {
      const int r = i / Q4, c = i % Q4;  // rows of K, then of V
      float4* src = reinterpret_cast<float4*>(tk + r * P + 4 * c);
      const float4 x = *src;
      uint32_t bg[4], sm[4];
      split_tf32(__float_as_uint(x.x), bg[0], sm[0]);
      split_tf32(__float_as_uint(x.y), bg[1], sm[1]);
      split_tf32(__float_as_uint(x.z), bg[2], sm[2]);
      split_tf32(__float_as_uint(x.w), bg[3], sm[3]);
      *src = make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]), __uint_as_float(bg[2]),
                         __uint_as_float(bg[3]));
      *reinterpret_cast<float4*>(small + r * P + 4 * c) =
          make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]), __uint_as_float(sm[2]),
                      __uint_as_float(sm[3]));
    }
    __syncthreads();  // the parts are whole

    const bool attend = warp_live && k0 <= len + wlast &&
                        (window <= 0 || k0 + TF_KEYS - 1 > len + w0 - window);
    if (!attend) continue;
    const float* tv = tk + TF_KEYS * P;
    const float* sk = small;
    const float* sv = small + TF_KEYS * P;
    // The warp's last key in this tile: n-tiles past it are skipped.
    const int kw = len + wlast - k0;

    // S = q K^T in 3xTF32, 8 dims a step; K's parts (keys g of two
    // n-tiles, dims t and t + 4) by ldmatrix from the planes.
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (kk * 8 >= D) continue;
      uint32_t qb[4], qm[4];
      if constexpr (TT::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qb[i] = qbig[kk][i];
          qm[i] = qsml[kk][i];
        }
      } else {
        uint32_t qa[4];
        ldmatrix_x4(qa, q_l + kk * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qa[i], qb[i], qm[i]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        if (n * 8 > kw) continue;
        const int off = (n * 8 + 8 * (lane >> 4) + (lane & 7)) * P + kk * 8 + 4 * ((lane >> 3) & 1);
        uint32_t kbig[4], ksml[4];
        ldmatrix_x4(kbig, tk + off);
        ldmatrix_x4(ksml, sk + off);
        mma_3xtf32(sacc[n], qb, qm, kbig[0], kbig[1], ksml[0], ksml[1]);
        mma_3xtf32(sacc[n + 1], qb, qm, kbig[2], kbig[3], ksml[2], ksml[3]);
      }
    }
    // Scale (base 2), mask, the online softmax of rows g (e < 2) and g + 8.
    const int lo0 = clo[0] - k0 - 2 * t, hi0 = chi[0] - k0 - 2 * t;
    const int lo1 = clo[1] - k0 - 2 * t, hi1 = chi[1] - k0 - 2 * t;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (e & 1);  // the column, less k0 + 2 t
        const bool ok = e < 2 ? c >= lo0 && c <= hi0 : c >= lo1 && c <= hi1;
        sacc[n][e] = ok ? sacc[n][e] * scale2 : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], sacc[n][e]);
      }
    }
    float alpha[2], mu[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no column yet: every p is 0
      alpha[i] = fast_exp2(m[i] - mu[i]);        // 0 while m is -inf
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sacc[n][e] - mu[e >> 1]);  // 0 where masked
        psum[e >> 1] += p;
        sacc[n][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(FULL, psum[i], 1);
      psum[i] += __shfl_xor_sync(FULL, psum[i], 2);
      l[i] = l[i] * alpha[i] + psum[i];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V in 3xTF32, 8 keys a step in the order 2t, 2t + 1 of the
    // score accumulator: a0 = P[g][2t], a1 = P[g + 8][2t], a2 = P[g][2t + 1],
    // a3 = P[g + 8][2t + 1]; V's B fragment rows 2t, 2t + 1, column g, from
    // both planes.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 > kw) continue;
      const uint32_t pa[4] = {__float_as_uint(sacc[n][0]), __float_as_uint(sacc[n][2]),
                              __float_as_uint(sacc[n][1]), __float_as_uint(sacc[n][3])};
      uint32_t pbig[4], psml[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pa[i], pbig[i], psml[i]);
      const int off = (n * 8 + 2 * t) * P + g;
      const float* vr = tv + off;
      const float* vs = sv + off;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j * 8 >= D) continue;
        mma_3xtf32(o[j], pbig, psml, __float_as_uint(vr[j * 8]), __float_as_uint(vr[P + j * 8]),
                   __float_as_uint(vs[j * 8]), __float_as_uint(vs[P + j * 8]));
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = w0 + g + i * 8;
    if (s >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = out + b * o_sb + h * o_sh + (long long)s * o_ss;
#pragma unroll
    for (int j = 0; j < DT; ++j) {  // D even, rows 8-byte aligned: dims in pairs
      const int d = j * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

}  // namespace
