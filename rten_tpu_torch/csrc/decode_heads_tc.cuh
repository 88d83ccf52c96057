// decode_mha's per-head form on tensor cores, for s8, int4 and bf16
// head-major caches at head dims up to 128 (instances DP 64 and 128): the
// admissions of every Llama-family graph on those caches, and of GPT-2's
// int4 deferred graph; and prefill_mha_cat's admissions on s8 and bf16 cat
// caches, read through the strides of their head-major views. Included by
// decode_mha.cuh; f32 caches, whose values bf16 does not hold, run in
// 3xTF32 (decode_heads_tf32.cuh), and D 129-512 in decode_heads_wide.cuh,
// which also uses this file's helpers.
//
// Replaces rten_tpu/kernels/flash_attention.py:935 decode_mha (the
// per-(slot, head, key block) pallas_call), and
// :3301 prefill_mha_cat.
//
// Function (as decode_mha.cu states it): query row s of slot b, head h, at
// position lens[b] + s, reads kv head h / (H / Hkv) and attends columns
// j <= lens[b] + s, j < cap and, with a window, j > lens[b] + s - window;
// s_j = (q . k_j) * scale * ks[j]; out = sum_j p_j vs[j] v_j / sum_j p_j,
// l summing the unscaled p; a row with no column gives 0.
//
// Bound on the H100: at TinyLlama's admission (16 slots x 128 rows, H 32,
// D 64, cap 256) the f32 q read and the f32 output written are 33.5 MB a
// call against 2 MB of bf16 K/V and 0.6 GFLOP (4 * pairs * D): bytes,
// about 10 us a call at 3.35 TB/s. The CUDA-core form took 260 us: every
// product on f32 FMAs out of shared memory.
//
// Arithmetic: mma.sync.m16n8k16 on bf16 operands with f32 accumulation.
// K and V enter as bf16 and are exact: s8 codes (|x| <= 127), int4 codes
// (nibble - 8) and bf16 values all have at most 8 significant bits (s8 and
// int4 codes are widened with exact f32 bit tricks, not conversions). q
// enters as three bf16 parts, q_hi = bf16(q), q_mid = bf16(q - q_hi), q_lo
// = bf16(q - q_hi - q_mid), together about 24 bits, so the score is three
// products; p * vs[j] enters the value product the same way. bf16 x bf16
// products are exact in f32. The softmax runs in base 2 (the scale carries
// log2(e); ex2.approx, relative error near 2^-22). The result stays within
// about 5e-7 of max|out| of decode_mha_plain, as close as f32 arithmetic
// in another order. One bf16 rounding (the TPU kernel's _dot_f32) is 2e-3
// away; two parts are 4e-6 away, which passes 1e-4 but makes the small
// engines' u8 activations round apart on card and CPU (token parts).
//
// Tiling: one 128-thread block per (64-row query tile, head, slot), each
// warp owning 16 query rows (their A fragments, in three parts, stay in
// registers); the key loop runs inside the block over 64-key tiles from
// the block's first window column to its last row's position,
// double-buffered in shared memory with cp.async: 16-byte copies at
// per-thread offsets fixed for the whole loop where rows are whole,
// aligned 16-byte words and D == DP (the wrapper's ``vec``), element
// copies otherwise; keys past the block's last position are zero-filled,
// not read. bf16 rows land in the tile as they are; s8 and int4 rows land
// in a raw staging buffer (with the tile's scales) and are widened to bf16
// as the tile is filled. Per tile and warp: the score block S[16 x 64]
// from ldmatrix'd K fragments (each x4 load feeds two 8-key n-tiles), the
// mask as one column range a row, the online softmax in registers (each
// thread holds two rows' 16 scores; a row's max and sum reduce over the
// four threads that share it), then the score accumulators are reused as
// the A operand of P.V (FlashAttention-2's register layout), V from
// ldmatrix.trans. One barrier a tile (two for s8/int4). A warp skips a
// tile none of its rows attends (past its last row, or before its first
// row's window), and the 8-key n-tiles and 16-key steps past its last row.
// Rows past S and dims past D are zero and are not written. Three blocks
// an SM at DP 64 (168 registers a thread), two at DP 128. No atomics: two
// calls give the same bits. Built without --use_fast_math.

#pragma once

#include "decode_fold.cuh"

namespace {

constexpr int TC_THREADS = 128;
constexpr int TC_ROWS = 64;  // query rows a block: 16 a warp
constexpr int TC_KEYS = 64;  // key columns a tile

template <int DP, typename T>
struct TcTile {
  static constexpr bool QUANT = KvRow<T>::QUANT;
  static constexpr bool U4 = KvRow<T>::U4;
  // bf16 elements a tile row: DP plus 16 bytes, so that the 8 rows an
  // ldmatrix reads start in 8 different 16-byte bank groups.
  static constexpr int PITCH = DP + 8;
  static constexpr int TILE = TC_KEYS * PITCH;       // bf16 elements of a K or V tile
  static constexpr int RAW_ROW = U4 ? DP / 2 : DP;   // staged bytes a row (s8, int4)
  static constexpr int RAW = TC_KEYS * RAW_ROW;
  // Shared bytes. bf16: K and V tiles, two of each. s8/int4: one K and one
  // V tile, two raw K and V staging buffers, two tiles of K and V scales.
  static constexpr int SMEM =
      QUANT ? 2 * TILE * 2 + 4 * RAW + 4 * TC_KEYS * 4 : 4 * TILE * 2;
  // Blocks an SM holds: three at DP 64 (registers capped at 168 a thread:
  // the q parts stay in registers), two at DP 128.
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (or, when !valid, 0: zero fill) bytes from global to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as three bf16 pairs whose sum is x to about 24 bits: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference is
// exact in f32).
__device__ __forceinline__ void split3_bf16x2(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    p[i] = bf16x2_bits(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// Element d of a staged s8 or int4 row as a float (0 past D).
template <typename T>
__device__ __forceinline__ float staged_elem(const uint8_t* row, int d, int D, int half) {
  if (d >= D) return 0.f;
  if constexpr (KvRow<T>::U4) {
    const int byte = row[d < half ? d : d - half];
    return (float)((d < half ? (byte & 15) : (byte >> 4)) - INT4_BIAS);
  } else {
    return (float)(int8_t)row[d];
  }
}

// Four bytes b (0..255) as the bf16 values b - OFF, exactly, two a word:
// 2^23 + b is an f32 whose low bits are b, so subtracting 2^23 + OFF is
// exact, and the result (at most 8 significant bits) is its own top 16
// bits. No int-to-float conversion (a quarter-rate instruction).
template <int OFF>
__device__ __forceinline__ uint2 bf16x4_of_bytes(uint32_t w) {
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)  // bytes: b_k, 0, 0, 0x4B (one PRMT)
    f[k] = __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + k)) -
                           (8388608.f + OFF));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// Widen ROWS staged s8/int4 rows of one matrix into its bf16 tile (every DP
// column; zeros past D), thread ``tid`` of ``nthreads``. With D == DP, eight
// dims from one 8-byte read.
template <int DP, typename T, int ROWS = TC_KEYS>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, __nv_bfloat16* tile, int D,
                                           int tid = threadIdx.x, int nthreads = TC_THREADS) {
  using TT = TcTile<DP, T>;
  constexpr int GROUPS = DP / 8;  // 8 dims a group
  const int half = D / 2;
  for (int idx = tid; idx < ROWS * GROUPS; idx += nthreads) {
    const int r = idx / GROUPS, d0 = (idx % GROUPS) * 8;
    const uint8_t* row = raw + r * TT::RAW_ROW;
    uint4 o;
    if (D == DP) {
      uint2 w = *reinterpret_cast<const uint2*>(row + (KvRow<T>::U4 && d0 >= half ? d0 - half : d0));
      uint2 lo, hi;
      if constexpr (KvRow<T>::U4) {  // codes: the low nibbles below D / 2, the high ones above
        const int sh = d0 < half ? 0 : 4;
        lo = bf16x4_of_bytes<INT4_BIAS>((w.x >> sh) & 0x0F0F0F0Fu);
        hi = bf16x4_of_bytes<INT4_BIAS>((w.y >> sh) & 0x0F0F0F0Fu);
      } else {  // s8: x + 128 is x with its sign bit flipped
        lo = bf16x4_of_bytes<128>(w.x ^ 0x80808080u);
        hi = bf16x4_of_bytes<128>(w.y ^ 0x80808080u);
      }
      o = make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      float f[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = staged_elem<T>(row, d0 + u, D, half);
      o.x = bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
      o.y = bf16x2_bits(__floats2bfloat162_rn(f[2], f[3]));
      o.z = bf16x2_bits(__floats2bfloat162_rn(f[4], f[5]));
      o.w = bf16x2_bits(__floats2bfloat162_rn(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(tile + r * TT::PITCH + d0) = o;
  }
}

// A thread's share of a tile's 16-byte copies when every row is whole
// 16-byte words and D == DP: chunk CC of rows RR, RR + RPP, ... (the same
// for every tile, so the addresses advance by additions).
template <int DP, typename T>
struct CopyPlan {
  using TT = TcTile<DP, T>;
  static constexpr int ROW_BYTES = TT::QUANT ? TT::RAW_ROW : 2 * DP;  // a cache row, D == DP
  static constexpr int CPR = ROW_BYTES / 16;                          // 16-byte chunks a row
  static constexpr int RPP = TC_THREADS / CPR;                        // rows a pass
  static constexpr int PASSES = TC_KEYS / RPP;
  static constexpr int DST_PITCH = TT::QUANT ? TT::RAW_ROW : 2 * TT::PITCH;  // bytes
};

// The tile's scales (quantized caches): thread t copies ks (t < 64) or vs
// of column k0 + t % 64 into buffer ``buf``; 0 past cap.
template <int DP, typename T>
__device__ __forceinline__ void load_scales(unsigned char* smem, int buf, int k0, const float* ks,
                                            const float* vs, long long sc_off, long long sc_sj,
                                            int cap) {
  using TT = TcTile<DP, T>;
  const int tid = threadIdx.x, r = tid % TC_KEYS, col = k0 + r;
  const bool in = col < cap;
  float* sc = reinterpret_cast<float*>(smem + 2 * TT::TILE * 2 + 4 * TT::RAW) + buf * 2 * TC_KEYS;
  const float* src = (tid < TC_KEYS ? ks : vs) + sc_off + (in ? col : 0) * sc_sj;
  cp_async4(sc + (tid < TC_KEYS ? 0 : TC_KEYS) + r, src, in);
}

// The destination of buffer ``buf``'s K rows (V rows follow at +vgap
// bytes): bf16 rows into the K/V tiles, s8/int4 rows into the raw staging
// buffers.
template <int DP, typename T>
__device__ __forceinline__ unsigned char* tile_dst(unsigned char* smem, int buf, int& vgap) {
  using TT = TcTile<DP, T>;
  if constexpr (TT::QUANT) {
    vgap = TT::RAW;
    return smem + 2 * TT::TILE * 2 + buf * 2 * TT::RAW;
  } else {
    vgap = TT::TILE * 2;
    return smem + buf * 2 * TT::TILE * 2;
  }
}

// Any other layout: element copies (plain loads and stores, complete at the
// next barrier), zeros for rows past cap.
template <int DP, typename T>
__device__ __forceinline__ void load_tile_slow(unsigned char* smem, int buf, int k0, const T* kb,
                                               const T* vb, long long kv_sj, int D, int cap) {
  using TT = TcTile<DP, T>;
  int vgap;
  unsigned char* dk = tile_dst<DP, T>(smem, buf, vgap);
  const int tid = threadIdx.x;
  if constexpr (TT::QUANT) {
    const int rb = TT::U4 ? D / 2 : D;  // row bytes
    const uint8_t* kbb = reinterpret_cast<const uint8_t*>(kb);
    const uint8_t* vbb = reinterpret_cast<const uint8_t*>(vb);
    for (int idx = tid; idx < TC_KEYS * rb; idx += TC_THREADS) {
      const int r = idx / rb, c = idx % rb, col = k0 + r;
      const bool in = col < cap;
      dk[r * TT::RAW_ROW + c] = in ? kbb[col * kv_sj + c] : 0;
      dk[vgap + r * TT::RAW_ROW + c] = in ? vbb[col * kv_sj + c] : 0;
    }
  } else {
    __nv_bfloat16* tk = reinterpret_cast<__nv_bfloat16*>(dk);
    __nv_bfloat16* tv = reinterpret_cast<__nv_bfloat16*>(dk + vgap);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int idx = tid; idx < TC_KEYS * D; idx += TC_THREADS) {
      const int r = idx / D, d = idx % D, col = k0 + r;
      const bool in = col < cap;
      tk[r * TT::PITCH + d] = in ? kb[col * kv_sj + d] : zero;
      tv[r * TT::PITCH + d] = in ? vb[col * kv_sj + d] : zero;
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, typename T>
__global__ void __launch_bounds__(TC_THREADS, TcTile<DP, T>::MIN_BLOCKS) decode_mha_heads_tc_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc, long long kv_sb, long long kv_sh,
    long long kv_sj, const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj, const int32_t* __restrict__ lens,
    float* __restrict__ out, long long o_sb, long long o_sh, long long o_ss, int H, int Hkv,
    int S, int D, int cap, int window, float scale, int vec) {
  using TT = TcTile<DP, T>;
  using CP = CopyPlan<DP, T>;
  constexpr int KSTEPS = DP / 16;  // 16-dim steps of the score product
  constexpr int NT = TC_KEYS / 8;  // 8-key n-tiles of a score block
  constexpr int DT = DP / 8;       // 8-dim n-tiles of the output
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragments' row group and column pair
  const int hk = h / (H / Hkv);
  const T* kb = kc + b * kv_sb + hk * kv_sh;
  const T* vb = vc + b * kv_sb + hk * kv_sh;
  const long long sc_off = b * sc_sb + hk * sc_sh;
  const int len = lens[b];
  const int r0 = qt * TC_ROWS;
  const int w0 = r0 + warp * 16;  // the warp's first query row

  __nv_bfloat16* tile_k = reinterpret_cast<__nv_bfloat16*>(smem);  // buffer 0 (s8/int4: the only one)
  // bf16 tiles: dims past D stay zero (the copies fill columns < D only).
  if (!TT::QUANT && D < DP) {
    for (int i = tid; i < 4 * TT::TILE / 8; i += TC_THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  const int last_row = min(S - 1, r0 + TC_ROWS - 1);
  const int kmax = min(len + last_row, cap - 1);
  const int kmin = window > 0 ? max(0, len + r0 - window + 1) : 0;
  const int kstart = (kmin / TC_KEYS) * TC_KEYS;
  const int ntiles = kmax >= kstart ? (kmax - kstart) / TC_KEYS + 1 : 0;
  const int kend = kmax + 1;  // keys from here on are not read (zero fill)

  // The copy plan: 16-byte copies at fixed offsets, or element copies.
  const bool fast = vec && D == DP;
  const long long sj = kv_sj * (long long)sizeof(T);  // bytes between key rows
  const int cc = tid % CP::CPR, rr = tid / CP::CPR;
  const unsigned char* kb0 = reinterpret_cast<const unsigned char*>(kb);
  const unsigned char* vb0 = reinterpret_cast<const unsigned char*>(vb);
  const unsigned char* ksrc0 = kb0 + rr * sj + cc * 16;
  const unsigned char* vsrc0 = vb0 + rr * sj + cc * 16;
  const int dst0 = rr * CP::DST_PITCH + cc * 16;
  auto load_tile = [&](int buf, int k0) {
    if constexpr (TT::QUANT) load_scales<DP, T>(smem, buf, k0, ks, vs, sc_off, sc_sj, kend);
    if (!fast) {
      load_tile_slow<DP, T>(smem, buf, k0, kb, vb, kv_sj, D, kend);
      return;
    }
    int vgap;
    unsigned char* dk = tile_dst<DP, T>(smem, buf, vgap) + dst0;
    const unsigned char* ksrc = ksrc0 + k0 * sj;
    const unsigned char* vsrc = vsrc0 + k0 * sj;
#pragma unroll
    for (int j = 0; j < CP::PASSES; ++j) {
      const bool in = k0 + rr + j * CP::RPP < kend;
      // Past the last key: zero fill, nothing read (the address is row 0).
      cp_async16(dk + j * CP::RPP * CP::DST_PITCH, in ? ksrc : kb0, in);
      cp_async16(dk + vgap + j * CP::RPP * CP::DST_PITCH, in ? vsrc : vb0, in);
      ksrc += CP::RPP * sj;
      vsrc += CP::RPP * sj;
    }
  };

  if (ntiles > 0) load_tile(0, kstart);
  cp_async_commit();

  // Meanwhile the warp's q rows become its A fragments, split into three
  // bf16 parts: a[0] (row g, dims 2tg, 2tg + 1), a[1] (row g + 8), a[2]
  // (row g, dims + 8), a[3] (row g + 8, dims + 8) of each 16-dim step;
  // zeros past S and D.
  uint32_t qa[KSTEPS][3][4];
  {
    float2 x[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {  // every load in flight before the first split
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = w0 + g + (i & 1) * 8, d = kk * 16 + 2 * tg + (i >> 1) * 8;
        const float* qr = q + b * q_sb + h * q_sh + (long long)s * q_ss + d;
        x[kk][i].x = s < S && d < D ? qr[0] : 0.f;
        x[kk][i].y = s < S && d + 1 < D ? qr[1] : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t parts[3];
        split3_bf16x2(x[kk][i].x, x[kk][i].y, parts);
#pragma unroll
        for (int p = 0; p < 3; ++p) qa[kk][p][i] = parts[p];
      }
    }
  }

  // The columns each of the thread's two rows (g, g + 8) attends: [lo, hi]
  // (hi < lo for a row past S). Scores are kept in base 2: the scale
  // carries log2(e), and p = 2^(s - m) = e^((s - m) ln 2).
  int clo[2], chi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = w0 + g + 8 * i, qpos = len + s;
    chi[i] = s < S ? min(qpos, cap - 1) : -1;
    clo[i] = window > 0 ? max(0, qpos - window + 1) : 0;
  }
  const float scale2 = scale * 1.4426950408889634f;
  // A tile wholly past the warp's last row, or before its first row's
  // window, is skipped.
  const int wlast = min(S - 1, w0 + 15);
  const bool warp_live = w0 < S;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // One barrier a tile (two for s8/int4): after it, tile t has landed for
  // every thread and every warp is done with tile t - 1, whose buffers the
  // copies of tile t + 1 then refill while tile t is widened and used.
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kstart + t * TC_KEYS, buf = t & 1;
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is consumed
    if (t + 1 < ntiles) load_tile(buf ^ 1, k0 + TC_KEYS);
    cp_async_commit();
    const __nv_bfloat16* tk;
    const __nv_bfloat16* tv;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (TT::QUANT) {
      const uint8_t* rk = smem + 2 * TT::TILE * 2 + buf * 2 * TT::RAW;
      widen_tile<DP, T>(rk, tile_k, D);
      widen_tile<DP, T>(rk + TT::RAW, tile_k + TT::TILE, D);
      ksc = reinterpret_cast<const float*>(smem + 2 * TT::TILE * 2 + 4 * TT::RAW) +
            buf * 2 * TC_KEYS;
      vsc = ksc + TC_KEYS;
      tk = tile_k;
      tv = tile_k + TT::TILE;
      __syncthreads();  // the widened tile is whole
    } else {
      tk = tile_k + buf * 2 * TT::TILE;
      tv = tk + TT::TILE;
    }

    const bool attend = warp_live && k0 <= len + wlast &&
                        (window <= 0 || k0 + TC_KEYS - 1 > len + w0 - window);
    if (attend) {
      // The warp's last key in this tile: 8-key n-tiles and 16-key steps
      // past it hold no column of its rows and are skipped.
      const int kw = len + wlast - k0;
      // S = (q_hi + q_mid + q_lo) . K^T over the tile's 64 keys.
      float sacc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 > kw) continue;
          // Matrices: keys n*8.. / dims kk*16, dims + 8; keys + 8, both.
          const int key = n * 8 + (lane >> 4) * 8 + (lane & 7);
          const int dim = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bk[4];
          ldmatrix_x4(bk, tk + key * TT::PITCH + dim);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            mma_bf16(sacc[n], qa[kk][p], bk[0], bk[1]);
            mma_bf16(sacc[n + 1], qa[kk][p], bk[2], bk[3]);
          }
        }
      }
      // Scale (base 2), mask, the online softmax of rows g (i = 0) and g + 8.
      const int lo0 = clo[0] - k0 - 2 * tg, hi0 = chi[0] - k0 - 2 * tg;
      const int lo1 = clo[1] - k0 - 2 * tg, hi1 = chi[1] - k0 - 2 * tg;
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + (e & 1);  // the column, less 2 * tg
          const bool ok = e < 2 ? c >= lo0 && c <= hi0 : c >= lo1 && c <= hi1;
          const float kscale = TT::QUANT ? ksc[c + 2 * tg] : 1.f;
          sacc[n][e] = ok ? sacc[n][e] * scale2 * kscale : -INFINITY;
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
          sacc[n][e] = TT::QUANT ? p * vsc[n * 8 + (e & 1) + 2 * tg] : p;  // the value weight
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
      // O += the three parts of (p vs) . V, 16 keys a step: the score
      // accumulators of n-tiles 2kk and 2kk + 1 are the A fragment.
#pragma unroll
      for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
        if (kk * 16 > kw) continue;
        uint32_t pa[3][4], parts[4][3];
        split3_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1], parts[0]);
        split3_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3], parts[1]);
        split3_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], parts[2]);
        split3_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], parts[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int p = 0; p < 3; ++p) pa[p][i] = parts[i][p];
        }
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          // Matrices: keys kk*16.. / + 8 at dims j*8, then at dims j*8 + 8.
          const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int dim = j * 8 + (lane >> 4) * 8;
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, tv + key * TT::PITCH + dim);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            mma_bf16(o[j], pa[p], bv[0], bv[1]);
            mma_bf16(o[j + 1], pa[p], bv[2], bv[3]);
          }
        }
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
      const int d = j * 8 + 2 * tg;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

}  // namespace
