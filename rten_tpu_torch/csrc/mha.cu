// Flash attention (prefill-sized query blocks) for Hopper (sm_90a):
// q [B, Hq, Tq, D] against k, v [B, Hkv, Tk, D] -> out [B, Hq, Tq, D], f32
// or bf16 (accumulated in f32; out in q's type).
//
// Replaces: rten_tpu/kernels/flash_attention.py:139, mha_pallas (Pallas body
// _kernel, :71-136). Same function: s = q.k * scale, then softcap * tanh(s
// / softcap) when softcap > 0, then + mask[row, col] (an optional additive
// f32 mask [Tq, Tk], read through strides, so a [1, Tk] mask broadcast to
// every row costs nothing), and columns outside the causal band (col <= row
// + Tk - Tq when causal) or past Tk become NEG_INF = -1e30. The online
// softmax keeps the TPU kernel's guards: a probability is 0 while the
// running max is <= NEG_INF / 2, and a row whose every column is masked
// (the padding rows of a left-padded prompt) comes out 0 (l == 0 -> 1). l
// sums the unrounded p; the value product takes p rounded to V's type, as
// the reference's p.astype(v.dtype) (bf16: one rounding). GQA is kv-major:
// query head h reads KV head h / (Hq / Hkv).
//
// Bound on the H100: operations. 4 * Tq * Tk * D flops per head (about half
// with causal) against (2 Tq + 2 Tk) * D bytes of q's type per head; at
// GPT-2's prefill of 128 tokens (12 heads of D 64) the bytes bound it, at
// 1024 tokens the operations: 19 us (12 heads, causal) at the TF32
// tensor-core peak of 495 TFLOP/s for f32 inputs, 10 us at bf16's 989.
//
// Arithmetic, D <= 128: both products on tensor cores (mma.sync).
// * bf16: one m16n8k16 bf16 product each for S = Q K^T and O = P V (f32
//   accumulation), P rounded to bf16.
// * f32: 3xTF32 on m16n8k8. Each f32 operand x is split as big =
//   cvt.rna.tf32(x) (11 significant bits) and small = cvt.rna.tf32(x - big)
//   (x - big is exact in f32), about 22 bits together, and a product is
//   big.big + big.small + small.big (the small.small term, 2^-22 of it, is
//   dropped). Chosen over bf16 parts (split3_bf16x2, decode_heads_tc.cuh):
//   three TF32 products a k8 step cost the tensor cores what six bf16 ones
//   a k16 step do (the same issue slots), but take two parts an operand,
//   not three, so fewer split instructions, registers and shared memory.
//   Against mha_plain (f32 CUDA-core sums) the result stays within 3.3e-6
//   at the smoke test's four f32 cases (PERF.md, row 5, on the card); one
//   TF32 pass (about 3 decimal digits) misses the tests' 1e-4
//   (tests/test_torch_mha_tc.py models both).
// The softmax runs in base 2: p = 2^(s log2(e) - m log2(e)) on ex2.approx
// (relative error near 2^-22), the scale, softcap and mask applied to s
// first, in the reference's order.
//
// Tiling, D <= 128 (mha_tc_kernel): four warps a block, each holding 16
// query rows, so a row's max and sum need only the four lanes of a quad;
// the online softmax state (m, l, the row's output slice) stays in
// registers. KW of the four warps split each key tile (the wrapper's
// mha_key_warps picks 1, 2 or 4 from the shapes): KW = 1, a block of 64
// rows, each warp its own 16 rows over every key (GQA 32/4 at 256 rows: 256
// blocks of even work); KW = 2, blocks of 32 rows, two warps a row group
// (GPT-2's 1024-token prefill: 384 blocks, the longest causal rows' keys
// split in two); KW = 4, a block of 16 rows whose four warps score a
// quarter each of every key tile (its 128-token prefill: 96 blocks). The
// warps of a row group merge their states at the end in warp order. The
// block walks its key tiles in order, double-buffered through cp.async
// (16-byte copies where every row is 16-byte aligned, 4-byte ones
// otherwise; keys past Tk and dims past D zero). For f32 the block splits
// each tile into its TF32 parts once (big in place, small in a second
// plane), behind one more barrier, so the warps read both parts with
// ldmatrix; Q's fragments are split in registers. The query tile is staged
// once. S comes from ldmatrix'd Q and K fragments (for f32, ldmatrix of the
// 4-byte words hands each lane the TF32 A and B layouts directly); P goes
// from the score accumulators straight into the value product's A fragment
// (bf16: FlashAttention-2's register reuse; f32: the keys of each 8-key
// step taken in the order 0, 2, 4, 6, 1, 3, 5, 7, the accumulator's own,
// and V's rows read in the same order). V through ldmatrix.trans (bf16) or
// 4-byte loads from rows padded to 4 mod 16 words (f32; conflict-free). A
// tile's mask values are loaded before its scores are used; only a tile
// with a column past Tk or past the causal band of one of the warp's rows
// tests each column. Key tiles wholly above the causal diagonal of the
// block's last row are never loaded; a warp skips the tiles and 16-key
// steps past its own last row. Query tiles are launched longest rows first
// (the last tiles of a causal prompt hold the most keys). No atomics: two
// calls give the same bits. Instances DP = 64 and 128: any even D up to
// 128 runs in the smaller that holds it, the dims past D zero.
//
// D 129-256 (mha_simt_kernel): f32 FMAs on CUDA cores, the earlier design
// (one 128-thread block per 16-row query tile, the key tile staged as f32
// in dynamic shared memory, eight threads a row); the wrapper counts these
// launches apart (mha.cuda_core_launches). Built without --use_fast_math
// (IEEE expf, tanhf and division where the kernels do not say otherwise).

#include "decode_fold.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// --- D <= 128: tensor cores ---------------------------------------------------------

__device__ __forceinline__ unsigned sm_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ``bytes`` (0..16; the rest zero-filled) from global to 16 bytes of shared memory.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm_addr(p)));
}

// c += a . b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The tiling of an instance: four warps a block, RW = 4 / KW groups of 16
// query rows, KW warps a group splitting each tile's keys (KW = 1: a block
// of 64 rows, each warp its own 16 rows of every key; KW = 4: a block of
// 16 rows, each warp scoring its own BK keys of a 4 BK-key tile). BK: 64
// keys for bf16, 32 for f32 (whose tile is also split into TF32 parts, a
// second plane of K and V in shared memory); half that at DP 128 with KW =
// 4.
template <int DP, typename T, int KW>
struct TcShape {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int RW = 4 / KW;  // warps of query rows
  static constexpr int ROWS = 16 * RW;
  static constexpr int BK = (F32 ? 32 : 64) / (KW == 4 && DP == 128 ? 2 : 1);
  static constexpr int TK = KW * BK;  // keys a tile
  // Elements a shared row: DP plus 16 bytes (bf16: the eight rows an
  // ldmatrix reads start in eight bank groups; f32: the same, and V's
  // column reads, rows 2t and 2t + 1 of a quad, in 32 banks).
  static constexpr int PITCH = DP + (F32 ? 4 : 8);
  static constexpr int ROW_BYTES = PITCH * (int)sizeof(T);
  static constexpr int KV_BYTES = 2 * TK * ROW_BYTES;  // a K and a V tile
  // The query tile, two K/V buffers, (f32) the small parts of the tile in use.
  static constexpr int SMEM = ROWS * ROW_BYTES + (F32 ? 3 : 2) * KV_BYTES;
};

// Copies rows [r0, r0 + n) of a [.., D] tensor (row stride st elements) into
// ``dst`` (rows PITCH elements apart), rows past ``valid`` and dims past D
// zero; 16-byte copies when ``vec`` (rows 16-byte aligned), else 4-byte ones
// (f32 elements, bf16 pairs). Threads ``tid`` of ``nthreads``.
template <int DP, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long st, int r0, int n,
                                          int valid, int D, bool vec, int tid, int nthreads) {
  using TS = TcShape<DP, T, 1>;
  constexpr int EL = (int)sizeof(T);
  const int row_bytes = D * EL;
  if (vec) {
    constexpr int CPR = DP * EL / 16;  // 16-byte chunks a row
    for (int i = tid; i < n * CPR; i += nthreads) {
      const int r = i / CPR, c = i % CPR, row = r0 + r;
      const int bytes = row < valid ? max(0, min(16, row_bytes - 16 * c)) : 0;
      const unsigned char* s = reinterpret_cast<const unsigned char*>(src + row * st) + 16 * c;
      cp16(reinterpret_cast<unsigned char*>(dst + r * TS::PITCH) + 16 * c,
           bytes ? s : reinterpret_cast<const unsigned char*>(src), bytes);
    }
  } else {
    constexpr int WPR = DP * EL / 4;  // 4-byte words a row
    for (int i = tid; i < n * WPR; i += nthreads) {
      const int r = i / WPR, w = i % WPR, row = r0 + r;
      const bool in = row < valid && 4 * w < row_bytes;
      const unsigned char* s = reinterpret_cast<const unsigned char*>(src + row * st) + 4 * w;
      cp4(reinterpret_cast<unsigned char*>(dst + r * TS::PITCH) + 4 * w,
          in ? s : reinterpret_cast<const unsigned char*>(src), in);
    }
  }
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 0 far below -126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

template <int DP, typename T, int KW>
__global__ void __launch_bounds__(128) mha_tc_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ mask, long long m_sq, long long m_sk,
    T* __restrict__ out, long long o_sb, long long o_sh, long long o_st,
    int Hq, int Hkv, int Tq, int Tk, int D, int causal, float softcap, float scale, int vec) {
  using TS = TcShape<DP, T, KW>;
  constexpr bool F32 = TS::F32;
  constexpr int BK = TS::BK, TK = TS::TK, P = TS::PITCH, ROWS = TS::ROWS;
  constexpr int NT = BK / 8;  // 8-key n-tiles of a warp's score block
  constexpr int DT = DP / 8;  // 8-dim n-tiles of the output
  constexpr int NTHREADS = 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);
  T* kv0 = reinterpret_cast<T*>(tc_smem + ROWS * TS::ROW_BYTES);
  T* small = kv0 + 4 * TK * P;  // f32: the small TF32 parts of the tile in use (K, then V)

  const int nqt = (Tq + ROWS - 1) / ROWS;
  const int qt = nqt - 1 - (int)blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int r0 = qt * ROWS;
  const int offset = Tk - Tq;  // the causal band is anchored at the KV end
  const int last_row = min(Tq - 1, r0 + ROWS - 1);
  const int kmax = causal ? min(Tk - 1, last_row + offset) : Tk - 1;
  const int ntiles = kmax < 0 ? 0 : kmax / TK + 1;
  const bool vq = vec != 0;
  // The warp's rows (16 of the block's) and keys (BK of each tile).
  const int wr = warp % TS::RW, wk = warp / TS::RW;

  // The query tile and the first K/V tile: one group.
  copy_rows<DP, T>(qs, qb, q_st, r0, ROWS, Tq, D, vq, tid, NTHREADS);
  auto load_tile = [&](int buf, int k0) {
    T* dk = kv0 + buf * 2 * TK * P;
    copy_rows<DP, T>(dk, kb, k_st, k0, TK, Tk, D, vq, tid, NTHREADS);
    copy_rows<DP, T>(dk + TK * P, vb, v_st, k0, TK, Tk, D, vq, tid, NTHREADS);
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();

  const int w0 = r0 + 16 * wr;  // the warp's first row
  const int wlast = min(Tq - 1, w0 + 15);
  const bool warp_live = w0 < Tq;
  const int rows[2] = {w0 + g, w0 + g + 8};
  // The mask rows of the lane's two rows (rows past Tq, whose outputs are
  // not written, read the last one).
  const float* mrow[2] = {mask + (long long)min(rows[0], Tq - 1) * m_sq,
                          mask + (long long)min(rows[1], Tq - 1) * m_sq};

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // The lane's ldmatrix rows: the warp's query rows 0-7 / 8-15 (A
  // fragments), at dims 0 / 4 (f32) or 0 / 8 (bf16) of a step.
  const T* q_l = qs + (16 * wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
                 (F32 ? 4 : 8) * (lane >> 4);

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();  // tile it has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile it - 1 is consumed
    if (it + 1 < ntiles) load_tile(buf ^ 1, (it + 1) * TK);
    cp_async_commit();
    T* tkt = kv0 + buf * 2 * TK * P;  // the tile's K; its V at + TK rows
    if constexpr (F32) {
      // The tile's TF32 parts, once for every warp: big in place, small
      // beside it.
      constexpr int Q4 = DP / 4;  // float4 a row
      for (int i = tid; i < 2 * TK * Q4; i += NTHREADS) {
        const int r = i / Q4, c = i % Q4;  // rows of K, then of V
        float4* src = reinterpret_cast<float4*>(tkt + r * P + 4 * c);
        const float4 x = *src;
        uint32_t bg[4], sm[4];
        split_tf32(__float_as_uint(x.x), bg[0], sm[0]);
        split_tf32(__float_as_uint(x.y), bg[1], sm[1]);
        split_tf32(__float_as_uint(x.z), bg[2], sm[2]);
        split_tf32(__float_as_uint(x.w), bg[3], sm[3]);
        *src = make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                           __uint_as_float(bg[2]), __uint_as_float(bg[3]));
        *reinterpret_cast<float4*>(small + r * P + 4 * c) =
            make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]), __uint_as_float(sm[2]),
                        __uint_as_float(sm[3]));
      }
      __syncthreads();  // the parts are whole
    }
    // The warp's keys: k0 .. k0 + BK - 1, rows wk * BK of the tile.
    const int k0 = it * TK + wk * BK;
    const T* tk = tkt + wk * BK * P;
    const T* tv = tkt + (TK + wk * BK) * P;
    const T* sk = small + wk * BK * P;         // f32: K's small parts
    const T* sv = small + (TK + wk * BK) * P;  // ... and V's
    // The warp's last key in this tile: 16-key pairs past it hold no
    // column of its rows and are skipped.
    const int kw = causal ? min(BK - 1, wlast + offset - k0) : BK - 1;
    if (!warp_live || kw < 0 || k0 >= Tk) continue;

    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    if constexpr (F32) {
      // S = Q K^T in 3xTF32, 8 dims a step. Q's fragment from ldmatrix of
      // the f32 words (lane: row g / g + 8, dim t / t + 4), split here; K's
      // parts (keys g of two n-tiles, dims t and t + 4) from the planes.
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        uint32_t qa[4], qbig[4], qsml[4];
        ldsm_x4(qa, q_l + kk * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qa[i], qbig[i], qsml[i]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 > kw) continue;
          const int off = (n * 8 + 8 * (lane >> 4) + (lane & 7)) * P + kk * 8 + 4 * ((lane >> 3) & 1);
          uint32_t kbig[4], ksml[4];
          ldsm_x4(kbig, tk + off);
          ldsm_x4(ksml, sk + off);
          mma_3xtf32(sacc[n], qbig, qsml, kbig[0], kbig[1], ksml[0], ksml[1]);
          mma_3xtf32(sacc[n + 1], qbig, qsml, kbig[2], kbig[3], ksml[2], ksml[3]);
        }
      }
    } else {
      // S = Q K^T in bf16, 16 dims a step.
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, q_l + kk * 16);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 > kw) continue;
          const int key = n * 8 + 8 * (lane >> 4) + (lane & 7);
          const int dim = kk * 16 + 8 * ((lane >> 3) & 1);
          uint32_t bk[4];
          ldsm_x4(bk, tk + key * P + dim);
          mma_bf16(sacc[n], qa, bk[0], bk[1]);
          mma_bf16(sacc[n + 1], qa, bk[2], bk[3]);
        }
      }
    }

    // Scale, softcap, mask, the online softmax of rows g (e < 2) and g + 8.
    // Only a tile with a column past Tk or past the causal band of one of
    // the warp's rows tests each column; rows past Tq are not written.
    // The mask's values are loaded first, all at once (columns past Tk
    // read the last one).
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > w0 + offset);
    float madd[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        madd[n][e] = mask ? __ldg(mrow[e >> 1] + min(k0 + n * 8 + 2 * t + (e & 1), Tk - 1) * m_sk)
                          : 0.f;
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float s = sacc[n][e] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s += madd[n][e];
        if (edge && !(col < Tk && (!causal || col <= rows[e >> 1] + offset))) s = NEG_INF;
        sacc[n][e] = s;
        mt[e >> 1] = fmaxf(mt[e >> 1], s);
      }
    }
    float alpha[2], mb[2], psum[2] = {0.f, 0.f};
    bool empty[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      empty[i] = m_new <= NEG_INF / 2;
      alpha[i] = m[i] <= NEG_INF / 2 ? 0.f : exp2_approx((m[i] - m_new) * LOG2E);
      mb[i] = m_new * LOG2E;  // p = 2^(s log2(e) - m log2(e))
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = empty[e >> 1] ? 0.f : exp2_approx(fmaf(sacc[n][e], LOG2E, -mb[e >> 1]));
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

    if constexpr (F32) {
      // O += P V in 3xTF32, 8 keys a step in the order 2t, 2t + 1 of the
      // score accumulator: a0 = P[g][2t], a1 = P[g + 8][2t], a2 = P[g][2t +
      // 1], a3 = P[g + 8][2t + 1]; V's B fragment rows 2t, 2t + 1, column g,
      // from both planes.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 > kw) continue;
        const uint32_t pa[4] = {__float_as_uint(sacc[n][0]), __float_as_uint(sacc[n][2]),
                                __float_as_uint(sacc[n][1]), __float_as_uint(sacc[n][3])};
        uint32_t pbig[4], psml[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(pa[i], pbig[i], psml[i]);
        const int off = (n * 8 + 2 * t) * P + g;
        const float* vr = reinterpret_cast<const float*>(tv) + off;
        const float* vs = reinterpret_cast<const float*>(sv) + off;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          mma_3xtf32(o[j], pbig, psml, __float_as_uint(vr[j * 8]), __float_as_uint(vr[P + j * 8]),
                     __float_as_uint(vs[j * 8]), __float_as_uint(vs[P + j * 8]));
      }
    } else {
      // O += bf16(P) V, 16 keys a step: the score accumulators of n-tiles
      // 2kk and 2kk + 1 are the A fragment.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (kk * 16 > kw) continue;
        const uint32_t pa[4] = {bf16x2(sacc[2 * kk][0], sacc[2 * kk][1]),
                                bf16x2(sacc[2 * kk][2], sacc[2 * kk][3]),
                                bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                                bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          const int key = kk * 16 + 8 * ((lane >> 3) & 1) + (lane & 7);
          const int dim = j * 8 + 8 * (lane >> 4);
          uint32_t bv[4];
          ldsm_x4_trans(bv, tv + key * P + dim);
          mma_bf16(o[j], pa, bv[0], bv[1]);
          mma_bf16(o[j + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KW > 1) {
    // The states of the KW warps with the same rows, merged by the first
    // (wk = 0) in warp order: m = max m_w, l = sum l_w 2^((m_w - m) log2 e),
    // o likewise. Each lane's state goes to shared memory in its own layout
    // (lane-minor), slot (wk - 1) * RW + wr.
    constexpr int SW = DT * 4 + 4;  // floats a lane's state
    float* st = reinterpret_cast<float*>(kv0);
    __syncthreads();  // every warp is done with the tiles
    if (wk > 0) {
      float* my = st + ((wk - 1) * TS::RW + wr) * SW * 32 + lane;
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) my[(4 * j + e) * 32] = o[j][e];
      my[(4 * DT) * 32] = m[0];
      my[(4 * DT + 1) * 32] = m[1];
      my[(4 * DT + 2) * 32] = l[0];
      my[(4 * DT + 3) * 32] = l[1];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      const float* ot = st + ((w - 1) * TS::RW + wr) * SW * 32 + lane;
      float sa[2], sb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mw = ot[(4 * DT + i) * 32], lw = ot[(4 * DT + 2 + i) * 32];
        const float mn = fmaxf(m[i], mw);
        sa[i] = m[i] <= NEG_INF / 2 ? 0.f : exp2_approx((m[i] - mn) * LOG2E);
        sb[i] = mw <= NEG_INF / 2 ? 0.f : exp2_approx((mw - mn) * LOG2E);
        l[i] = l[i] * sa[i] + lw * sb[i];
        m[i] = mn;
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = o[j][e] * sa[e >> 1] + ot[(4 * j + e) * 32] * sb[e >> 1];
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= Tq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
    for (int j = 0; j < DT; ++j) {  // D even: dims in pairs
      const int d = j * 8 + 2 * t;
      if (d >= D) continue;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
      } else {
        *reinterpret_cast<uint32_t*>(orow + d) = bf16x2(o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
      }
    }
  }
}

// --- D 129-256: CUDA cores ------------------------------------------------------------

// The tiling at head-dim instance DP: TPR threads share a query row (4 up to
// D 128, 8 beyond), QT = 128 / TPR query rows a block, BK key columns a
// tile; shared memory holds the query tile and one K and V tile as f32,
// padded by one column, beside the tile's probabilities.
template <int DP>
struct SimtTile {
  static constexpr int TPR = DP <= 128 ? 4 : 8;
  static constexpr int QT = 128 / TPR;
  static constexpr int BK = DP <= 64 ? 32 : 16;
  static constexpr int SMEM =
      (int)sizeof(float) * (QT * (DP + 1) + 2 * BK * (DP + 1) + QT * (BK + 1));
};


template <int DP, typename T>
__global__ void __launch_bounds__(128) mha_simt_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ mask, long long m_sq, long long m_sk,
    T* __restrict__ out, long long o_sb, long long o_sh, long long o_st,
    int Hq, int Hkv, int Tq, int Tk, int D, int causal, float softcap, float scale) {
  constexpr int TPR = SimtTile<DP>::TPR, QT = SimtTile<DP>::QT;
  constexpr int BK = SimtTile<DP>::BK;  // key columns per tile
  constexpr int DPT = DP / TPR;        // output dims per thread
  constexpr int CPT = BK / TPR;        // score columns per thread
  extern __shared__ float smem[];
  float (*Qs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem);
  float (*Ks)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + QT * (DP + 1));
  float (*Vs)[DP + 1] = reinterpret_cast<float (*)[DP + 1]>(smem + (QT + BK) * (DP + 1));
  float (*Ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(smem + (QT + 2 * BK) * (DP + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / TPR, sub = tid % TPR;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int r0 = qt * QT;
  const int offset = Tk - Tq;  // the causal band is anchored at the KV end

  for (int idx = tid; idx < QT * DP; idx += 128) {
    const int rr = idx / DP, d = idx % DP, row = r0 + rr;
    Qs[rr][d] = row < Tq && d < D ? to_f32(qb[row * q_st + d]) : 0.f;
  }
  const int last_row = min(Tq - 1, r0 + QT - 1);
  const int kmax = causal ? min(Tk - 1, last_row + offset) : Tk - 1;
  const int row = r0 + r;
  const bool row_valid = row < Tq;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 <= kmax; k0 += BK) {
    __syncthreads();  // Qs ready / the previous tile consumed
    for (int idx = tid; idx < BK * DP; idx += 128) {
      const int c = idx / DP, d = idx % DP, col = k0 + c;
      const bool in = col < Tk && d < D;
      Ks[c][d] = in ? to_f32(kb[col * k_st + d]) : 0.f;
      Vs[c][d] = in ? to_f32(vb[col * v_st + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
    float mt = NEG_INF;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = sub + TPR * i, col = k0 + c;
      float s = row_dot<DP>(Qs[r], Ks[c]) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool ok = row_valid && col < Tk && (!causal || col <= row + offset);
      if (ok && mask) s += mask[row * m_sq + col * m_sk];
      sc[i] = ok ? s : NEG_INF;
      mt = fmaxf(mt, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    const float m_new = fmaxf(m, mt);
    const bool empty = m_new <= NEG_INF / 2;
    const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float p = empty ? 0.f : expf(sc[i] - m_new);
      Ps[r][sub + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l = l * alpha + psum;
    __syncwarp();  // a row's four threads share a warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r][c];
      if (p != 0.f) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[c][sub + TPR * i], acc[i]);
      }
    }
    m = m_new;
  }
  if (row_valid) {
    const float denom = l == 0.f ? 1.f : l;
    T* o = out + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      if (sub + TPR * i < D) store(o + sub + TPR * i, acc[i] / denom);
    }
  }
}

// The dynamic shared memory a kernel may use: raised once per device (and
// again only for more), as the attribute is per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, int (&allowed)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

struct MhaArgs {
  const void *q, *k, *v, *mask;
  void* out;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, m_sq, m_sk, o_sb, o_sh, o_st;
  int B, Hq, Hkv, Tq, Tk, D, causal;
  float softcap, scale;
  int vec;
};

template <int DP, typename T, int KW>
cudaError_t launch_tc(const MhaArgs& x, cudaStream_t st) {
  static int allowed[64];
  using TS = TcShape<DP, T, KW>;
  const cudaError_t e = allow_smem(mha_tc_kernel<DP, T, KW>, TS::SMEM, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((x.Tq + TS::ROWS - 1) / TS::ROWS, x.Hq, x.B);
  mha_tc_kernel<DP, T, KW><<<grid, 128, TS::SMEM, st>>>(
      (const T*)x.q, x.q_sb, x.q_sh, x.q_st, (const T*)x.k, x.k_sb, x.k_sh, x.k_st,
      (const T*)x.v, x.v_sb, x.v_sh, x.v_st, (const float*)x.mask, x.m_sq, x.m_sk, (T*)x.out,
      x.o_sb, x.o_sh, x.o_st, x.Hq, x.Hkv, x.Tq, x.Tk, x.D, x.causal, x.softcap, x.scale, x.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const MhaArgs& x, cudaStream_t st) {
  static int allowed[64];
  constexpr int smem = SimtTile<256>::SMEM;
  const cudaError_t e = allow_smem(mha_simt_kernel<256, T>, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((x.Tq + SimtTile<256>::QT - 1) / SimtTile<256>::QT, x.Hq, x.B);
  mha_simt_kernel<256, T><<<grid, 128, smem, st>>>(
      (const T*)x.q, x.q_sb, x.q_sh, x.q_st, (const T*)x.k, x.k_sb, x.k_sh, x.k_st,
      (const T*)x.v, x.v_sb, x.v_sh, x.v_st, (const float*)x.mask, x.m_sq, x.m_sk, (T*)x.out,
      x.o_sb, x.o_sh, x.o_st, x.Hq, x.Hkv, x.Tq, x.Tk, x.D, x.causal, x.softcap, x.scale);
  return cudaGetLastError();
}

template <typename T, int KW>
cudaError_t tc_by_dim(const MhaArgs& x, cudaStream_t st) {
  return x.D <= 64 ? launch_tc<64, T, KW>(x, st) : launch_tc<128, T, KW>(x, st);
}

template <typename T>
cudaError_t by_form(const MhaArgs& x, int key_warps, cudaStream_t st) {
  if (x.D > 128) return launch_simt<T>(x, st);
  if (key_warps == 1) return tc_by_dim<T, 1>(x, st);
  if (key_warps == 2) return tc_by_dim<T, 2>(x, st);
  if (key_warps == 4) return tc_by_dim<T, 4>(x, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: unit-stride rows of D elements (dtype 0 = f32, 1 = bf16),
// addressed through batch, head and row strides (in elements). mask: an
// additive f32 [Tq, Tk] through strides (0 broadcasts), or null. D <= 128
// runs on tensor cores in blocks of four warps, ``key_warps`` of which (1
// or 4) split each tile's keys, with 16-byte copies where ``vec`` (q, k and
// v rows 16-byte aligned) and 4-byte ones otherwise (bf16 rows 4-byte
// aligned); D 129-256 on CUDA cores. Returns the launch's CUDA error code
// (0 on success).
extern "C" int rten_mha(int dtype, const void* q, long long q_sb, long long q_sh,
                        long long q_st, const void* k, long long k_sb, long long k_sh,
                        long long k_st, const void* v, long long v_sb, long long v_sh,
                        long long v_st, const void* mask, long long m_sq, long long m_sk,
                        void* out, long long o_sb, long long o_sh, long long o_st,
                        int B, int Hq, int Hkv, int Tq, int Tk, int D, int causal,
                        float softcap, float scale, int key_warps, int vec, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv || (dtype != 0 && dtype != 1) ||
      D < 2 || D % 2 || D > 256)
    return (int)cudaErrorInvalidValue;
  const MhaArgs x{q, k, v, mask, out, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                  m_sq, m_sk, o_sb, o_sh, o_st, B, Hq, Hkv, Tq, Tk, D, causal, softcap, scale,
                  vec};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? by_form<float>(x, key_warps, st)
                          : by_form<__nv_bfloat16>(x, key_warps, st));
}
