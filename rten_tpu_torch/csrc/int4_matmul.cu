// int4 block-dequant matrix product (MatMulNBits) for Hopper (sm_90a):
// out[M, N] = a[M, K] . W[N, K]^T in f32, W held as packed nibbles.
//
// Replaces: rten_tpu/kernels/int4_matmul.py:97, int4_matmul_pallas (Pallas
// body _kernel). Weights keep MatMulNBits' layout: row n is K / 2 bytes,
// byte p holding k = 2p in its low nibble and k = 2p + 1 in its high one;
// scales [N, nb] f32 and optional zero points [N, nb] int32 in [0, 15] (the
// wrapper unpacks u8-packed ones; none means the constant 8), nb = K /
// block_size. W[n, k] = (nibble - zp[n, blk]) * s[n, blk]. The wrapper
// zero-pads a to K = nb * block_size, so K is a multiple of the block size.
// The reference runs the product at HIGHEST precision (f32).
//
// Bound on the H100: at decode (M = 1 for the Generator, 16 for the serving
// engine) a call streams the packed weight once (K * N / 2 bytes plus 4 * N
// * nb of scales), so bytes bound it: one GPT-2 124M forward's 49 products
// read 61.8 MB of nibbles and 15.4 MB of scales, 23 us at 3.35 TB/s. At 128
// rows and more the product's 2 * M * K * N operations bind, at the bf16
// tensor-core rate (989 TFLOP/s) the kernels run it on.
//
// Arithmetic (that of decode_heads_tc.cuh). The code nibble - zp lies in
// [-15, 15] and is exact in bf16; it is made with bit tricks (0x4300 | n is
// the bf16 128 + n; subtracting the bf16 128 + zp leaves n - zp exactly),
// eight codes from one 32-bit word. a enters as three bf16 parts, hi =
// bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid), about 24 bits
// together, so each product is three mma.sync.m16n8k16 (bf16 x bf16 is
// exact in f32, f32 accumulation). For each quantization block the three
// products accumulate Sum a * code into a per-block fragment, which is then
// folded into the output, acc += s[n, blk] * partial: the scale multiplies a
// sum, not each weight. Against int4_matmul_plain (dequantize, then an f32
// product) the result stays within about 1.5e-6 of max|out| (measured on the
// card: PERF.md, kernel row 9); on the CPU the emulation of three parts
// lands within 1e-6, two parts at 2-3e-6 (tests/test_torch_int4_tc.py).
//
// Contraction order. A dot product does not change under a permutation of
// k shared by both operands, so within each group of 8 k the kernels take
// the order (0, 4, 1, 5, 2, 6, 3, 7): the nibble pairs (k, k + 4) of one
// 32-bit word are the low nibbles of its bytes under one shift and mask
// (word >> 4j, 0x000F000F), four pairs a word, and the activations are
// stored in that order once. Groups of 8 k never straddle a quantization
// block (block_size is a multiple of 16).
//
// Three kernels; the wrapper's int4_form picks one from M and block_size:
// * int4_stream_kernel, M <= 16 (a serve decode step, a Generator step):
//   weight-streaming. The M rows are the n8 side of the product (one or two
//   n8 tiles), 16 weight columns the m16 side, so the thread that holds a
//   weight row's codes also holds its outputs and scales. A 128-thread block
//   owns 64 columns (16 a warp) and a split of K; it stages the split's
//   activations, three bf16 parts in the order above, in shared memory
//   once, behind one barrier. Each warp then streams its 16 rows through a
//   ring of 8 stages of 64 k (16 rows x 32 bytes of nibbles, one 16-byte
//   cp.async a lane, with the stage's scales and zero points), waiting on
//   its own copies only (cp.async.wait_group, __syncwarp): no barrier per
//   chunk. ldmatrix hands each lane one word of a 32-k chunk of rows g and
//   g + 8 (a hardware 4 x 4 transpose: the four lanes of a row then hold
//   the same chunk). With block_size 16 a chunk spans two blocks and runs
//   as two passes, each lane's codes masked to its block. Where the column
//   tiles alone do not fill the SMs (GPT-2's N 768 projections: 12 tiles),
//   K is split over blocks (int4_split_plan, from the shapes only); each
//   block writes its partial tile to a workspace, and the last block of a
//   column tile to arrive (an acquire-release counter, as in argmax.cu)
//   sums the splits in split order, so two calls give the same bits.
// * int4_tiled_kernel, M > 16 (a Generator prefill, a serve admission): a
//   64 x 128 output tile a 256-thread block (eight warps of 32 rows x 32
//   columns), 64 k a stage. The stage's activations (f32), nibbles, scales
//   and zero points are staged by cp.async into a ring of three stages; the
//   block splits the stage's activations into three bf16 parts in shared
//   memory (one barrier), which ldmatrix reads, while each warp takes its
//   codes straight from ldmatrix on the raw nibble rows and widens them in
//   registers. Each B fragment (codes) feeds two m16 tiles in three parts,
//   each A fragment four n8 tiles. The per-block fragment folds at each
//   block's last k16 step. The same split-K plan and last-block merge fill
//   the card at M 128 (GPT-2's N 768 projections again).
// * int4_simt_kernel: block sizes that are no multiple of 16 (8, which the
//   wrapper takes but MatMulNBits does not emit), on CUDA cores: a 64 x 64
//   f32 tile, each weight dequantized as (float)(nibble - zp) * s.
// Every kernel masks the ragged edges (M; N, the lm_head's 50257; K past
// the split). No float atomics: outputs are written once.
//
// mma.sync, not wgmma: the per-block fold needs the partial sums in
// registers between blocks of 32 k (a wgmma accumulates a whole 64-wide
// k-tile before the registers can be read), and decode_heads_tc.cuh's
// kernel ran slower on wgmma than on mma.sync at these sizes (PERF.md,
// kernel row 6b).
//
// Built without --use_fast_math, like the other kernels of the port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>

namespace {

// --- helpers --------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ``bytes`` (0..16; the rest zero-filled) from global to 16 bytes of shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// SIZE (4, 8 or 16) bytes, ``bytes`` of them read (the rest zero-filled).
template <int SIZE>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int bytes) {
  if constexpr (SIZE == 16)
    cp_async16(dst, src, bytes);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(SIZE), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 f32.
// Not volatile: a pure function of its registers, so the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a . b (no accumulator to read: a block's first product).
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as three bf16 pairs whose sum is x to about 24 bits (each
// difference is exact in f32).
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

// Eight activations (k 0..7 of a group) -> their three parts, each as four
// bf16 pairs in the contraction order: (x0, x4), (x1, x5), (x2, x6), (x3, x7).
__device__ __forceinline__ void split3_group(const float (&x)[8], uint4 (&p)[3]) {
  uint32_t q[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) split3_bf16x2(x[j], x[j + 4], q[j]);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = make_uint4(q[0][i], q[1][i], q[2][i], q[3][i]);
}

// 128 + zp as a bf16 pair (exact for zp in [0, 127]).
__device__ __forceinline__ uint32_t zp_pair(int zp) {
  const uint32_t h = 0x4300u + (uint32_t)zp;
  return h | (h << 16);
}

// The bf16 pair j of the codes nibble - zp of one 32-bit word of packed
// nibbles (k 0..7 of a group; byte p holds k 2p low, 2p + 1 high): (k j, k
// j + 4), the contraction order. ``zz`` is zp_pair(zp).
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int j, uint32_t zz) {
  const uint32_t x = ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
  return bf16x2_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&zz)));
}

// A word's four code pairs: (k0, k4), (k1, k5), (k2, k6), (k3, k7).
__device__ __forceinline__ void widen8(uint32_t w, uint32_t zz, uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = code_pair(w, j, zz);
}

// Scale-entries a stage row holds: the quantization blocks that 64 k can touch.
constexpr int KSTAGE = 64;  // k a pipeline stage (both tensor-core forms): 32 bytes a weight row

// Block sizes have instances of their own (16, 32, 64, 128: every division
// by the block size a shift), and BS = 0 an instance for any other multiple
// of 16, read at run time.
template <int BS>
__device__ __forceinline__ int block_size(int bs) {
  return BS ? BS : bs;
}

// Scale entries a stage row holds: the quantization blocks 64 k touch.
__host__ __device__ __forceinline__ int stage_blocks(int BS, int bs) {
  return BS ? (BS < KSTAGE ? KSTAGE / BS : 1) : 63 / bs + 2;
}

// The split-K merge. Every thread has written its share of the block's
// partial tile to ``ws`` (split-major, [splits][M][N]); the block's last
// arrival for tile ``tile`` sums rows [m0, m0 + rows) x columns [n0, n0 +
// COLS) over the splits in split order into ``out`` and resets the
// counter. The barrier orders the block's partial stores before thread
// 0's acquire-release increment, which makes them visible to the block
// that finds the count complete (cumulativity; no fence per thread). Each
// thread sums four columns at a time, U such units at once with four
// splits' loads of each in flight before any is added.
template <int U, int COLS>
__device__ __forceinline__ void merge_splits(const float* ws, float* out, unsigned* count,
                                             int tile, int splits, int M, int N, int m0, int rows,
                                             int n0, bool& last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(count[tile]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  const long long plane = (long long)M * N;
  if (N % 4 == 0) {
    constexpr int CQ = COLS / 4;  // four-column units a row
    const int units = rows * CQ;
    for (int u0 = threadIdx.x; u0 < units; u0 += U * blockDim.x) {
      const float* src[U];
      float* dst[U];
      float4 sum[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = u0 + u * blockDim.x, m = m0 + idx / CQ, n = n0 + 4 * (idx % CQ);
        const bool in = idx < units && m < M && n < N;
        src[u] = in ? ws + (long long)m * N + n : nullptr;
        dst[u] = in ? out + (long long)m * N + n : nullptr;
        sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int sp0 = 0; sp0 < splits; sp0 += 4) {
        const int nj = min(4, splits - sp0);
        float4 v[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (src[u] && j < nj) v[u][j] = __ldcg(reinterpret_cast<const float4*>(src[u] + j * plane));
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (src[u] && j < nj) {
              sum[u].x += v[u][j].x;
              sum[u].y += v[u][j].y;
              sum[u].z += v[u][j].z;
              sum[u].w += v[u][j].w;
            }
          if (src[u]) src[u] += 4 * plane;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (dst[u]) *reinterpret_cast<float4*>(dst[u]) = sum[u];
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * COLS; idx += blockDim.x) {
      const int m = m0 + idx / COLS, n = n0 + idx % COLS;
      if (m >= M || n >= N) continue;
      const long long off = (long long)m * N + n;
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(ws + sp * plane + off);
      out[off] = s;
    }
  }
  if (threadIdx.x == 0) count[tile] = 0u;  // ready for the next call on this workspace
}

// --- M <= 16: the stream form -----------------------------------------------------

constexpr int ST_WARPS = 4;
constexpr int ST_THREADS = 32 * ST_WARPS;
constexpr int ST_COLS = 16 * ST_WARPS;  // weight columns a block
constexpr int ST_STAGES = 8;            // stages in flight a warp

__host__ __device__ __forceinline__ int st_stage_bytes(int sb, bool zp) {
  return 16 * 32 + 16 * sb * 4 * (zp ? 2 : 1);
}

// Shared memory: the activations' three parts [3][M][pitch] (pitch bytes a
// row: 2 * kchunk + 64, so the rows two lane groups read at once fall in
// other banks), then each warp's ring of ST_STAGES stages: nibbles [16][32]
// (16-byte halves swizzled by row so that ldmatrix's eight rows hit eight
// bank groups), scales [16][sb], zero points [16][sb]. Every address a lane
// copies from or reads is set once per column tile and advanced by
// additions: the loop is bound by instructions, not by the copies.
template <int NT, int BS>
__global__ void __launch_bounds__(ST_THREADS) int4_stream_kernel(
    const float* __restrict__ a, long long lda, const uint8_t* __restrict__ b,
    const float* __restrict__ scales, const int32_t* __restrict__ zps, float* __restrict__ out,
    float* __restrict__ ws, unsigned* __restrict__ count, int M, int N, int K, int bs,
    int kchunk, int splits, int vec_b, int vec_s) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  // Scale entries a stage row holds where the copy is one vector (block
  // sizes 16, 32, 64); 0: entry by entry.
  constexpr int SBV = BS > 0 && BS <= KSTAGE ? KSTAGE / (BS > 0 ? BS : 1) : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bsz = block_size<BS>(bs);
  const int split = blockIdx.y;
  const int kb0 = split * kchunk, kend = min(K, kb0 + kchunk);
  const int nb = K / bsz;
  const long long row_bytes = K / 2;
  const int pitch = 2 * kchunk + 64;
  const int part = M * pitch;
  const int sb = stage_blocks(BS, bs);
  const bool has_zp = zps != nullptr;
  const int stage_bytes = st_stage_bytes(sb, has_zp);
  unsigned char* act = st_smem;
  unsigned char* ring = st_smem + 3 * part + warp * ST_STAGES * stage_bytes;
  const int ncg = (N + ST_COLS - 1) / ST_COLS;
  const int nstages = (kend - kb0 + KSTAGE - 1) / KSTAGE;
  const bool fast_s = SBV > 0 && vec_s;

  // The lane's copies: weight row lane / 2, 16-byte half lane % 2 (and, on
  // the vector path, the scales of row lane < 16).
  const int cr = lane >> 1, ch = lane & 1;
  const int w_dst = cr * 32 + ((ch ^ ((cr >> 2) & 1)) * 16);
  const uint8_t* w_src = b;
  const float* s_src = scales;
  const int32_t* z_src = zps;
  bool w_in = false, s_in = false;
  auto set_tile = [&](int n0) {
    w_in = vec_b && n0 + cr < N;
    w_src = w_in ? b + (n0 + cr) * row_bytes + 16 * ch + kb0 / 2 : b;
    s_in = fast_s && lane < 16 && n0 + lane < N;
    const long long so = s_in ? (long long)(n0 + lane) * nb + kb0 / bsz : 0;
    s_src = scales + so;
    if (has_zp) z_src = zps + so;
  };
  // Stage st of the warp's rows from column n0: k [kb0 + 64 st, + 64) into
  // slot st % ST_STAGES.
  auto load_stage = [&](int n0, int st) {
    unsigned char* dst = ring + (st % ST_STAGES) * stage_bytes;
    const int k0 = kb0 + st * KSTAGE;
    if (vec_b) {
      const int kk = k0 + 32 * ch;
      const int bytes = !w_in || kk >= kend ? 0 : kk + 32 <= kend ? 16 : (kend - kk) / 2;
      cp_async16(dst + w_dst, bytes ? w_src + st * (KSTAGE / 2) : b, bytes);
    } else {  // rows not 16-byte aligned: 4-byte words
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {
        const int r = i >> 3, wd = i & 7, n = n0 + r, kk = k0 + 8 * wd;
        const bool in = n < N && kk < kend;
        cp_async4(dst + r * 32 + (((wd >> 2) ^ ((r >> 2) & 1)) * 16) + (wd & 3) * 4,
                  in ? b + n * row_bytes + kk / 2 : b, in);
      }
    }
    float* sdst = reinterpret_cast<float*>(dst + 16 * 32);
    int32_t* zdst = reinterpret_cast<int32_t*>(sdst + 16 * sb);
    if (fast_s) {
      if constexpr (SBV > 0) {
        if (lane < 16) {
          const int valid = min(SBV, (kend - k0) / bsz);
          const int bytes = s_in ? 4 * valid : 0;
          cp_async_n<4 * SBV>(sdst + lane * SBV, bytes ? s_src + st * SBV : scales, bytes);
          if (has_zp) cp_async_n<4 * SBV>(zdst + lane * SBV, bytes ? z_src + st * SBV : zps, bytes);
        }
      }
    } else {  // entry by entry: [16][sb] from block k0 / bs on
      const int b0 = k0 / bsz;
      for (int i = lane; i < 16 * sb; i += 32) {
        const int r = i / sb, blk = b0 + i % sb, n = n0 + r;
        const bool in = n < N && blk < nb && blk * bsz < kend;
        const long long off = in ? (long long)n * nb + blk : 0;
        cp_async4(sdst + i, scales + off, in);
        if (has_zp) cp_async4(zdst + i, zps + off, in);
      }
    }
  };
  // The first ST_STAGES - 1 stages of a column tile, one commit group each.
  auto prologue = [&](int n0) {
    set_tile(n0);
#pragma unroll
    for (int st = 0; st < ST_STAGES - 1; ++st) {
      if (n0 < N && st < nstages) load_stage(n0, st);
      cp_async_commit();
    }
  };
  // The first tile's weights are in flight while the block stages the
  // split's activations, 8 k a step: three parts in the contraction order,
  // zero past the split's end.
  if ((int)blockIdx.x < ncg) prologue(blockIdx.x * ST_COLS + warp * 16);
  const int groups = kchunk / 8;
  for (int idx = threadIdx.x; idx < M * groups; idx += ST_THREADS) {
    const int m = idx / groups, q = idx % groups, k = kb0 + 8 * q;
    float x[8];
    if (k < kend) {
      const float4* src = reinterpret_cast<const float4*>(a + m * lda + k);
      const float4 u = src[0], v = src[1];
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
      x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    uint4 p[3];
    split3_group(x, p);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      *reinterpret_cast<uint4*>(act + i * part + m * pitch + q * 16) = p[i];
  }
  __syncthreads();

  // The lane's reads: ldmatrix row address (matrix lane / 8: rows g, g + 8
  // of chunks 0, 1), activation rows g + 8t at its 8-k group.
  const int lm_r = (lane & 7) + ((lane >> 3) & 1) * 8, lm_c = lane >> 4;
  const int lm_off = lm_r * 32 + ((lm_c ^ ((lm_r >> 2) & 1)) * 16);
  const unsigned char* act_l = act + g * pitch + tg * 16;
  __shared__ bool last;
  for (int cg = blockIdx.x; cg < ncg; cg += gridDim.x) {
    const int n0 = cg * ST_COLS + warp * 16;  // the warp's first column
    if (cg != (int)blockIdx.x) prologue(n0);
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

    if (n0 < N && nstages > 0) {
      for (int st = 0; st < nstages; ++st) {
        cp_async_wait<ST_STAGES - 2>();  // this lane's copies of stage st have landed
        __syncwarp();                    // ... and every lane's; stage st - 1 is consumed
        if (st + ST_STAGES - 1 < nstages) load_stage(n0, st + ST_STAGES - 1);
        cp_async_commit();

        const unsigned char* cur = ring + (st % ST_STAGES) * stage_bytes;
        const float* ssc = reinterpret_cast<const float*>(cur + 16 * 32);
        const int32_t* szp = reinterpret_cast<const int32_t*>(ssc + 16 * sb);
        const int k0 = kb0 + st * KSTAGE, b0 = k0 / bsz;
        // w[0], w[1]: word tg of rows g, g + 8 in chunk 0 (k0 .. k0 + 31);
        // w[2], w[3]: the same in chunk 1.
        uint32_t w[4];
        ldmatrix_x4(w, cur + lm_off);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kc = k0 + 32 * c;
          if (kc >= kend) break;
          const int blk_l = (kc + 8 * tg) / bsz;  // the block of this lane's 8 k
          int z0 = 8, z1 = 8;
          if (has_zp) {
            z0 = szp[g * sb + blk_l - b0];
            z1 = szp[(g + 8) * sb + blk_l - b0];
          }
          uint32_t ra[4], rb[4];  // codes of rows g and g + 8
          widen8(w[2 * c], zp_pair(z0), ra);
          widen8(w[2 * c + 1], zp_pair(z1), rb);
          // B fragments: activation row g + 8t, this lane's 8 k; .x/.y feed
          // step 0, .z/.w step 1.
          uint4 bx[NT][3];
          const unsigned char* ar = act_l + (st * 8 + c * 4) * 16;
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int p = 0; p < 3; ++p)
              bx[t][p] = g + 8 * t < M
                             ? *reinterpret_cast<const uint4*>(ar + t * 8 * pitch + p * part)
                             : make_uint4(0u, 0u, 0u, 0u);
          // One pass a quantization block of the chunk (two where block
          // size 16 puts two in it), each part into its own fragment so
          // that consecutive products are independent.
          const int bfirst = BS >= 32 ? blk_l : kc / bsz;
          const int blast = BS >= 32 ? blk_l : (min(kc + 32, kend) - 1) / bsz;
          for (int blk = bfirst; blk <= blast; ++blk) {
            const bool mine = BS >= 32 || bfirst == blast || blk_l == blk;
            float pt[NT][3][4];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const uint32_t a0 = mine ? ra[2 * s] : 0u, a1 = mine ? rb[2 * s] : 0u;
              const uint32_t a2 = mine ? ra[2 * s + 1] : 0u, a3 = mine ? rb[2 * s + 1] : 0u;
#pragma unroll
              for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int t = 0; t < NT; ++t) {
                  const uint32_t b0v = s ? bx[t][p].z : bx[t][p].x, b1v = s ? bx[t][p].w : bx[t][p].y;
                  if (s == 0)
                    mma_bf16_zero(pt[t][p], a0, a1, a2, a3, b0v, b1v);
                  else
                    mma_bf16(pt[t][p], a0, a1, a2, a3, b0v, b1v);
                }
            }
            const float s0 = ssc[g * sb + blk - b0], s1 = ssc[(g + 8) * sb + blk - b0];
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[t][e] = fmaf(e < 2 ? s0 : s1, (pt[t][0][e] + pt[t][1][e]) + pt[t][2][e],
                                 acc[t][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the ring is free for the next column tile

    // C: acc[t][e] is column n0 + g (+ 8 for e >= 2), activation row 2tg +
    // (e & 1) + 8t.
    float* dst = splits == 1 ? out : ws + split * (long long)M * N;
    if (n0 < N) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 2 * tg + (e & 1) + 8 * t, n = n0 + g + (e >> 1) * 8;
          if (m < M && n < N) dst[(long long)m * N + n] = acc[t][e];
        }
    }
    if (splits > 1)
      merge_splits<1, ST_COLS>(ws, out, count, cg, splits, M, N, 0, M, cg * ST_COLS, last);
  }
}

// --- M > 16: the tiled form ---------------------------------------------------------

constexpr int TL_THREADS = 256;
constexpr int TL_M = 64, TL_N = 128;  // the block's output tile
constexpr int TL_STAGES = 3;          // raw stages in the ring
constexpr int TL_PITCH = KSTAGE + 8;  // bf16 a row of activation parts: 16 bytes of pad

__host__ __device__ __forceinline__ int tl_stage_bytes(int sb, bool zp) {
  return TL_M * KSTAGE * 4 + TL_N * 32 + sb * TL_N * 4 * (zp ? 2 : 1);
}

// Shared memory: TL_STAGES raw stages (activations f32 [64][64], 16-byte
// chunks swizzled by row; nibbles [128][32], halves swizzled as in the
// stream form; scales [sb][128]; zero points [sb][128]), then the
// activations' three bf16 parts [3][64][TL_PITCH] of the stage in use. A
// 32-k chunk of a part's row is four 16-byte units, unit p holding pair p
// ((x p, x p+4)) of each of its four 8-k groups, so that ldmatrix hands the
// lane of column pair tg the pairs of group tg, which the lane's nibble
// word (group tg of the chunk, from ldmatrix on the raw rows) matches.
// Eight warps of 32 rows x 32 columns: 16 a SM, whose stalls hide each
// other's.
template <int BS>
__global__ void __launch_bounds__(TL_THREADS, 2) int4_tiled_kernel(
    const float* __restrict__ a, long long lda, const uint8_t* __restrict__ b,
    const float* __restrict__ scales, const int32_t* __restrict__ zps, float* __restrict__ out,
    float* __restrict__ ws, unsigned* __restrict__ count, int M, int N, int K, int bs,
    int kchunk, int splits, int vec_b) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  constexpr int NTW = TL_N / 2 / 8 / 2;  // n8 tiles a warp: 4 (its 32 columns)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 32 rows, 32 columns
  const int bsz = block_size<BS>(bs);
  const int n0 = blockIdx.x * TL_N, m0 = blockIdx.y * TL_M, split = blockIdx.z;
  const int kb0 = split * kchunk, kend = min(K, kb0 + kchunk);
  const int nb = K / bsz;
  const long long row_bytes = K / 2;
  const int sb = stage_blocks(BS, bs);
  const bool has_zp = zps != nullptr;
  const int stage_bytes = tl_stage_bytes(sb, has_zp);
  __nv_bfloat16* ap = reinterpret_cast<__nv_bfloat16*>(tl_smem + TL_STAGES * stage_bytes);
  const int nstages = (kend - kb0 + KSTAGE - 1) / KSTAGE;

  // The thread's copies, fixed for the kernel: activation rows ar + 16j (j
  // < 4), chunk ac; nibble row wr, half wh; scales of column n0 + tid (tid
  // < 128). Each stage advances the sources by additions.
  const int ar = tid >> 4, ac = tid & 15, wr = tid >> 1, wh = tid & 1;
  const int a_dst = ar * 256 + ((ac ^ (ar & 7)) * 16);
  const int w_dst = wr * 32 + ((wh ^ ((wr >> 2) & 1)) * 16);
  const long long a_step = 16 * lda;
  const float* a_src = a + (long long)(m0 + ar) * lda + kb0 + 4 * ac;
  const uint8_t* w_src = b + (long long)(n0 + wr) * row_bytes + 16 * wh + kb0 / 2;
  unsigned a_in = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) a_in |= (m0 + ar + 16 * j < M ? 1u : 0u) << j;
  const bool w_in = n0 + wr < N, s_col = tid < TL_N && n0 + tid < N;
  const long long s_off = s_col ? (long long)(n0 + tid) * nb : 0;
  auto load_stage = [&](int st) {
    unsigned char* dst = tl_smem + (st % TL_STAGES) * stage_bytes;
    const int k0 = kb0 + st * KSTAGE;
    const bool ka = k0 + 4 * ac < kend;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = ka && ((a_in >> j) & 1u);
      cp_async16(dst + a_dst + j * 16 * 256, in ? a_src + j * a_step + st * KSTAGE : a,
                 in ? 16 : 0);
    }
    unsigned char* wdst = dst + TL_M * KSTAGE * 4;
    if (vec_b) {
      const int kk = k0 + 32 * wh;
      const int bytes = !w_in || kk >= kend ? 0 : kk + 32 <= kend ? 16 : (kend - kk) / 2;
      cp_async16(wdst + w_dst, bytes ? w_src + st * (KSTAGE / 2) : b, bytes);
    } else {
#pragma unroll
      for (int i = tid; i < TL_N * 8; i += TL_THREADS) {
        const int r = i >> 3, wd = i & 7, n = n0 + r, kk = k0 + 8 * wd;
        const bool in = n < N && kk < kend;
        cp_async4(wdst + r * 32 + (((wd >> 2) ^ ((r >> 2) & 1)) * 16) + (wd & 3) * 4,
                  in ? b + n * row_bytes + kk / 2 : b, in);
      }
    }
    // Scales [sb][128] (and zero points): column n0 + tid, blocks b0 + j.
    float* sdst = reinterpret_cast<float*>(wdst + TL_N * 32);
    const int b0 = k0 / bsz;
    if (tid < TL_N) {
      for (int j = 0; j < sb; ++j) {
        const int blk = b0 + j;
        const bool in = s_col && blk < nb && blk * bsz < kend;
        cp_async4(sdst + j * TL_N + tid, in ? scales + s_off + blk : scales, in);
        if (has_zp) cp_async4(sdst + (sb + j) * TL_N + tid, in ? zps + s_off + blk : zps, in);
      }
    }
  };

  float acc[2][NTW][4], pt[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = pt[i][j][e] = 0.f;

  bool open = false;  // pt holds a block's partial sums, not yet folded
#pragma unroll
  for (int st = 0; st < TL_STAGES - 1; ++st) {
    if (st < nstages) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<TL_STAGES - 2>();  // stage st has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; stage st - 1 (its slot, the parts) is consumed
    if (st + TL_STAGES - 1 < nstages) load_stage(st + TL_STAGES - 1);
    cp_async_commit();

    const unsigned char* raw = tl_smem + (st % TL_STAGES) * stage_bytes;
    const unsigned char* wraw = raw + TL_M * KSTAGE * 4;
    const float* ssc = reinterpret_cast<const float*>(wraw + TL_N * 32);
    const int32_t* szp = reinterpret_cast<const int32_t*>(ssc + sb * TL_N);
    const int k0 = kb0 + st * KSTAGE, b0 = k0 / bsz;
    // The activations' parts: thread (row tid % 64, chunk (tid / 64) % 2,
    // groups 2h, 2h + 1 of the chunk, h = tid / 128), 16 k: words 2h, 2h + 1
    // of each unit.
    {
      const int r = tid & 63, c = (tid >> 6) & 1, h = tid >> 7;
      uint2 u[3][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // the thread's 8-k groups
        const int c16 = 8 * c + 2 * (2 * h + q);
        const float4 x0 = *reinterpret_cast<const float4*>(raw + r * 256 + ((c16 ^ (r & 7)) * 16));
        const float4 x1 =
            *reinterpret_cast<const float4*>(raw + r * 256 + (((c16 + 1) ^ (r & 7)) * 16));
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // pair j of group 2h + q -> unit j, word 2h + q
          uint32_t p3[3];
          split3_bf16x2(x[j], x[j + 4], p3);
#pragma unroll
          for (int i = 0; i < 3; ++i) (&u[i][j].x)[q] = p3[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint2*>(ap + (i * TL_M + r) * TL_PITCH + c * 32 + j * 8 + h * 4) =
              u[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kc = k0 + 32 * c;
      if (kc >= kend) break;
      // The warp's four n8 tiles' nibble words (lane: row g, word tg of the chunk).
      uint32_t wd[NTW];
      {
        const int r = wn * 32 + (lane >> 3) * 8 + (lane & 7);
        ldmatrix_x4(wd, wraw + r * 32 + ((c ^ ((r >> 2) & 1)) * 16));
      }
      const int lane_blk = (kc + 8 * tg) / bsz;  // the block of this lane's 8 k
      uint32_t zz[NTW];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        zz[nt] = zp_pair(has_zp ? szp[(lane_blk - b0) * TL_N + wn * 32 + nt * 8 + g] : 8);
      // Fold the partial sums of block blk into acc with its scales.
      auto fold = [&](int blk) {
        const int j = blk - b0;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const float2 sc =
              *reinterpret_cast<const float2*>(ssc + j * TL_N + wn * 32 + nt * 8 + 2 * tg);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][nt][0] = fmaf(sc.x, pt[mt][nt][0], acc[mt][nt][0]);
            acc[mt][nt][1] = fmaf(sc.y, pt[mt][nt][1], acc[mt][nt][1]);
            acc[mt][nt][2] = fmaf(sc.x, pt[mt][nt][2], acc[mt][nt][2]);
            acc[mt][nt][3] = fmaf(sc.y, pt[mt][nt][3], acc[mt][nt][3]);
          }
        }
        open = false;
      };
      // Each k16 step takes pairs from all four groups of the chunk: where
      // the chunk spans two blocks (block size 16), one pass a block, the
      // other block's codes zero.
      const int bfirst = kc / bsz, blast = (min(kc + 32, kend) - 1) / bsz;
      for (int blk = bfirst; blk <= blast; ++blk) {
        const bool mine = bfirst == blast || lane_blk == blk;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int kabs = kc + 16 * s;
          uint32_t af[2][3][4], bv[NTW][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int p = 0; p < 3; ++p)
              ldmatrix_x4(af[mt][p], ap + (p * TL_M + wm * 32 + mt * 16 + (lane & 15)) * TL_PITCH +
                                         c * 32 + (2 * s + (lane >> 4)) * 8);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            bv[nt][0] = mine ? code_pair(wd[nt], 2 * s, zz[nt]) : 0u;
            bv[nt][1] = mine ? code_pair(wd[nt], 2 * s + 1, zz[nt]) : 0u;
          }
          // Eight independent accumulators between two products into one;
          // the first step after a fold starts them.
          const bool fresh = !open;
          open = true;
#define RTEN_TILE_MMAS(P, MMA)                                                            \
  for (int mt = 0; mt < 2; ++mt)                                                            \
    for (int nt = 0; nt < NTW; ++nt)                                                        \
      MMA(pt[mt][nt], af[mt][P][0], af[mt][P][1], af[mt][P][2], af[mt][P][3], bv[nt][0], bv[nt][1]);
          if (fresh) {
            RTEN_TILE_MMAS(0, mma_bf16_zero)
          } else {
            RTEN_TILE_MMAS(0, mma_bf16)
          }
          RTEN_TILE_MMAS(1, mma_bf16)
          RTEN_TILE_MMAS(2, mma_bf16)
#undef RTEN_TILE_MMAS
          // A block's last k16 step (one pass): fold.
          if (bfirst == blast && ((kabs + 16) % bsz == 0 || kabs + 16 >= kend)) fold(blk);
        }
        if (bfirst != blast) fold(blk);
      }
    }
  }
  cp_async_wait<0>();

  // C: acc[mt][nt][e] is row m0 + 32wm + 16mt + g (+ 8 for e >= 2), column
  // n0 + 32wn + 8nt + 2tg + (e & 1).
  float* dst = splits == 1 ? out : ws + split * (long long)M * N;
  const bool pairs = N % 2 == 0;  // columns 2tg, 2tg + 1 as one 8-byte store
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + h * 8;
        const int n = n0 + wn * 32 + nt * 8 + 2 * tg;
        if (m >= M) continue;
        float* o = dst + (long long)m * N + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          if (n < N) o[0] = acc[mt][nt][2 * h];
          if (n + 1 < N) o[1] = acc[mt][nt][2 * h + 1];
        }
      }
  if (splits > 1) {
    __shared__ bool last;
    merge_splits<4, TL_N>(ws, out, count, blockIdx.y * gridDim.x + blockIdx.x, splits, M, N, m0,
                          TL_M, n0, last);
  }
}

// --- block sizes that are no multiple of 16: CUDA cores ------------------------------

constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;

__device__ __forceinline__ void dequant8(uint32_t word, int zp, float s, float w[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = (float)((int)((word >> (4 * j)) & 0xFu) - zp) * s;
}

__global__ void __launch_bounds__(T_THREADS) int4_simt_kernel(
    const float* __restrict__ a, long long lda, const uint32_t* __restrict__ b,
    const float* __restrict__ scales, const int32_t* __restrict__ zps,
    float* __restrict__ out, int M, int N, int K, int block_size) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Ws[TK][TN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nb = K / block_size;
  const long long row_words = K / 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();  // the previous tiles consumed
    // Activations: 64 rows x 32 k, coalesced along k, stored k-major.
    for (int idx = tid; idx < TM * TK; idx += T_THREADS) {
      const int r = idx / TK, kk = idx % TK, m = m0 + r, k = k0 + kk;
      As[kk][r] = m < M && k < K ? a[m * lda + k] : 0.f;
    }
    // Weights: one 32-bit word (8 k of one column) per thread.
    {
      const int c = tid / 4, wq = tid % 4, n = n0 + c, k = k0 + wq * 8;
      float w[8];
      if (n < N && k < K) {
        const int blk = k / block_size;
        const int zp = zps ? zps[(long long)n * nb + blk] : 8;
        dequant8(b[n * row_words + k / 8], zp, scales[(long long)n * nb + blk], w);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) Ws[wq * 8 + j][c] = w[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float xa[4] = {x.x, x.y, x.z, x.w}, ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
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

struct Args {
  const float* a;
  long long lda;
  const uint8_t* b;
  const float* s;
  const int32_t* z;
  float* out;
  float* ws;
  unsigned* count;
  int M, N, K, bs, kchunk, splits, vec_b, vec_s;
};

template <int NT, int BS>
cudaError_t launch_stream(dim3 grid, int smem, cudaStream_t st, const Args& x) {
  static int allowed[64];
  const cudaError_t e = allow_smem(int4_stream_kernel<NT, BS>, smem, allowed);
  if (e != cudaSuccess) return e;
  int4_stream_kernel<NT, BS><<<grid, ST_THREADS, smem, st>>>(
      x.a, x.lda, x.b, x.s, x.z, x.out, x.ws, x.count, x.M, x.N, x.K, x.bs, x.kchunk, x.splits,
      x.vec_b, x.vec_s);
  return cudaGetLastError();
}

template <int BS>
cudaError_t launch_tiled(dim3 grid, int smem, cudaStream_t st, const Args& x) {
  static int allowed[64];
  const cudaError_t e = allow_smem(int4_tiled_kernel<BS>, smem, allowed);
  if (e != cudaSuccess) return e;
  int4_tiled_kernel<BS><<<grid, TL_THREADS, smem, st>>>(
      x.a, x.lda, x.b, x.s, x.z, x.out, x.ws, x.count, x.M, x.N, x.K, x.bs, x.kchunk, x.splits,
      x.vec_b);
  return cudaGetLastError();
}

template <int NT>
cudaError_t stream_by_block(dim3 grid, int smem, cudaStream_t st, const Args& x) {
  switch (x.bs) {
    case 16: return launch_stream<NT, 16>(grid, smem, st, x);
    case 32: return launch_stream<NT, 32>(grid, smem, st, x);
    case 64: return launch_stream<NT, 64>(grid, smem, st, x);
    case 128: return launch_stream<NT, 128>(grid, smem, st, x);
    default: return launch_stream<NT, 0>(grid, smem, st, x);
  }
}

cudaError_t tiled_by_block(dim3 grid, int smem, cudaStream_t st, const Args& x) {
  switch (x.bs) {
    case 16: return launch_tiled<16>(grid, smem, st, x);
    case 32: return launch_tiled<32>(grid, smem, st, x);
    case 64: return launch_tiled<64>(grid, smem, st, x);
    case 128: return launch_tiled<128>(grid, smem, st, x);
    default: return launch_tiled<0>(grid, smem, st, x);
  }
}

}  // namespace

// form: 0 stream (M <= 16), 1 tiled (M > 16), 2 CUDA cores (any M; block
// sizes that are no multiple of 16). a [M, K] f32 with row stride lda (lda
// % 4 == 0, 16-byte aligned); b [N, K / 2] packed u8 (4-byte aligned);
// scales [N, K / block_size] f32; zps [N, K / block_size] int32 or null (the
// constant 8); out [M, N] f32. Forms 0 and 1 split K into ``splits`` chunks
// of ``kchunk`` (a multiple of 64 and of block_size; int4_split_plan) and,
// with splits > 1, take ``ws`` (splits * M * N floats) and ``count`` (one
// counter a column tile, or a tile for form 1; 0 on entry and on return);
// form 0 runs ``grid_x`` blocks over its 64-column tiles. Returns the
// launch's CUDA error code (0 on success).
extern "C" int rten_int4_matmul(int form, const void* a, long long lda, const void* b,
                                const void* scales, const void* zps, void* out, void* ws,
                                void* count, int M, int N, int K, int block_size, int splits,
                                int kchunk, int grid_x, void* stream) {
  if (M < 1 || N < 1 || K < 1 || block_size < 8 || block_size % 8 || K % block_size ||
      lda % 4 || reinterpret_cast<uintptr_t>(a) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 2) {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    int4_simt_kernel<<<grid, T_THREADS, 0, st>>>((const float*)a, lda, (const uint32_t*)b,
                                                 (const float*)scales, (const int32_t*)zps,
                                                 (float*)out, M, N, K, block_size);
    return (int)cudaGetLastError();
  }
  if (block_size % 16 || splits < 1 || kchunk < KSTAGE || kchunk % KSTAGE ||
      kchunk % block_size || (long long)(splits - 1) * kchunk >= K ||
      (long long)splits * kchunk < K || (splits > 1 && (!ws || !count)))
    return (int)cudaErrorInvalidValue;
  const bool pow2 = block_size == 16 || block_size == 32 || block_size == 64;
  const int nb = K / block_size;
  const int sb = stage_blocks(pow2 || block_size == 128 ? block_size : 0, block_size);
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const Args x{(const float*)a, lda, (const uint8_t*)b, (const float*)scales,
               (const int32_t*)zps, (float*)out, (float*)ws, (unsigned*)count, M, N, K,
               block_size, kchunk, splits, (K / 2) % 16 == 0 && al16(b),
               pow2 && nb % sb == 0 && al16(scales) && (!zps || al16(zps))};
  if (form == 0) {
    if (M > 16 || grid_x < 1) return (int)cudaErrorInvalidValue;
    const int smem = 3 * M * (2 * kchunk + 64) + ST_WARPS * ST_STAGES * st_stage_bytes(sb, zps);
    const dim3 grid(grid_x, splits);
    return (int)(M <= 8 ? stream_by_block<1>(grid, smem, st, x)
                        : stream_by_block<2>(grid, smem, st, x));
  }
  if (form == 1) {
    const int smem = TL_STAGES * tl_stage_bytes(sb, zps) + 3 * TL_M * TL_PITCH * 2;
    const dim3 grid((N + TL_N - 1) / TL_N, (M + TL_M - 1) / TL_M, splits);
    return (int)tiled_by_block(grid, smem, st, x);
  }
  return (int)cudaErrorInvalidValue;
}
