// int4 block-dequant matrix product (MatMulNBits) for Hopper (sm_90a):
// out[M, N] = a[M, K] . W[N, K]^T in f32, W held as packed nibbles.
//
// Replaces: rten_tpu/kernels/int4_matmul.py, int4_matmul_pallas (Pallas
// body _kernel). Weights keep MatMulNBits' layout: row n is K / 2 bytes,
// byte p holding k = 2p in its low nibble and k = 2p + 1 in its high one;
// scales [N, nb] f32 and optional zero points [N, nb] int32 (the wrapper
// unpacks u8-packed ones; none means the constant 8), nb = K / block_size.
// Each weight is dequantized as (float)(nibble - zp) * scale, the
// expression and order of int4_matmul_xla, and every product accumulates in
// f32 FMAs (no TF32: the reference runs its dots at HIGHEST precision). The
// wrapper zero-pads a to K = nb * block_size, so K is a multiple of the
// block size (itself a multiple of 8: a 32-bit word of 8 nibbles never
// straddles two blocks).
//
// Bound on the H100: at decode (M = 1 for the Generator, 16 for the serving
// engine) the call streams the packed weight once (K * N / 2 bytes, plus
// 4 * N * nb of scales) and does 2 * M * K * N flops, so it is bound by
// bytes: one GPT-2 124M forward's 49 products read 61.8 MB of nibbles and
// 15.4 MB of scales, ~23 us at 3.35 TB/s, against ~148 us for the f32
// weights. At a prefill of 128 rows and more the f32 FMAs (67 TFLOP/s on
// CUDA cores) bound it.
//
// Design, two kernels chosen by M (the wrapper does not choose):
// * M <= 16, int4_gemv_kernel: each warp owns two output columns for every
//   row; a 256-thread block stages a 256-wide K chunk of all M activation
//   rows in shared memory, and each lane reads one 32-bit word (8 nibbles)
//   of each of its warp's columns, so a warp reads 128 contiguous bytes of a
//   weight row per step. Lanes accumulate M x 2 partial sums in registers,
//   reduced across the warp by shuffles at the end. No lane re-reads a
//   weight byte; the bytes in flight are what limits it (the card is
//   filled only when N / 16 blocks cover the 132 SMs).
// * M > 16, int4_tiled_kernel: a 64 x 64 output tile per 256-thread block,
//   K walked in steps of 32 through shared memory. The packed weight tile
//   (64 columns x 16 bytes) is dequantized once into a f32 tile Ws[k][n];
//   the activation tile is stored transposed, As[k][m]; each thread
//   accumulates a 4 x 4 block from float4 reads of both.
// Both mask the ragged edges (M, N; the lm_head's N = 50257 is no multiple
// of any tile). This is the simple first kernel: no tensor cores, no
// cp.async or TMA, no split-K for the skinny decode shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void dequant8(uint32_t word, int zp, float s, float w[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = (float)((int)((word >> (4 * j)) & 0xFu) - zp) * s;
}

// --- M <= 16 -------------------------------------------------------------------

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 2;            // columns per warp
constexpr int GV_KC = 256;            // K per chunk: 32 lanes x 8 nibbles

template <int MT>
__global__ void __launch_bounds__(GV_THREADS) int4_gemv_kernel(
    const float* __restrict__ a, long long lda, const uint32_t* __restrict__ b,
    const float* __restrict__ scales, const int32_t* __restrict__ zps,
    float* __restrict__ out, int M, int N, int K, int block_size) {
  __shared__ __align__(16) float As[MT][GV_KC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * GV_WARPS + warp) * GV_COLS;
  const int nb = K / block_size;
  const long long row_words = K / 8;
  float acc[MT][GV_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GV_KC) {
    __syncthreads();  // the previous chunk consumed
    for (int idx = threadIdx.x; idx < MT * GV_KC; idx += GV_THREADS) {
      const int m = idx / GV_KC, kk = idx % GV_KC;
      As[m][kk] = m < M && k0 + kk < K ? a[m * lda + k0 + kk] : 0.f;
    }
    __syncthreads();
    const int k = k0 + lane * 8;
    if (k >= K) continue;
    const int blk = k / block_size;
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) {
      const int n = n0 + c;
      if (n >= N) continue;
      const uint32_t word = b[n * row_words + k / 8];
      const int zp = zps ? zps[(long long)n * nb + blk] : 8;
      float w[8];
      dequant8(word, zp, scales[(long long)n * nb + blk], w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 x0 = *reinterpret_cast<const float4*>(&As[m][lane * 8]);
        const float4 x1 = *reinterpret_cast<const float4*>(&As[m][lane * 8 + 4]);
        float s = acc[m][c];
        s = fmaf(x0.x, w[0], s); s = fmaf(x0.y, w[1], s);
        s = fmaf(x0.z, w[2], s); s = fmaf(x0.w, w[3], s);
        s = fmaf(x1.x, w[4], s); s = fmaf(x1.y, w[5], s);
        s = fmaf(x1.z, w[6], s); s = fmaf(x1.w, w[7], s);
        acc[m][c] = s;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c) {
      float s = acc[m][c];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
      acc[m][c] = s;
    }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_COLS; ++c)
        if (m < M && n0 + c < N) out[(long long)m * N + n0 + c] = acc[m][c];
  }
}

// --- M > 16 --------------------------------------------------------------------

constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;

__global__ void __launch_bounds__(T_THREADS) int4_tiled_kernel(
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

}  // namespace

// a [M, K] f32 with row stride lda (unit-stride rows, 16-byte aligned, lda %
// 4 == 0); b [N, K / 2] packed u8 (4-byte aligned); scales [N, K /
// block_size] f32; zps [N, K / block_size] int32 or null (the constant 8);
// out [M, N] f32. Returns the launch's CUDA error code (0 on success).
extern "C" int rten_int4_matmul(const void* a, long long lda, const void* b,
                                const void* scales, const void* zps, void* out,
                                int M, int N, int K, int block_size, void* stream) {
  if (M < 1 || N < 1 || K < 1 || block_size < 8 || block_size % 8 || K % block_size)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* A = (const float*)a;
  const uint32_t* B = (const uint32_t*)b;
  const float* S = (const float*)scales;
  const int32_t* Z = (const int32_t*)zps;
  float* O = (float*)out;
  if (M <= 16) {
    const int cols = GV_WARPS * GV_COLS;
    const dim3 grid((N + cols - 1) / cols);
#define RTEN_GEMV(MT) \
  int4_gemv_kernel<MT><<<grid, GV_THREADS, 0, st>>>(A, lda, B, S, Z, O, M, N, K, block_size)
    if (M == 1) RTEN_GEMV(1);
    else if (M <= 2) RTEN_GEMV(2);
    else if (M <= 4) RTEN_GEMV(4);
    else if (M <= 8) RTEN_GEMV(8);
    else RTEN_GEMV(16);
#undef RTEN_GEMV
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    int4_tiled_kernel<<<grid, T_THREADS, 0, st>>>(A, lda, B, S, Z, O, M, N, K, block_size);
  }
  return (int)cudaGetLastError();
}
