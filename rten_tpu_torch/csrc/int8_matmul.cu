// int8 x int8 -> int32 tiled matrix product with the dequant epilogue, for
// Hopper (sm_90a).
//
// Replaces: rten_tpu/kernels/int8_matmul.py, int8_matmul_dequant (Pallas
// body _kernel): C = ((A - zp_a) . (B - zp_b)) * s_a * s_b, computed as
// A.B - zp_a * colsums(B) - zp_b * rowsums(A) + K * zp_a * zp_b in int32,
// then (float)acc * s_a * s_b in the TPU kernel's order.
//
// Bound on the H100: at decode (M = serving slots, <= 128) the call streams
// the K x N s8 weight once and writes the M x N f32 output, and does
// 2*M*K*N int operations, far below the int8 tensor-core rate, so it is
// bound by bytes (the 768 x 51200 lm_head at 120 slots: 39 MB of weight and
// 25 MB of output, ~19 us at 3.35 TB/s). At admission (M = slots * 128) the
// f32 output still sets the bound for K = 768; for K = 3072 the operations
// do.
//
// Design: a 64 x 64 output tile per 256-thread block, K walked in 32-byte
// steps through shared memory. A is loaded as 4-byte words (u8 activations
// are flipped to s8 on load: a ^ 0x80, zp - 128); the B tile is re-packed
// in shared memory so that each 32-bit word holds four consecutive k of one
// column, and each thread accumulates a 4 x 4 block with __dp4a. Row sums
// (when b has a zero point) and column sums (when no precomputed colsums
// are given) come from extra __dp4a's against 0x01010101 on the same
// words. The integer part is exact; only the f32 epilogue rounds. This is
// the simple first kernel: no tensor cores (mma/wgmma), no TMA, no split-K
// for the skinny decode shapes — each is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;  // bytes of K per step = 8 packed words
constexpr int KW = BK / 4;
constexpr int THREADS = 256;

// zero-point kinds
constexpr int ZP_NONE = 0, ZP_U8 = 1, ZP_S8 = 2, ZP_I32 = 3;

__device__ __forceinline__ int load_zp(const void* p, int kind, long long idx) {
  switch (kind) {
    case ZP_U8: return (int)((const uint8_t*)p)[idx];
    case ZP_S8: return (int)((const int8_t*)p)[idx];
    case ZP_I32: return ((const int32_t*)p)[idx];
    default: return 0;
  }
}

__global__ void __launch_bounds__(THREADS) int8_mm_kernel(
    const int32_t* __restrict__ A,  // [M, K/4] words (s8, or u8 if a_u8)
    int a_u8,
    const int32_t* __restrict__ B,  // [K, N/4] words, s8
    int M, int N, int K,
    const float* __restrict__ sa, int sa_stride,
    const float* __restrict__ sb, int sb_stride,
    const void* azp, int azp_kind, int azp_stride,
    const void* bzp, int bzp_kind, int bzp_stride,
    const int32_t* __restrict__ colsums,  // [N] or nullptr
    float* __restrict__ out) {           // [M, N]
  __shared__ int32_t As[BM][KW + 1];
  __shared__ int32_t Braw[BK][BN / 4];
  __shared__ int32_t Bs[KW][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Kw = K / 4, Nw = N / 4;
  const bool has_azp = azp_kind != ZP_NONE || a_u8;
  const bool has_bzp = bzp_kind != ZP_NONE;
  const bool need_cs = has_azp && colsums == nullptr;

  int acc[4][4] = {};
  int rs[4] = {};
  int cs[4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kw0 = k0 / 4;
    // A tile: BM rows x KW words.
    for (int w = tid; w < BM * KW; w += THREADS) {
      const int r = w / KW, c = w % KW;
      const int m = m0 + r, kw = kw0 + c;
      int v = 0;
      if (m < M && kw < Kw) {
        v = A[(long long)m * Kw + kw];
        if (a_u8) v ^= 0x80808080;
      }
      As[r][c] = v;
    }
    // B tile: BK rows x BN/4 words, raw byte layout.
    for (int w = tid; w < BK * (BN / 4); w += THREADS) {
      const int r = w / (BN / 4), c = w % (BN / 4);
      const int k = k0 + r, nw = n0 / 4 + c;
      Braw[r][c] = (k < K && nw < Nw) ? B[(long long)k * Nw + nw] : 0;
    }
    __syncthreads();
    // Re-pack: Bs[q][n] = bytes B[k0+4q .. k0+4q+3][n].
    const uint8_t* braw = reinterpret_cast<const uint8_t*>(&Braw[0][0]);
    for (int w = tid; w < KW * BN; w += THREADS) {
      const int q = w / BN, n = w % BN;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= (uint32_t)braw[(4 * q + i) * BN + n] << (8 * i);
      Bs[q][n] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      if (has_bzp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[i] = __dp4a(a[i], 0x01010101, rs[i]);
      }
      if (need_cs) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[j] = __dp4a(0x01010101, b[j], cs[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int zpa = has_azp
        ? load_zp(azp, azp_kind, (long long)m * azp_stride) - (a_u8 ? 128 : 0)
        : 0;
    const float sam = sa[(long long)m * sa_stride];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      int v = acc[i][j];
      if (has_azp) v -= zpa * (colsums ? colsums[n] : cs[j]);
      if (has_bzp) {
        const int zpb = load_zp(bzp, bzp_kind, (long long)n * bzp_stride);
        v -= rs[i] * zpb;
        if (has_azp) v += K * zpa * zpb;
      }
      out[(long long)m * N + n] = (float)v * sam * sb[(long long)n * sb_stride];
    }
  }
}

}  // namespace

extern "C" int rten_int8_matmul_dequant(
    const void* a, int a_u8, const void* b, int M, int N, int K,
    const void* sa, int sa_stride, const void* sb, int sb_stride,
    const void* azp, int azp_kind, int azp_stride,
    const void* bzp, int bzp_kind, int bzp_stride,
    const void* colsums, void* out, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_u8, (const int32_t*)b, M, N, K,
      (const float*)sa, sa_stride, (const float*)sb, sb_stride,
      azp, azp_kind, azp_stride, bzp, bzp_kind, bzp_stride,
      (const int32_t*)colsums, (float*)out);
  return (int)cudaGetLastError();
}
