// First-occurrence argmax over the last axis of a row-strided f32 matrix,
// for Hopper (sm_90a).
//
// Replaces: rten_tpu/kernels/argmax.py, argmax_lastdim_pallas (Pallas body
// _argmax_kernel), the serving engine's greedy head over [slots, 50257]
// logits. Ties go to the lowest index; a NaN counts as the maximum and the
// first NaN wins, as in jnp.argmax / ONNX ArgMax (select_last_index = 0).
//
// Bound on the H100: bytes. The call reads each logit once (M x N x 4
// bytes, 24 MB at 120 x 50257) and does one compare per element.
//
// Design: one 256-thread block per row. The row is read with a row stride,
// so the engine hands over the lm_head's padded [slots, 51200] output
// sliced to the vocabulary without copying it. Each thread scans a strided
// share of the row keeping its first maximum, then a warp-shuffle and a
// shared-memory reduction combine (value, index) pairs, preferring the
// lower index on equal values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// True when (v, i) should replace (bv, bi) under first-occurrence argmax.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (bi < 0) return i >= 0;
  if (i < 0) return false;
  const bool vn = v != v, bn = bv != bv;  // NaN tests
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS) argmax_rows_kernel(
    const float* __restrict__ x, long long row_stride, int N,
    int32_t* __restrict__ out) {
  const float* row = x + (long long)blockIdx.x * row_stride;
  float bv = 0.f;
  int bi = -1;
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float v = row[i];
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sv[warp] = bv; si[warp] = bi; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w)
      if (better(sv[w], si[w], bv, bi)) { bv = sv[w]; bi = si[w]; }
    out[blockIdx.x] = bi;
  }
}

}  // namespace

extern "C" int rten_argmax_rows(const void* x, long long row_stride, int M,
                                int N, void* out, void* stream) {
  argmax_rows_kernel<<<M, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, row_stride, N, (int32_t*)out);
  return (int)cudaGetLastError();
}
