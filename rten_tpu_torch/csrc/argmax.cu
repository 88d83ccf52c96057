// First-occurrence argmax over the last axis of a row-strided f32 matrix,
// for Hopper (sm_90a).
//
// Replaces: rten_tpu/kernels/argmax.py, argmax_lastdim_pallas (Pallas body
// _argmax_kernel), the serving engine's greedy head over [slots, vocab]
// logits. Ties go to the lowest index; a NaN counts as the maximum and the
// first NaN wins, as in jnp.argmax / ONNX ArgMax (select_last_index = 0).
//
// Bound on the H100: bytes. The call reads each logit once (M x N x 4
// bytes: 24 MB at 120 x 50257, 9.7 MB at 16 x 151936) and does one compare
// per element.
//
// Design. One block per row would put 16 blocks on 132 SMs at 16 slots,
// each thread waiting on one 4-byte load per compare. Instead each row is
// split into `chunks` column chunks of `chunk_len` columns (a multiple of
// 4; the wrapper's chunk_plan sizes them so that M * chunks blocks fill the
// card about three times over), one 256-thread block a chunk:
//   * the row is read in place through its stride (the engine hands over
//     the lm_head's padded output sliced to the vocabulary); a chunk reads
//     16-byte vectors from its first 16-byte-aligned column on, with a
//     scalar head (0-3 columns before it) and tail (0-3 after the last
//     whole vector), and each thread issues UNROLL vector loads before it
//     compares any of them;
//   * a thread visits its columns in increasing order, so it keeps the
//     first maximum with one compare; the block then combines (value,
//     index) pairs with warp shuffles and shared memory under the full
//     rule (better(): NaN first, then the larger value, then the lower
//     index);
//   * each block writes its chunk's pair to a workspace and bumps its row's
//     counter (an acquire-release atomic); the block that finds itself last
//     merges the row's pairs, read from L2, in a fixed reduction tree over
//     the chunks in chunk order, writes the row's index and resets the
//     counter to 0 for the next call. better() is a total order, so the
//     result does not depend on which block finishes last, and two calls
//     give the same bits. A row of one chunk writes its result directly.
// The workspace (pairs and counters) is the wrapper's, kept per device and
// stream and grown as needed: the engine calls this every forward, and
// nothing is allocated per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte loads a thread has in flight before it compares

// True when (v, i) should replace (bv, bi) under first-occurrence argmax.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (bi < 0) return i >= 0;
  if (i < 0) return false;
  const bool vn = v != v, bn = bv != bv;  // NaN tests
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// better() for an index known to be past bi (a thread's own scan).
__device__ __forceinline__ void take_next(float v, int i, float& bv, int& bi) {
  if (bi < 0 || v > bv || (v != v && bv == bv)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take(ov, oi, bv, bi);
  }
}

// Grid: M * chunks blocks, block m * chunks + c reading row m's columns
// [c * chunk_len, min(N, (c + 1) * chunk_len)).
__global__ void __launch_bounds__(THREADS) argmax_split_kernel(
    const float* __restrict__ x, long long row_stride, int N, int chunks, int chunk_len,
    float* __restrict__ part_v, int* __restrict__ part_i, unsigned* __restrict__ count,
    int32_t* __restrict__ out) {
  const int m = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int tid = threadIdx.x;
  const float* row = x + (long long)m * row_stride;
  const int c0 = min(N, c * chunk_len), c1 = min(N, c0 + chunk_len);
  // Columns before the first 16-byte-aligned one (f32 rows are 4-aligned).
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(row + c0) & 15u);
  const int head = min(c1 - c0, (int)(((16u - mis) & 15u) / 4u));
  const int a0 = c0 + head;
  const int nvec = (c1 - a0) / 4;
  const int t0 = a0 + 4 * nvec;  // the scalar tail [t0, c1)

  float bv = 0.f;
  int bi = -1;
  if (tid < head) take_next(row[c0 + tid], c0 + tid, bv, bi);
  const float4* vrow = reinterpret_cast<const float4*>(row + a0);
  for (int j0 = tid; j0 < nvec; j0 += THREADS * UNROLL) {
    float4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < nvec) w[u] = vrow[j];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < nvec) {
        const int col = a0 + 4 * j;
        take_next(w[u].x, col, bv, bi);
        take_next(w[u].y, col + 1, bv, bi);
        take_next(w[u].z, col + 2, bv, bi);
        take_next(w[u].w, col + 3, bv, bi);
      }
    }
  }
  if (tid < c1 - t0) take_next(row[t0 + tid], t0 + tid, bv, bi);

  warp_reduce(bv, bi);
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  __shared__ bool last;
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) take(sv[w], si[w], bv, bi);
    if (chunks == 1) {
      out[m] = bi;
      last = false;
    } else {
      part_v[blockIdx.x] = bv;
      part_i[blockIdx.x] = bi;
      // acq_rel: the pair is visible before the count says so, and the
      // last block sees every other block's pair.
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(count[m]);
      last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(chunks - 1);
    }
  }
  __syncthreads();
  if (!last || warp != 0) return;
  // The row's last block: merge its chunks' pairs (written by other blocks,
  // so read from L2), lane l taking chunks l, l + 32, ... in order, then
  // the warp's fixed shuffle tree.
  float mv = 0.f;
  int mi = -1;
  for (int k = lane; k < chunks; k += 32) {
    const int p = m * chunks + k;
    take(__ldcg(part_v + p), __ldcg(part_i + p), mv, mi);
  }
  warp_reduce(mv, mi);
  if (lane == 0) {
    out[m] = mi;
    count[m] = 0u;  // ready for the next call on this workspace
  }
}

}  // namespace

// x: row m at x + m * row_stride (elements); part_v/part_i: M * chunks
// pairs; count: M counters, 0 on entry and on return.
extern "C" int rten_argmax_rows(const void* x, long long row_stride, int M, int N, int chunks,
                                int chunk_len, void* part_v, void* part_i, void* count,
                                void* out, void* stream) {
  if (chunks < 1 || (chunks > 1 && (long long)(chunks - 1) * chunk_len >= N) ||
      (long long)chunks * chunk_len < N || chunk_len % 4 || (long long)M * chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  argmax_split_kernel<<<M * chunks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, row_stride, N, chunks, chunk_len, (float*)part_v, (int*)part_i,
      (unsigned*)count, (int32_t*)out);
  return (int)cudaGetLastError();
}
