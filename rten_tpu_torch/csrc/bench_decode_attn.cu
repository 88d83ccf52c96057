// The decode-attention microbenchmark's four formulations, for Hopper
// (sm_90a): a streaming floor and three ways to compute one decode step of
// attention, beside the port's own fold (decode_fold.cuh). Wrappers and
// plain versions: rten_tpu_torch/tools/bench_decode_attn.py.
//
// Every one of the four is bound by bytes on the H100 at the tool's shape
// (slots 32, H 12, cap 256, D 64): a decode step does 4 flops per K/V
// element it reads (2 in f32 for the score, 2 for the value product), far
// below the card's 20 f32 flops per byte of device memory (67 TFLOP/s over
// 3.35 TB/s), so each design is about keeping loads in flight and reading
// each byte once. None uses tensor cores yet (CUDA-core f32 FMAs): at these
// intensities they would not move the bound.
//
// 1. dma_floor. Replaces tools/bench_decode_attn.py:51 (dma_floor,
//    _floor_kernel): out[b] = sum over (Hkv, cap) of K[b] + the same of V[b]
//    + q[b, 0, 0], every cap row whatever lens says. Bound: bytes (the whole
//    K and V once). Design: the TPU kernel streams one slot per grid step;
//    one block per slot would give 32 blocks for 132 SMs, so each slot's 2 *
//    Hkv * cap rows are split into chunks over enough blocks to fill the card
//    (the wrapper sizes them from the SM count). A block's threads read
//    16-byte vectors, neighbouring threads on neighbouring addresses, four
//    rows in flight per thread, and write one partial row [D] per block; a
//    second small pass adds a slot's partial rows and q's row (no atomics:
//    the result does not depend on the blocks' order).
//
// 2. vpu_attn. Replaces tools/bench_decode_attn.py:89 (vpu_attn,
//    _vpu_kernel): per (slot, head), softmax(q . K^T * scale) V over the
//    columns <= lens[b], with K of H heads (no GQA) and the masked scores at
//    -1e30 with no guard, so a slot with lens < 0 gets the mean of V over
//    all cap rows, as the reference does. Bound: bytes. Design: the
//    formulation without a matrix unit, on CUDA cores: one 256-thread block
//    per (slot, head); each warp scores one column at a time (lanes split D,
//    coalesced, a shuffle reduction), the scores live in shared memory (cap
//    floats), then a block-wide max and sum, then the weighted V sum with
//    threads along D (coalesced) in groups that split the columns, eight V
//    loads in flight per thread. Columns past lens are neither read nor
//    summed (their p is exactly 0).
//
// 3. bd_decode and 4. nt_decode. Replace tools/bench_decode_attn.py:214
//    (bd_decode, _bd_kernel: K stored transposed, kt [B, Hkv, D, cap]) and
//    :318 (nt_decode, _nt_kernel: natural K [B, Hkv, cap, D]): decode
//    attention of f32 or bf16 q over f32 or bf16 K/V with kv-major GQA, an online
//    softmax over key blocks of bk = min(block_k, cap) columns, the grid
//    cap // bk (keys past (cap // bk) * bk are dropped, as the reference's
//    grid drops them), mask col <= lens[b], and a slot with no valid column
//    gives 0 (l = 0 -> 1). The TPU kernels build padded block-diagonal
//    operands (q_big, p_big) to feed a 128 x 128 matrix unit; they exist only
//    for that unit, and this kernel computes the same function directly.
//    Bound: bytes. Design: one 256-thread block per (slot, kv head, chunk of
//    8 of the group's query rows), q rows in shared memory. For each of the
//    reference's key blocks, thread t scores key t against every row of the
//    chunk, loading 16 of the key's K values at a time, all in flight before
//    their FMAs: bd walks the key's column of kt, so neighbouring threads
//    read neighbouring keys of one d (coalesced); nt walks the key's own row
//    in pairs (each 32-byte sector is fetched once and its other half read
//    from L1). No tile goes through shared memory, so a block waits on
//    device memory once for every 16 dims of a key block's K and crosses no
//    barrier (32-key tiles staged in shared memory, a wait and two barriers
//    a tile, measured slower: PERF.md). The scores go to shared memory;
//    warp r then owns row r's online-softmax state (block max, p, l,
//    alpha); the value product runs with threads along D, each keeping its
//    dims' sums for every row in registers (the column range split over
//    thread groups whose sums merge at the end; eight V loads in flight per
//    thread). The softmax follows the reference's key blocks, so p is taken
//    against the same running max and rounds to bf16 at the same values.
//    Keys past lens[b] are not read (their p is exactly 0). bf16 mode
//    rounds as the reference does: bd scores in f32 from the widened K, nt
//    rounds q to bf16 for the score; both round p to bf16 for the value
//    product (bf16 x bf16 products are exact in f32, summed in f32), and l
//    sums the unrounded p. A bf16 q (QB) widens exactly as it is loaded;
//    bd then rounds f32 K to bf16 for the score (the reference casts kt to
//    q's dtype), nt scores f32 K as it is (the reference widens q), and the
//    output is written in bf16 (round to nearest even), as the reference
//    writes q's dtype. Measured, both wait on memory latency rather
//    than bandwidth (bf16 K/V saves them no time; PERF.md section 6).
//
// Built without --use_fast_math (IEEE expf and division). Each entry point
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // loads a thread issues before it waits on the first

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide reduction of one value per thread (max or sum); every thread
// gets the result. red: WARPS floats of shared memory.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename Q>
__device__ __forceinline__ Q from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---- 1. dma_floor ----------------------------------------------------------

__device__ __forceinline__ void add4(float4& a, const float4 x) {
  a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
}

// Grid (chunks, B). Slot b's rows: its Hkv * cap K rows, then its V rows,
// each D4 float4 long. A block sums rows [c * per_chunk, ...) of them into
// partial[b, c, :].
__global__ void __launch_bounds__(THREADS) floor_partial_kernel(
    const float4* __restrict__ k, const float4* __restrict__ v, int rows, int D4,
    int per_chunk, float* __restrict__ partial) {
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int sweep = THREADS / D4;  // rows one pass of the block covers
  const int col = t % D4, sub = t / D4;
  const long long slot = (long long)b * rows * D4;
  const float4* kb = k + slot;
  const float4* vb = v + slot;
  auto row = [&](int r) {
    return r < rows ? kb + (long long)r * D4 : vb + (long long)(r - rows) * D4;
  };
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int r1 = min(2 * rows, (c + 1) * per_chunk);
  if (sub < sweep) {
    int r = c * per_chunk + sub;
    for (; r + 3 * sweep < r1; r += 4 * sweep) {
      const float4 x0 = row(r)[col], x1 = row(r + sweep)[col];
      const float4 x2 = row(r + 2 * sweep)[col], x3 = row(r + 3 * sweep)[col];
      add4(acc, x0); add4(acc, x1); add4(acc, x2); add4(acc, x3);
    }
    for (; r < r1; r += sweep) add4(acc, row(r)[col]);
  }
  __shared__ float4 red[THREADS];
  red[t] = acc;
  __syncthreads();
  for (int i = t; i < D4; i += THREADS) {
    float4 s = red[i];
    for (int j = 1; j < sweep; ++j) add4(s, red[j * D4 + i]);
    reinterpret_cast<float4*>(partial)[((long long)b * gridDim.x + c) * D4 + i] = s;
  }
}

// Grid B: out[b, d] = sum over chunks of partial[b, :, d] + q[b, 0, 0, d].
__global__ void __launch_bounds__(THREADS) floor_finish_kernel(
    const float* __restrict__ partial, const float* __restrict__ q, int chunks, int H, int D,
    float* __restrict__ out) {
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[((long long)b * chunks + c) * D + d];
    out[(long long)b * D + d] = s + q[(long long)b * H * D + d];
  }
}

// ---- 2. vpu_attn -----------------------------------------------------------

// Grid (H, B); shared memory: q [D], scores [cap], group sums [THREADS],
// reduction [WARPS].
__global__ void __launch_bounds__(THREADS) vpu_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lens, float* __restrict__ out, int H, int cap, int D, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* s = qs + D;
  float* part = s + cap;
  float* red = part + THREADS;
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long head = (long long)b * H + h;
  const float* kp = k + head * cap * D;
  const float* vp = v + head * cap * D;
  for (int d = t; d < D; d += THREADS) qs[d] = q[head * D + d];
  const int len = lens[b];
  const int last = len < 0 ? -1 : min(len, cap - 1);  // the last column attended
  __syncthreads();
#pragma unroll 4
  for (int j = warp; j < cap; j += WARPS) {
    float dot = 0.f;
    if (j <= last) {
      for (int d = lane; d < D; d += 32) dot += qs[d] * kp[(long long)j * D + d];
      dot = warp_sum(dot);
    }
    if (lane == 0) s[j] = j <= last ? dot * scale : NEG_INF;
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int j = t; j < cap; j += THREADS) mx = fmaxf(mx, s[j]);
  const float m = block_reduce<true>(mx, red);
  float ls = 0.f;
  for (int j = t; j < cap; j += THREADS) {
    const float p = expf(s[j] - m);
    s[j] = p;
    ls += p;
  }
  const float l = block_reduce<false>(ls, red);  // its barriers publish s
  // Every column has p = 1 when all are masked (the mean of V); otherwise
  // the masked ones have p = 0 and are skipped.
  const int jend = last < 0 ? cap : last + 1;
  if (D <= THREADS) {
    const int ng = THREADS / D, g = t / D, d = t % D;
    if (g < ng) {
      float acc = 0.f;
      for (int j0 = g; j0 < jend; j0 += UNROLL * ng) {
        float x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + u * ng;
          x[u] = j < jend ? vp[(long long)j * D + d] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (j0 + u * ng < jend) acc += s[j0 + u * ng] * x[u];
      }
      part[g * D + d] = acc;
    }
    __syncthreads();
    if (t < D) {
      float o = 0.f;
      for (int gg = 0; gg < ng; ++gg) o += part[gg * D + t];
      out[head * D + t] = o / l;
    }
  } else {
    for (int d = t; d < D; d += THREADS) {
      float acc = 0.f;
      for (int j = 0; j < jend; ++j) acc += s[j] * vp[(long long)j * D + d];
      out[head * D + d] = acc / l;
    }
  }
}

// ---- 3./4. bd_decode, nt_decode --------------------------------------------

constexpr int RB = 8;   // query rows per block (one warp's softmax state each)
constexpr int CHUNK = 16;  // K values a thread loads before it scores them
constexpr int SPLIT_FLOATS = THREADS * RB;  // the value product's per-group sums

// Shared floats of fold_attn_kernel at head dim D and key block bk.
__host__ __device__ inline int fold_smem_floats(int D, int bk) {
  return RB * D + RB * bk + SPLIT_FLOATS + 2 * RB;
}

// Grid (B * Hkv, ceil(group / RB)). KT: K is kt [B, Hkv, D, cap] (bd);
// otherwise [B, Hkv, cap, D] (nt). QB: q and the output are bf16, else
// f32. DP: the smallest power of two >= D, at least 32 (thread t of the
// value product owns dim t % DP of every row).
template <typename T, bool KT, bool QB>
__global__ void __launch_bounds__(THREADS) fold_attn_kernel(
    const void* __restrict__ qv, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lens, void* __restrict__ outv, int H, int Hkv, int cap, int D,
    int DP, int bk, int nblk, float scale) {
  using Q = typename std::conditional<QB, __nv_bfloat16, float>::type;
  const Q* __restrict__ q = static_cast<const Q*>(qv);
  Q* __restrict__ out = static_cast<Q*>(outv);
  constexpr bool BF16 = sizeof(T) == 2;
  // bd with a bf16 q scores bf16(K): the reference casts kt to q's dtype.
  constexpr bool ROUND_K = QB && KT && !BF16;
  extern __shared__ float sm[];
  float* qs = sm;                  // [RB][D]
  float* S = qs + RB * D;          // [RB][bk]: scores, then p
  float* split = S + RB * bk;      // [THREADS / DP][RB][DP]
  float* alpha_s = split + SPLIT_FLOATS;  // [RB]
  float* l_s = alpha_s + RB;               // [RB]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int r0 = blockIdx.y * RB, nrows = min(RB, group - r0);
  const int h0 = hk * group + r0;  // the block's first query head
  const long long kv = ((long long)b * Hkv + hk) * cap * D;
  const T* kp = k + kv;
  const T* vp = v + kv;
  for (int i = t; i < RB * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float x = r < nrows ? to_f32(q[((long long)b * H + h0 + r) * D + d]) : 0.f;
    if (BF16 && !KT) x = round_bf16(x);  // nt's score product is bf16 x bf16
    qs[i] = x;
  }
  const int len = lens[b];
  // Keys attended: [0, kend); (cap // bk) * bk is what the grid keeps.
  const int kend = len < 0 ? 0 : min(len + 1, nblk * bk);
  float m_r = NEG_INF, l_r = 0.f;  // warp r's row state (lane-uniform)
  const int nsplit = THREADS / DP, dcol = t % DP, grp = t / DP;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  for (int kb = 0; kb < nblk; ++kb) {
    const int c0 = kb * bk, c1 = min(c0 + bk, kend);
    if (c1 <= c0) break;  // every later key is masked: p = 0, alpha = 1
    // Scores of the block's live keys: thread t scores key c0 + t (and
    // every THREADS-th after it) against every row, its K values loaded
    // CHUNK at a time, all in flight before the FMAs (nt: along its own K
    // row; bd: down the key's column of kt, neighbouring threads on
    // neighbouring keys).
    __syncthreads();  // the last block's value product has read S
    for (int c = t; c < c1 - c0; c += THREADS) {
      float dot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) dot[r] = 0.f;
      for (int d0 = 0; d0 < D; d0 += CHUNK) {
        float x[CHUNK];
        if (KT) {
          const T* col = kp + c0 + c;
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            x[u] = d0 + u < D ? to_f32(col[(long long)(d0 + u) * cap]) : 0.f;
            if (ROUND_K) x[u] = round_bf16(x[u]);
          }
        } else {
          const T* row = kp + (long long)(c0 + c) * D + d0;
#pragma unroll
          for (int u = 0; u < CHUNK; u += 2) {
            const float2 p = d0 + u < D ? pair_f32(row + u) : make_float2(0.f, 0.f);
            x[u] = p.x;
            x[u + 1] = p.y;
          }
        }
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          if (d0 + u < D) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < nrows) dot[r] += qs[r * D + d0 + u] * x[u];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nrows) S[r * bk + c] = dot[r] * scale;
    }
    __syncthreads();
    // Warp r: the block's max, p, l and alpha for row r.
    const int nc = c1 - c0;
    if (warp < nrows) {
      float* Sr = S + warp * bk;
      float mb = NEG_INF;
      for (int c = lane; c < nc; c += 32) mb = fmaxf(mb, Sr[c]);
      const float m_new = fmaxf(m_r, warp_max(mb));
      float ps = 0.f;
      for (int c = lane; c < nc; c += 32) {
        const float p = m_new <= NEG_INF / 2 ? 0.f : expf(Sr[c] - m_new);
        ps += p;
        Sr[c] = BF16 ? round_bf16(p) : p;
      }
      const float alpha = m_r <= NEG_INF / 2 ? 0.f : expf(m_r - m_new);
      l_r = l_r * alpha + warp_sum(ps);
      m_r = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + p . V over the block's live keys.
    if (dcol < D) {
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] *= alpha_s[r < nrows ? r : 0];
      // UNROLL V loads in flight, then the sums in key order.
      for (int cb = grp; cb < nc; cb += UNROLL * nsplit) {
        float x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = cb + u * nsplit;
          x[u] = c < nc ? to_f32(vp[(long long)(c0 + c) * D + dcol]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = cb + u * nsplit;
          if (c < nc) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < nrows) acc[r] += S[r * bk + c] * x[u];
          }
        }
      }
    }
  }
  if (warp < nrows && lane == 0) l_s[warp] = l_r == 0.f ? 1.f : l_r;
#pragma unroll
  for (int r = 0; r < RB; ++r) split[(grp * RB + r) * DP + dcol] = acc[r];
  __syncthreads();
  for (int i = t; i < nrows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float o = 0.f;
    for (int g = 0; g < nsplit; ++g) o += split[(g * RB + r) * DP + d];
    const float y = o / l_s[r];
    out[((long long)b * H + h0 + r) * D + d] = from_f32<Q>(y);
  }
}

template <typename T, bool KT, bool QB>
cudaError_t launch_fold(const void* q, const void* k, const void* v, const void* lens, void* out,
                        int B, int H, int Hkv, int cap, int D, int bk, int nblk, float scale,
                        cudaStream_t stream) {
  int DP = 32;
  while (DP < D) DP *= 2;
  const size_t smem = sizeof(float) * fold_smem_floats(D, bk);
  auto kern = fold_attn_kernel<T, KT, QB>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int group = H / Hkv;
  dim3 grid(B * Hkv, (group + RB - 1) / RB);
  kern<<<grid, THREADS, smem, stream>>>(q, (const T*)k, (const T*)v, (const int*)lens, out, H,
                                        Hkv, cap, D, DP, bk, nblk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rten_dma_floor(const void* q, const void* k, const void* v, void* partial,
                              void* out, int B, int H, int Hkv, int cap, int D, int chunks,
                              int per_chunk, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int D4 = D / 4;
  floor_partial_kernel<<<dim3(chunks, B), THREADS, 0, s>>>(
      (const float4*)k, (const float4*)v, Hkv * cap, D4, per_chunk, (float*)partial);
  floor_finish_kernel<<<B, THREADS, 0, s>>>((const float*)partial, (const float*)q, chunks, H,
                                            D, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int rten_vpu_attn(const void* q, const void* k, const void* v, const void* lens,
                             void* out, int B, int H, int cap, int D, float scale, void* stream) {
  const size_t smem = sizeof(float) * (D + cap + THREADS + WARPS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vpu_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  vpu_attn_kernel<<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lens, (float*)out, H, cap,
      D, scale);
  return (int)cudaGetLastError();
}

// kind: 0 f32 K/V, 1 bf16 K/V; transposed: K is kt [B, Hkv, D, cap] (bd);
// qbf16: q and out are bf16, else f32.
extern "C" int rten_fold_attn(int kind, int transposed, int qbf16, const void* q, const void* k,
                              const void* v, const void* lens, void* out, int B, int H, int Hkv,
                              int cap, int D, int bk, int nblk, float scale, void* stream) {
#define RTEN_FOLD(T, KT, QB)                                                          \
  launch_fold<T, KT, QB>(q, k, v, lens, out, B, H, Hkv, cap, D, bk, nblk, scale,      \
                         (cudaStream_t)stream)
#define RTEN_FOLD_Q(T, KT) (qbf16 ? RTEN_FOLD(T, KT, true) : RTEN_FOLD(T, KT, false))
  cudaError_t e = cudaErrorInvalidValue;
  if (kind == 0) e = transposed ? RTEN_FOLD_Q(float, true) : RTEN_FOLD_Q(float, false);
  if (kind == 1)
    e = transposed ? RTEN_FOLD_Q(__nv_bfloat16, true) : RTEN_FOLD_Q(__nv_bfloat16, false);
#undef RTEN_FOLD_Q
#undef RTEN_FOLD
  return (int)e;
}

// Shared bytes fold_attn_kernel needs at head dim D and key block bk (the
// wrapper refuses shapes above the card's 227 KB).
extern "C" int rten_fold_attn_smem(int D, int bk) {
  return (int)(sizeof(float) * fold_smem_floats(D, bk));
}
