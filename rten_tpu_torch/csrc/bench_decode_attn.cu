// The decode-attention microbenchmark's four formulations, for Hopper
// (sm_90a): a streaming floor and three ways to compute one decode step of
// attention, beside the port's own fold (decode_fold.cuh). Wrappers and
// plain versions: rten_tpu_torch/tools/bench_decode_attn.py.
//
// A decode step does 4 flops per K/V element it reads (2 for the score, 2
// for the value product), far below the card's 20 f32 flops per byte of
// device memory (67 TFLOP/s over 3.35 TB/s), so every one of the four is
// bound by bytes on the H100, and each design is about keeping loads in
// flight and reading each byte once.
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
//    all cap rows, as the reference does. Bound: bytes (0.5 flop a byte of
//    f32 K/V against the CUDA cores' 20). The formulation without a matrix
//    unit, so it stays on CUDA cores; rows 3 and 4 below are the tool's
//    tensor-core ones. Design: one pass with an online softmax, so K and V
//    of a key are in flight together. One 128-thread block per (slot, head,
//    split of the live columns); the wrapper's plan (decode_split_plan over
//    the B * H units, shapes only) splits the columns only where B * H
//    blocks would not fill the SMs (one split at the tool's shape and at
//    slots 128). Eight lanes own a key (each a 16-byte piece of its row, so
//    a group's loads are coalesced and there is no 32-lane reduction per
//    key: three shuffles), four keys side by side a warp, U = 8 / NV keys a
//    group a batch, every load of the batch (8 KB a warp at D 64) issued
//    before the first is used; one rescale of the running (m, l, acc) a
//    batch. The warp's groups merge by shuffles, the warps in shared memory
//    in warp order, the splits (if any) in split order in the block that
//    arrives last (the fold's acquire-release counter). The cap-long score
//    buffer of the two-pass kernel this replaces is gone, so cap has no
//    limit; D is a multiple of 4 up to 256. Columns past lens are neither
//    read nor summed, and with lens < 0 K is not read (every score is the
//    mask's). No float atomics: two calls give the same bits.
//
// 3. bd_decode and 4. nt_decode. Replace tools/bench_decode_attn.py:214
//    (bd_decode, _bd_kernel: K stored transposed, kt [B, Hkv, D, cap]) and
//    :318 (nt_decode, _nt_kernel: natural K [B, Hkv, cap, D]): decode
//    attention of f32 or bf16 q over f32 or bf16 K/V with kv-major GQA, the
//    columns col <= lens[b], the keys at or past kept = (cap // bk) * bk
//    dropped (bk = min(block_k, cap): the reference's grid drops them), and
//    a slot with no valid column giving 0. The TPU kernels build padded
//    block-diagonal operands (q_big, p_big) to feed a 128 x 128 matrix unit
//    key block by key block; this kernel computes the same function with
//    its own tiling. Bound: bytes (at TinyLlama's attention, 2 MB of bf16
//    K/V: 0.6 us at 3.35 TB/s), so the design is about latency: enough
//    blocks, every copy in flight early, few dependent round trips.
//
//    Split: one block of four warps (two for f32 K/V at D > 128) per (slot,
//    kv head, tile of 8 or 16 of the group's query rows, chunk of the kept
//    keys). The wrapper's plan (kernels/flash_attention.py,
//    decode_split_plan, on the shapes alone) cuts the keys into chunks
//    where the (slot, kv head, row tile) units alone do not fill the SMs:
//    4 chunks of 64 at TinyLlama's 16 x 4 (256 blocks), one at the tool's
//    32 x 12. A block reads lens[b] and q, then each warp takes the
//    chunk's 16-key tiles in turn, through its own ring of two or three
//    stages in shared memory filled by cp.async (16-byte copies where the
//    rows allow, else 4-byte ones; 2-byte loads for bf16 kt rows of odd
//    cap), every stage issued before the first is waited on. Keys past
//    lens[b] or past the chunk are zero-filled, never read. A warp keeps
//    an online softmax per query row over its tiles; the block's warps
//    merge their states in shared memory in warp order. With one split the
//    block writes the output; with more, it writes its rows' (m, l, acc[D])
//    to the workspace and bumps its unit's counter (an acquire-release
//    atomic), and the block that arrives last merges the splits' states in
//    split order (one pass, every split's loads in flight) and resets the
//    counter. No float atomics: two calls give the same bits.
//
//    bf16 K/V, on tensor cores (mma.sync.m16n8k16, bf16 -> f32): the keys
//    are the M side and the block's query rows the N side, S^T = K . q^T
//    and O^T = V^T . P^T, so a group of 1-8 rows fills one 8-wide n-tile
//    (groups above 8 take two). K fragments come by ldmatrix from natural
//    K's [keys][D] tile (nt) or by ldmatrix.trans from kt's [D][keys] tile
//    (bd): the two formulations differ only there. V by ldmatrix.trans. q
//    is one bf16 part where the reference's score is bf16 x bf16 (nt rounds
//    q to bf16; a bf16 q), three (hi, mid, lo: exact to about 24 bits,
//    bf16 x bf16 products exact in f32) where it scores an f32 q against
//    widened K (bd). The score fragment's p, rounded to bf16 (exact in the
//    product), becomes the value product's B fragment by four shuffles.
//    D not a multiple of 16 is zero-padded in shared memory.
//
//    f32 K/V, on CUDA cores in the same split and staged structure: the
//    reference scores and sums f32 K and V in f32 with p unrounded, and the
//    f32 checks (atol 1e-5) would need six bf16 part products per product;
//    at 4 flops per 4-byte element the CUDA cores' 67 TFLOP/s are not what
//    bounds it. Lane (key, half) scores one key of the warp's tile against
//    every row over half the dims (float4 reads of the staged tile), the
//    halves and the row's max and sum reduce by shuffles, p goes through
//    shared memory, and each lane accumulates DP / 32 dims of P.V for
//    every row. bd with a bf16 q rounds f32 K to bf16 for the score (the
//    reference casts kt to q's dtype); nt scores f32 K against the widened
//    q.
//
//    Rounding as the reference's: l sums the unrounded p, p rounds to bf16
//    for a bf16 V, the output has q's dtype (bf16 rounds to nearest
//    even). The reference takes p against its key block's running max;
//    here p is taken against the warp's running max over its tiles, and
//    the warps' and splits' states are rescaled when they merge, so a bf16
//    p moves by at most one rounding: the output stays within the bf16
//    rule of the plain version. Measured on the H100 (chip_smoke.py's
//    tool phase and the card tests; PERF.md section 6): at most 1.2e-3
//    off the plain version for bf16 K/V (max|out| about 3.3), 3.9e-3
//    with a bf16 q (one bf16 rounding of the output), 5.4e-7 for f32.
//    Measured time: 1.6-5.8x faster than the CUDA-core kernel before it,
//    every bf16 case below SDPA on contiguous K/V.
//
// Built without --use_fast_math (IEEE expf and division). Each entry point
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <cuda/atomic>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

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

constexpr int VPU_THREADS = 128;                  // four warps
constexpr int VPU_WARPS = VPU_THREADS / 32;
constexpr int VPU_LANES = 8;                      // lanes a key: NV float4 of its row each
constexpr int VPU_GROUPS = 32 / VPU_LANES;        // keys a warp scores side by side
constexpr int VPU_MAXD = 256;                     // 8 lanes x 8 float4

// Two online-softmax states (m, l, acc) merged into the first: M = max,
// each side rescaled by e^(m - M) (0 for a state with no key, m = -inf).
template <int NV>
__device__ __forceinline__ void vpu_merge(float& m, float& l, float4 (&acc)[NV], float mb,
                                          float lb, const float4 (&ab)[NV]) {
  const float M = fmaxf(m, mb);
  const float mu = M == -INFINITY ? 0.f : M;
  const float fa = expf(m - mu), fb = expf(mb - mu);
  l = l * fa + lb * fb;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i].x = acc[i].x * fa + ab[i].x * fb;
    acc[i].y = acc[i].y * fa + ab[i].y * fb;
    acc[i].z = acc[i].z * fa + ab[i].z * fb;
    acc[i].w = acc[i].w * fa + ab[i].w * fb;
  }
  m = M;
}

// Grid (B * H, splits): block (unit = b * H + h, z) takes columns [z *
// chunk, (z + 1) * chunk) of the unit's live ones. Its warps take batches of
// VPU_GROUPS * U keys in turn; in a batch, lane group grp (8 lanes) loads
// keys base + u * VPU_GROUPS + grp (u < U) whole, K and V, 16 bytes a lane
// (every load of the batch issued before the first is used), scores each
// (the 8 lanes' partial dots summed by three shuffles) and folds the batch
// into its online softmax (one rescale a batch). Then the warp's four
// groups merge by shuffles, the warps in shared memory in warp order, and
// with one split the block writes the output; with more it writes its
// state (acc[D], m, l) to ws and the block that arrives last merges the
// splits in split order.
template <int NV>
__global__ void __launch_bounds__(VPU_THREADS, NV <= 4 ? 4 : 2) vpu_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ ws,
    unsigned* __restrict__ count, int H, int cap, int D, int chunk, float scale) {
  constexpr int U = 8 / NV;                // keys a lane group loads a batch
  constexpr int BATCH = VPU_GROUPS * U;    // keys a warp's batch
  __shared__ __align__(16) float acc_s[VPU_WARPS][VPU_MAXD];
  __shared__ float ml_s[VPU_WARPS][2];
  __shared__ bool last;
  const int z = blockIdx.y, splits = gridDim.y;
  const long long unit = blockIdx.x;  // b * H + h
  const int b = (int)(unit / H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / VPU_LANES, sub = lane % VPU_LANES;
  const float* kp = k + unit * cap * D;
  const float* vp = v + unit * cap * D;
  const int len = lens[b];
  // lens < 0: every score is the mask's -1e30 (no guard), every p is 1,
  // and the result is the mean of V over all cap rows; K is not needed.
  const bool none = len < 0;
  const int jend = none ? cap : min(len, cap - 1) + 1;
  const int j0 = z * chunk, j1 = min(j0 + chunk, jend);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // The lane's dims: float4 c = sub + 8 i of a row (dims 4c to 4c + 3).
  float4 qv[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = sub + VPU_LANES * i;
    qv[i] = 4 * c < D ? *reinterpret_cast<const float4*>(q + unit * D + 4 * c) : zero;
    acc[i] = zero;
  }
  float m = -INFINITY, l = 0.f;
  for (int base = j0 + warp * BATCH; base < j1; base += VPU_WARPS * BATCH) {
    float4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * VPU_GROUPS + grp;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = sub + VPU_LANES * i;
        const bool in = j < j1 && 4 * c < D;
        const long long off = (long long)j * D + 4 * c;
        kr[u][i] = in && !none ? __ldg(reinterpret_cast<const float4*>(kp + off)) : zero;
        vr[u][i] = in ? __ldg(reinterpret_cast<const float4*>(vp + off)) : zero;
      }
    }
    float s[U], mt = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        d += qv[i].x * kr[u][i].x + qv[i].y * kr[u][i].y + qv[i].z * kr[u][i].z +
             qv[i].w * kr[u][i].w;
#pragma unroll
      for (int off = 1; off < VPU_LANES; off <<= 1) d += __shfl_xor_sync(FULL, d, off);
      const int j = base + u * VPU_GROUPS + grp;
      s[u] = j < j1 ? (none ? NEG_INF : d * scale) : -INFINITY;
      mt = fmaxf(mt, s[u]);
    }
    const float m_new = fmaxf(m, mt);
    const float mu = m_new == -INFINITY ? 0.f : m_new;  // no key yet: every p is 0
    const float alpha = expf(m - mu);                    // 0 while m is -inf
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - mu);  // 0 past the live keys
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x += p * vr[u][i].x; acc[i].y += p * vr[u][i].y;
        acc[i].z += p * vr[u][i].z; acc[i].w += p * vr[u][i].w;
      }
    }
    m = m_new;
  }
  // The warp's groups: lane (sub, grp) and (sub, grp ^ 1), then ^ 2, hold
  // the same dims; group 0's merged state is the warp's.
#pragma unroll
  for (int off = VPU_LANES; off < 32; off <<= 1) {
    float4 ab[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      ab[i].x = __shfl_xor_sync(FULL, acc[i].x, off);
      ab[i].y = __shfl_xor_sync(FULL, acc[i].y, off);
      ab[i].z = __shfl_xor_sync(FULL, acc[i].z, off);
      ab[i].w = __shfl_xor_sync(FULL, acc[i].w, off);
    }
    const float mb = __shfl_xor_sync(FULL, m, off), lb = __shfl_xor_sync(FULL, l, off);
    vpu_merge<NV>(m, l, acc, mb, lb, ab);
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = sub + VPU_LANES * i;
      if (4 * c < D) *reinterpret_cast<float4*>(&acc_s[warp][4 * c]) = acc[i];
    }
    if (sub == 0) {
      ml_s[warp][0] = m;
      ml_s[warp][1] = l;
    }
  }
  __syncthreads();
  // The block's state: the warps' in warp order.
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < VPU_WARPS; ++w) M = fmaxf(M, ml_s[w][0]);
  const float mu = M == -INFINITY ? 0.f : M;
  float c[VPU_WARPS], L = 0.f;
#pragma unroll
  for (int w = 0; w < VPU_WARPS; ++w) {
    c[w] = expf(ml_s[w][0] - mu);
    L += c[w] * ml_s[w][1];
  }
  const long long st = unit * splits + z;                // this block's state
  const long long ml0 = (long long)gridDim.x * splits * D;  // the (m, l) pairs
  for (int d = tid; d < D; d += VPU_THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < VPU_WARPS; ++w) o += c[w] * acc_s[w][d];
    if (splits == 1)
      out[unit * D + d] = o / L;  // L > 0: the one split holds every live key
    else
      ws[st * D + d] = o;
  }
  if (splits == 1) return;
  if (tid == 0) {
    ws[ml0 + 2 * st] = M;
    ws[ml0 + 2 * st + 1] = L;
  }
  // Arrive: the barrier orders the block's state stores before thread 0's
  // acquire-release increment, which makes them visible to the block that
  // finds the count complete.
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(count[unit]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  for (int d = tid; d < D; d += VPU_THREADS) {
    float Mz = -INFINITY, Lz = 0.f, O = 0.f;
#pragma unroll 8
    for (int zz = 0; zz < splits; ++zz) {
      const long long sz = unit * splits + zz;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws + ml0 + 2 * sz));
      const float oz = __ldcg(ws + sz * D + d);
      const float mn = fmaxf(Mz, ml.x);
      const float mn0 = mn == -INFINITY ? 0.f : mn;
      const float fa = expf(Mz - mn0), fb = expf(ml.x - mn0);
      Lz = Lz * fa + ml.y * fb;
      O = O * fa + oz * fb;
      Mz = mn;
    }
    out[unit * D + d] = O / Lz;
  }
  if (tid == 0) count[unit] = 0u;  // ready for the next call on this workspace
}


// ---- 3./4. bd_decode, nt_decode --------------------------------------------

constexpr int FT_KEYS = 16;  // keys of a warp's tile: one mma M tile

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A cp.async of N (16 or 4) bytes that reads the first n of them from src
// and zero-fills the rest (n = 0: nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A warp copies rows [0, nrows) of row_bytes bytes, row r from src + r *
// gstride to dst + r * spitch (bytes), reading the first valid(r) bytes of
// each row and zero-filling the rest, in pieces of cpb bytes: cp.async of
// 16 or 4 bytes, or (cpb 2: bf16 kt rows of odd cap) a load and a store.
template <typename Valid>
__device__ __forceinline__ void warp_copy(unsigned char* dst, int spitch,
                                          const unsigned char* src, long long gstride,
                                          int nrows, int row_bytes, int cpb, Valid valid,
                                          int lane) {
  const int per = row_bytes / cpb;
  for (int i = lane; i < nrows * per; i += 32) {
    const int r = i / per, c = (i - r * per) * cpb;
    const int n = min(max(valid(r) - c, 0), cpb);
    unsigned char* d = dst + r * spitch + c;
    const unsigned char* s = n > 0 ? src + r * gstride + c : src;
    if (cpb == 16) {
      cp_async<16>(d, s, n);
    } else if (cpb == 4) {
      cp_async<4>(d, s, n);
    } else {
      *reinterpret_cast<uint16_t*>(d) = n > 0 ? *reinterpret_cast<const uint16_t*>(s) : 0;
    }
  }
}

// warp_copy for rows of ROW_BYTES bytes, NROWS of them, in 16-byte pieces,
// the loop unrolled at compile time (D == DP, every row 16-byte aligned):
// the general loop spends a division and two branches on every piece.
template <int NROWS, int ROW_BYTES, typename Valid>
__device__ __forceinline__ void warp_copy16(unsigned char* dst, int spitch,
                                            const unsigned char* src, long long gstride,
                                            Valid valid, int lane) {
  constexpr int PER = ROW_BYTES / 16;
  static_assert(ROW_BYTES % 16 == 0 && NROWS * PER % 32 == 0, "whole pieces, whole warps");
#pragma unroll
  for (int j = 0; j < NROWS * PER / 32; ++j) {
    const int i = lane + 32 * j, r = i / PER, c = (i % PER) * 16;
    const int n = min(max(valid(r) - c, 0), 16);
    cp_async<16>(dst + r * spitch + c, n > 0 ? src + r * gstride + c : src, n);
  }
}

// The last block's merge of the splits' states of R rows (heads h0, h0 +
// 1, ... of slot row h0g = b * H + h0), V dims a thread at a time, in split
// order: M = max, c_z = exp(m_z - M) taken online, out = sum c_z acc_z /
// sum c_z l_z (0 where l is 0). Every split's loads of a unit are
// independent of the running state, so the unrolled loop has them in
// flight together.
template <int V, typename Q>
__device__ __forceinline__ void merge_splits(const float* ws, long long ml0, Q* out,
                                             long long h0g, int R, int D, int splits, int tid,
                                             int nthreads) {
  using Vec = typename std::conditional<V == 4, float4, float2>::type;
  const int per = D / V;
  for (int u = tid; u < R * per; u += nthreads) {
    const int r = u / per, d = V * (u % per);
    const long long h = h0g + r, st0 = h * splits;
    float M = NEG_INF, L = 0.f, O[V];
#pragma unroll
    for (int x = 0; x < V; ++x) O[x] = 0.f;
#pragma unroll 8
    for (int zz = 0; zz < splits; ++zz) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws + ml0 + 2 * (st0 + zz)));
      const Vec oz = __ldcg(reinterpret_cast<const Vec*>(ws + (st0 + zz) * D + d));
      const float* of = reinterpret_cast<const float*>(&oz);
      const float mn = fmaxf(M, ml.x);
      const float a = M <= NEG_INF / 2 ? 0.f : expf(M - mn);
      const float c = ml.x <= NEG_INF / 2 ? 0.f : expf(ml.x - mn);
      L = L * a + ml.y * c;
#pragma unroll
      for (int x = 0; x < V; ++x) O[x] = O[x] * a + of[x] * c;
      M = mn;
    }
    const float inv = L == 0.f ? 1.f : L;
#pragma unroll
    for (int x = 0; x < V; ++x) out[h * D + d + x] = from_f32<Q>(O[x] / inv);
  }
}

// The shared-memory layout of fold_split_kernel<T, KT, QB, DP, NT>: the
// block's q rows, then each warp's ring of STAGES stages, one K and one V
// tile each. Row pitches (elements) pass the data by 16 bytes for bf16
// (the 8 rows an ldmatrix reads start in 8 bank groups) and by 4 floats
// for nt's f32 K (a quarter warp's float4 reads of 8 rows cover the 32
// banks); bd's f32 kt tile [D][16 keys] and f32 V need none (a half warp
// reads 16 neighbouring keys of one dim, the other half the next dim; V
// rows are read along D). f32 K/V keep three blocks an SM at D 64.
template <typename T, bool KT, bool QB, int DP, int NT>
struct FoldSplit {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ES = sizeof(T);
  static constexpr int ROWS = 8 * NT;
  // q as three bf16 parts where the reference scores an f32 q against
  // widened bf16 K (bd); one part where its score is bf16 x bf16.
  static constexpr int PARTS = BF16 && KT && !QB ? 3 : 1;
  static constexpr int QP = DP + 8;  // bf16 q row pitch
  static constexpr int Q_BYTES = BF16 ? PARTS * ROWS * QP * 2 : ROWS * DP * 4;
  static constexpr int KP = KT ? (BF16 ? 24 : 16) : (BF16 ? DP + 8 : DP + 4);
  static constexpr int VP = BF16 ? DP + 8 : DP;
  static constexpr int K_BYTES = (KT ? DP : FT_KEYS) * KP * ES;
  static constexpr int STAGE = K_BYTES + FT_KEYS * VP * ES;
  static constexpr int WARPS = !BF16 && DP > 128 ? 2 : 4;
  static constexpr int STAGES = WARPS * 3 * STAGE <= 64 * 1024 ? 3 : 2;
  static constexpr int BYTES = Q_BYTES + WARPS * STAGES * STAGE;
  // After the tiles the stages hold the warps' partial outputs.
  static_assert(WARPS * ROWS * DP * 4 <= WARPS * STAGES * STAGE, "merge scratch");
  static_assert(Q_BYTES % 16 == 0 && STAGE % 16 == 0 && K_BYTES % 16 == 0, "alignment");
  static_assert(BF16 || NT == 1, "f32 K/V take 8 rows a block");
};

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Grid (B * Hkv, splits, row tiles). KT: K is kt [B, Hkv, D, cap] (bd),
// else [B, Hkv, cap, D] (nt). QB: q and the output are bf16, else f32.
// DP: 64, 128 or 256, at least D. NT: 8-row n-tiles a block (bf16 K/V).
// kept: the keys the reference's grid keeps; chunk: the keys of a split
// (the last may be shorter); kcp / vcp: the copy piece of K's and V's rows
// (16, 4 or 2 bytes). ws and count: the split workspace (unused with one
// split): [B * H * splits * D] partial outputs, then [B * H * splits * 2]
// (m, l); one counter a (slot, kv head, row tile), 0 between calls.
template <typename T, bool KT, bool QB, int DP, int NT>
__global__ void __launch_bounds__(FoldSplit<T, KT, QB, DP, NT>::WARPS * 32)
    fold_split_kernel(const void* __restrict__ qv, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lens,
                      void* __restrict__ outv, float* __restrict__ ws,
                      unsigned* __restrict__ count, int H, int Hkv, int cap, int D, int kept,
                      int chunk, int kcp, int vcp, float scale) {
  using FS = FoldSplit<T, KT, QB, DP, NT>;
  using Q = typename std::conditional<QB, __nv_bfloat16, float>::type;
  constexpr bool BF16 = FS::BF16;
  constexpr int WARPS = FS::WARPS, STAGES = FS::STAGES, ES = FS::ES, ROWS = FS::ROWS;
  constexpr int NTHREADS = WARPS * 32;
  constexpr int DT = DP / 16;  // 16-dim steps (bf16), the score's k and the value's m tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[WARPS][ROWS], l_s[WARPS][ROWS], c_s[ROWS][WARPS], row_s[ROWS][2];
  __shared__ __align__(16) float p_s[BF16 ? 1 : WARPS][ROWS][FT_KEYS];  // f32: a tile's p
  __shared__ bool last;

  const Q* __restrict__ q = static_cast<const Q*>(qv);
  Q* __restrict__ out = static_cast<Q*>(outv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int splits = gridDim.y, z = blockIdx.y;
  const int group = H / Hkv;
  const int r0 = blockIdx.z * ROWS, R = min(ROWS, group - r0);
  const int h0 = hk * group + r0;  // the block's first query head
  const long long kv = ((long long)b * Hkv + hk) * cap * D;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + kv);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + kv);
  const int len = __ldg(lens + b);
  // The dims the products run over: D rounded up to the mma's 16 (bf16) or
  // to the f32 score's 8-dim steps; K's and q's dims past D are zero.
  const int DK = BF16 ? (D + 15) & ~15 : (D + 7) & ~7;
  unsigned char* mine = smem + FS::Q_BYTES + warp * STAGES * FS::STAGE;

  // Zero the K dims in [D, DK) of the warp's stages once: no copy writes them.
  for (int s = 0; s < STAGES; ++s) {
    T* kt_ = reinterpret_cast<T*>(mine + s * FS::STAGE);
    const int pad = DK - D;
    if constexpr (KT) {
      for (int i = lane; i < pad * FS::KP; i += 32) kt_[D * FS::KP + i] = zero_of<T>();
    } else {
      for (int i = lane; i < FT_KEYS * pad; i += 32)
        kt_[(i / pad) * FS::KP + D + i % pad] = zero_of<T>();
    }
  }

  // The block's keys: [c0, c1) of the slot's attended [0, kend).
  const int kend = len < 0 ? 0 : min(len + 1, kept);
  const int c0 = z * chunk, c1 = min(c0 + chunk, kend);
  const int ntile = c1 > c0 ? (c1 - c0 + FT_KEYS - 1) / FT_KEYS : 0;
  const int mine_n = warp < ntile ? (ntile - 1 - warp) / WARPS + 1 : 0;  // the warp's tiles
  const int row_bytes = D * ES;

  const bool fixed = D == DP && kcp == 16 && vcp == 16;  // warp_copy16's case

  // The warp's i-th tile into stage i % STAGES (an empty group past its last).
  auto issue = [&](int i) {
    if (i < mine_n) {
      const int key0 = c0 + (warp + i * WARPS) * FT_KEYS;
      unsigned char* st = mine + (i % STAGES) * FS::STAGE;
      auto keyrow = [&](int r) { return key0 + r < c1 ? row_bytes : 0; };
      if (fixed) {
        constexpr int RB = DP * ES;
        if constexpr (KT) {
          const int nb = min(FT_KEYS, c1 - key0) * ES;
          warp_copy16<DP, FT_KEYS * ES>(st, FS::KP * ES, kb + (long long)key0 * ES,
                                        (long long)cap * ES, [&](int) { return nb; }, lane);
        } else {
          warp_copy16<FT_KEYS, RB>(st, FS::KP * ES, kb + (long long)key0 * RB, RB, keyrow,
                                   lane);
        }
        warp_copy16<FT_KEYS, RB>(st + FS::K_BYTES, FS::VP * ES, vb + (long long)key0 * RB, RB,
                                 keyrow, lane);
      } else {
        if constexpr (KT) {
          const int nb = min(FT_KEYS, c1 - key0) * ES;
          warp_copy(st, FS::KP * ES, kb + (long long)key0 * ES, (long long)cap * ES, D,
                    FT_KEYS * ES, kcp, [&](int) { return nb; }, lane);
        } else {
          warp_copy(st, FS::KP * ES, kb + (long long)key0 * row_bytes, row_bytes, FT_KEYS,
                    row_bytes, kcp, keyrow, lane);
        }
        warp_copy(st + FS::K_BYTES, FS::VP * ES, vb + (long long)key0 * row_bytes, row_bytes,
                  FT_KEYS, row_bytes, vcp, keyrow, lane);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) issue(s);
  // q's rows while the copies fly.
  for (int i = tid; i < ROWS * DP; i += NTHREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r < R && d < D) {
      if constexpr (QB) {
        x = __bfloat162float(q[((long long)b * H + h0 + r) * D + d]);
      } else {
        x = q[((long long)b * H + h0 + r) * D + d];
      }
    }
    if constexpr (BF16) {
      __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
      for (int p = 0; p < FS::PARTS; ++p) {
        const __nv_bfloat16 hp = __float2bfloat16_rn(x);
        qs[(p * ROWS + r) * FS::QP + d] = hp;
        x -= __bfloat162float(hp);
      }
    } else {
      reinterpret_cast<float*>(smem)[i] = x;
    }
  }
  __syncthreads();  // q and the zeroed dims

  // The warp's online-softmax state. bf16: thread (g, tg) holds rows
  // nt * 8 + 2 tg + e (e = 0, 1) of n-tile nt and the output dims
  // mt * 16 + g (+ 8); l is the thread's partial sum until the end. f32:
  // every lane holds every row's m and l, and dims lane_dim(x).
  constexpr int MR = BF16 ? NT * 2 : 8;
  constexpr int LD = DP / 32;
  float m_r[MR], l_r[MR];
  float acc[BF16 ? NT : 1][BF16 ? DT : 1][4];  // bf16: the O^T fragments
  float accf[BF16 ? 1 : 8][BF16 ? 1 : LD];      // f32: each row's lane dims
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }
  for (auto& a : acc)
    for (auto& b2 : a)
      for (float& x : b2) x = 0.f;
  for (auto& a : accf)
    for (float& x : a) x = 0.f;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  // f32: the lane's dims (at DP 256 two float4 runs 128 apart, so that a
  // quarter warp's reads stay on 32 banks).
  auto lane_dim = [&](int x) {
    return LD == 8 ? (x < 4 ? 4 * lane + x : 124 + 4 * lane + x) : LD * lane + x;
  };

  for (int i = 0; i < mine_n; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* st = mine + (i % STAGES) * FS::STAGE;
    const int key0 = c0 + (warp + i * WARPS) * FT_KEYS;
    if constexpr (BF16) {
      const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* Vs = reinterpret_cast<const __nv_bfloat16*>(st + FS::K_BYTES);
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem);
      const int nks = DK / 16;
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        if (ks < nks) {
          uint32_t a[4];  // K[key0 + 16 keys][16 dims] as the row-major A
          if constexpr (KT) {
            ldsm_x4_trans(a, Ks + (ks * 16 + (lm >> 1) * 8 + lr) * FS::KP + (lm & 1) * 8);
          } else {
            ldsm_x4(a, Ks + ((lm & 1) * 8 + lr) * FS::KP + ks * 16 + (lm >> 1) * 8);
          }
#pragma unroll
          for (int p = 0; p < FS::PARTS; ++p) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const __nv_bfloat16* qr = qs + (p * ROWS + nt * 8 + g) * FS::QP + ks * 16 + 2 * tg;
              mma_bf16(sc[nt], a, *reinterpret_cast<const uint32_t*>(qr),
                       *reinterpret_cast<const uint32_t*>(qr + 8));
            }
          }
        }
      }
      // sc[nt][e], [2 + e]: keys key0 + g and key0 + g + 8, row nt * 8 + 2 tg + e.
      const bool va = key0 + g < c1, vb8 = key0 + g + 8 < c1;
      const int srcA = 8 * tg + (g >> 1), srcB = srcA + 4;
      const unsigned sel = g & 1 ? 0x7632u : 0x5410u;
      uint32_t pb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s0 = va ? sc[nt][e] * scale : NEG_INF;
          const float s1 = vb8 ? sc[nt][2 + e] * scale : NEG_INF;
          float mx = fmaxf(s0, s1);
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
          float& m = m_r[nt * 2 + e];
          const float mn = fmaxf(m, mx);
          const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - mn);
          const bool dead = mn <= NEG_INF / 2;
          pr[e] = dead ? 0.f : expf(s0 - mn);
          pr[2 + e] = dead ? 0.f : expf(s1 - mn);
          l_r[nt * 2 + e] = l_r[nt * 2 + e] * alpha + (pr[e] + pr[2 + e]);
          m = mn;
#pragma unroll
          for (int mt = 0; mt < DT; ++mt) {
            acc[nt][mt][e] *= alpha;
            acc[nt][mt][2 + e] *= alpha;
          }
        }
        // P^T's B fragment: keys 2 tg, 2 tg + 1 (and + 8) of row g, from
        // the lanes whose score fragment holds them.
        const uint32_t lo = pack_bf16x2(pr[0], pr[1]), hi = pack_bf16x2(pr[2], pr[3]);
        pb[nt][0] = __byte_perm(__shfl_sync(FULL, lo, srcA), __shfl_sync(FULL, lo, srcB), sel);
        pb[nt][1] = __byte_perm(__shfl_sync(FULL, hi, srcA), __shfl_sync(FULL, hi, srcB), sel);
      }
#pragma unroll
      for (int mt = 0; mt < DT; ++mt) {
        if (mt < nks) {
          uint32_t a[4];  // V^T[16 dims][16 keys] as the row-major A
          ldsm_x4_trans(a, Vs + ((lm >> 1) * 8 + lr) * FS::VP + mt * 16 + (lm & 1) * 8);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][mt], a, pb[nt][0], pb[nt][1]);
        }
      }
    } else {
      // bd with a bf16 q rounds f32 K to bf16 for the score.
      constexpr bool ROUND_K = QB && KT;
      const float* Ks = reinterpret_cast<const float*>(st);
      const float* Vs = reinterpret_cast<const float*>(st + FS::K_BYTES);
      const float* qs = reinterpret_cast<const float*>(smem);
      const int kl = lane & 15, hh = lane >> 4;
      float dot[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) dot[r] = 0.f;
      // 8 dims a step: nt's half hh takes dims 4 hh .. 4 hh + 3 of them
      // (one float4 of its key's row), bd's the dims of parity hh (one
      // neighbouring key of each of four kt rows).
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int d0 = 8 * c;
        if (d0 < DK) {
          float kx[4], qx[8][4];
          if constexpr (KT) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              kx[u] = Ks[(d0 + 2 * u + hh) * FS::KP + kl];
              if (ROUND_K) kx[u] = round_bf16(kx[u]);
            }
          } else {
            const float4 w = *reinterpret_cast<const float4*>(Ks + kl * FS::KP + d0 + 4 * hh);
            kx[0] = w.x; kx[1] = w.y; kx[2] = w.z; kx[3] = w.w;
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r < R) {
              const float4 a = *reinterpret_cast<const float4*>(qs + r * DP + d0);
              const float4 c4 = *reinterpret_cast<const float4*>(qs + r * DP + d0 + 4);
              if (KT) {
                qx[r][0] = hh ? a.y : a.x; qx[r][1] = hh ? a.w : a.z;
                qx[r][2] = hh ? c4.y : c4.x; qx[r][3] = hh ? c4.w : c4.z;
              } else {
                qx[r][0] = hh ? c4.x : a.x; qx[r][1] = hh ? c4.y : a.y;
                qx[r][2] = hh ? c4.z : a.z; qx[r][3] = hh ? c4.w : a.w;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) dot[r] = fmaf(qx[r][u], kx[u], dot[r]);
            }
          }
        }
      }
      const bool valid = key0 + kl < c1;
      float alpha[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        alpha[r] = 0.f;
        if (r < R) {
          const float full = dot[r] + __shfl_xor_sync(FULL, dot[r], 16);  // every lane
          const float s = valid ? full * scale : NEG_INF;
          float mx = s;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          const float mn = fmaxf(m_r[r], mx);
          alpha[r] = m_r[r] <= NEG_INF / 2 ? 0.f : expf(m_r[r] - mn);
          const float p = mn <= NEG_INF / 2 ? 0.f : expf(s - mn);
          float ps = p;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) ps += __shfl_xor_sync(FULL, ps, off);
          l_r[r] = l_r[r] * alpha[r] + ps;
          m_r[r] = mn;
          if (hh == 0) p_s[warp][r][kl] = p;
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int x = 0; x < LD; ++x) accf[r][x] *= alpha[r];
#pragma unroll
      for (int j = 0; j < FT_KEYS; j += 4) {
        float vx[4][LD];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = Vs + (j + u) * FS::VP;
#pragma unroll
          for (int x = 0; x < LD; x += 2) {
            const float2 w = *reinterpret_cast<const float2*>(vr + lane_dim(x));
            vx[u][x] = w.x;
            vx[u][x + 1] = w.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r < R) {
            const float4 pp = *reinterpret_cast<const float4*>(&p_s[warp][r][j]);
#pragma unroll
            for (int x = 0; x < LD; ++x) {
              float a = accf[r][x];
              a = fmaf(pp.x, vx[0][x], a);
              a = fmaf(pp.y, vx[1][x], a);
              a = fmaf(pp.z, vx[2][x], a);
              a = fmaf(pp.w, vx[3][x], a);
              accf[r][x] = a;
            }
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage (and p_s)
    issue(i + STAGES);
  }

  // The warps' states into shared memory (the stages' space), then merged
  // in warp order: M = max m_w, c_w = exp(m_w - M), l = sum c_w l_w,
  // acc = sum c_w acc_w.
  float* os = reinterpret_cast<float*>(smem + FS::Q_BYTES);  // [WARPS][ROWS][DP]
  __syncthreads();
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      l_r[i] += __shfl_xor_sync(FULL, l_r[i], 4);
      l_r[i] += __shfl_xor_sync(FULL, l_r[i], 8);
      l_r[i] += __shfl_xor_sync(FULL, l_r[i], 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = nt * 8 + 2 * tg + e;
        float* orow = os + (warp * ROWS + row) * DP;
#pragma unroll
        for (int mt = 0; mt < DT; ++mt) {
          orow[mt * 16 + g] = acc[nt][mt][e];
          orow[mt * 16 + g + 8] = acc[nt][mt][2 + e];
        }
        if (g == 0) {
          m_s[warp][row] = m_r[nt * 2 + e];
          l_s[warp][row] = l_r[nt * 2 + e];
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < R) {
#pragma unroll
        for (int x = 0; x < LD; ++x) os[(warp * ROWS + r) * DP + lane_dim(x)] = accf[r][x];
        if (lane == 0) {
          m_s[warp][r] = m_r[r];
          l_s[warp][r] = l_r[r];
        }
      }
    }
  }
  __syncthreads();
  if (tid < R) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w][tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = m_s[w][tid] <= NEG_INF / 2 ? 0.f : expf(m_s[w][tid] - M);
      c_s[tid][w] = c;
      L += c * l_s[w][tid];
    }
    row_s[tid][0] = M;
    row_s[tid][1] = L;
  }
  __syncthreads();
  const long long ml0 = (long long)gridDim.x / Hkv * H * splits * D;  // the (m, l) pairs
  for (int i = tid; i < R * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += c_s[r][w] * os[(w * ROWS + r) * DP + d];
    const long long h = (long long)b * H + h0 + r;
    if (splits == 1) {
      const float L = row_s[r][1];
      out[h * D + d] = from_f32<Q>(o / (L == 0.f ? 1.f : L));
    } else {
      const long long st = h * splits + z;
      ws[st * D + d] = o;
      if (d == 0) {
        ws[ml0 + 2 * st] = row_s[r][0];
        ws[ml0 + 2 * st + 1] = row_s[r][1];
      }
    }
  }
  if (splits == 1) return;
  // Arrive: the barrier orders the block's state stores before thread 0's
  // acquire-release increment, which makes them visible to the block that
  // finds the count complete (cumulativity; no fence per thread).
  const int unit = blockIdx.x * gridDim.z + blockIdx.z;
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(count[unit]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  const long long h0g = (long long)b * H + h0;
  if (D % 4 == 0) {
    merge_splits<4>(ws, ml0, out, h0g, R, D, splits, tid, NTHREADS);
  } else {
    merge_splits<2>(ws, ml0, out, h0g, R, D, splits, tid, NTHREADS);
  }
  if (tid == 0) count[unit] = 0u;  // ready for the next call on this workspace
}

// Launches an instance with its dynamic shared memory; the first launch of
// an instance on a device allows it those bytes (past 48 KB).
template <typename T, bool KT, bool QB, int DP, int NT>
cudaError_t launch_split(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                         const void* v, const void* lens, void* out, void* ws, void* count,
                         int H, int Hkv, int cap, int D, int kept, int chunk, int kcp, int vcp,
                         float scale) {
  using FS = FoldSplit<T, KT, QB, DP, NT>;
  auto* kern = fold_split_kernel<T, KT, QB, DP, NT>;
  static std::atomic<unsigned long long> allowed{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, FS::BYTES);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  kern<<<grid, FS::WARPS * 32, FS::BYTES, stream>>>(q, (const T*)k, (const T*)v,
                                                    (const int*)lens, out, (float*)ws,
                                                    (unsigned*)count, H, Hkv, cap, D, kept,
                                                    chunk, kcp, vcp, scale);
  return cudaGetLastError();
}

// The instance of a head dim (DP 64, 128, 256) and row tile (NT).
template <typename T, bool KT, bool QB>
cudaError_t launch_split_dp(int DP, int NT, dim3 grid, cudaStream_t s, const void* q,
                            const void* k, const void* v, const void* lens, void* out, void* ws,
                            void* count, int H, int Hkv, int cap, int D, int kept, int chunk,
                            int kcp, int vcp, float scale) {
#define RTEN_SPLIT(DP_, NT_)                                                             \
  return launch_split<T, KT, QB, DP_, NT_>(grid, s, q, k, v, lens, out, ws, count, H, Hkv, \
                                           cap, D, kept, chunk, kcp, vcp, scale)
  if constexpr (sizeof(T) == 2) {
    if (NT == 2) {
      if (DP == 64) RTEN_SPLIT(64, 2);
      if (DP == 128) RTEN_SPLIT(128, 2);
      return cudaErrorInvalidValue;
    }
  }
  if (NT != 1) return cudaErrorInvalidValue;
  if (DP == 64) RTEN_SPLIT(64, 1);
  if (DP == 128) RTEN_SPLIT(128, 1);
  if (DP == 256) RTEN_SPLIT(256, 1);
#undef RTEN_SPLIT
  return cudaErrorInvalidValue;
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

// splits, chunk: the wrapper's plan (splits * chunk >= cap > (splits - 1)
// * chunk); ws and count: its split workspace (none with one split).
extern "C" int rten_vpu_attn(const void* q, const void* k, const void* v, const void* lens,
                             void* out, void* ws, void* count, int B, int H, int cap, int D,
                             int splits, int chunk, float scale, void* stream) {
  if (B < 1 || H < 1 || cap < 1 || D < 4 || D % 4 || D > VPU_MAXD || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < cap || (long long)(splits - 1) * chunk >= cap ||
      (splits > 1 && (!ws || !count)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, splits);
  const cudaStream_t s = (cudaStream_t)stream;
#define RTEN_VPU(NV)                                                                      \
  vpu_attn_kernel<NV><<<grid, VPU_THREADS, 0, s>>>((const float*)q, (const float*)k,     \
                                                   (const float*)v, (const int*)lens,    \
                                                   (float*)out, (float*)ws,              \
                                                   (unsigned*)count, H, cap, D, chunk, scale)
  if (D <= 32)
    RTEN_VPU(1);
  else if (D <= 64)
    RTEN_VPU(2);
  else if (D <= 128)
    RTEN_VPU(4);
  else
    RTEN_VPU(8);
#undef RTEN_VPU
  return (int)cudaGetLastError();
}


// kind: 0 f32 K/V, 1 bf16 K/V; transposed: K is kt [B, Hkv, D, cap] (bd);
// qbf16: q and out are bf16, else f32; rows: query rows a block (8, or 16
// for bf16 K/V at D <= 128); kept, splits, chunk: the wrapper's plan
// (splits * chunk >= kept > (splits - 1) * chunk); kcp, vcp: the bytes a
// copy moves of K's and V's rows (16 or 4; 2 for bf16 kt of odd cap).
extern "C" int rten_fold_attn(int kind, int transposed, int qbf16, int rows, const void* q,
                              const void* k, const void* v, const void* lens, void* out,
                              void* ws, void* count, int B, int H, int Hkv, int cap, int D,
                              int kept, int splits, int chunk, int kcp, int vcp, float scale,
                              void* stream) {
  const bool bf16 = kind == 1;
  if ((kind != 0 && kind != 1) || B < 1 || Hkv < 1 || H % Hkv || D < 2 || D % 2 || D > 256 ||
      kept < 1 || kept > cap || splits < 1 || chunk < 1 || (long long)splits * chunk < kept ||
      (long long)(splits - 1) * chunk >= kept || (splits > 1 && (!ws || !count)) ||
      (vcp != 16 && vcp != 4) ||
      (kcp != 16 && kcp != 4 && !(kcp == 2 && bf16 && transposed)) ||
      (rows != 8 && !(rows == 16 && bf16 && D <= 128)))
    return (int)cudaErrorInvalidValue;
  const int DP = D <= 64 ? 64 : D <= 128 ? 128 : 256, NT = rows / 8;
  const dim3 grid(B * Hkv, splits, (H / Hkv + rows - 1) / rows);
  const cudaStream_t s = (cudaStream_t)stream;
#define RTEN_FOLD(T, KT, QB)                                                                \
  launch_split_dp<T, KT, QB>(DP, NT, grid, s, q, k, v, lens, out, ws, count, H, Hkv, cap, D, \
                             kept, chunk, kcp, vcp, scale)
#define RTEN_FOLD_Q(T, KT) (qbf16 ? RTEN_FOLD(T, KT, true) : RTEN_FOLD(T, KT, false))
  cudaError_t e;
  if (bf16)
    e = transposed ? RTEN_FOLD_Q(__nv_bfloat16, true) : RTEN_FOLD_Q(__nv_bfloat16, false);
  else
    e = transposed ? RTEN_FOLD_Q(float, true) : RTEN_FOLD_Q(float, false);
#undef RTEN_FOLD_Q
#undef RTEN_FOLD
  return (int)e;
}
