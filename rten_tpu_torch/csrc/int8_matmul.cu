// int8 x int8 -> int32 matrix product with the dequant epilogue on Hopper's
// s8 tensor cores (sm_90a).
//
// Replaces: rten_tpu/kernels/int8_matmul.py:121, int8_matmul_dequant (Pallas
// body _kernel, :49): C = ((A - zp_a) . (B - zp_b)) * s_a * s_b, computed as
// A.B - zp_a * colsums(B) - zp_b * rowsums(A) + K * zp_a * zp_b in int32,
// then (float)acc * s_a * s_b in the TPU kernel's order. A is [M, K] u8
// (flipped to s8 as a ^ 0x80, zp - 128) or s8, B [K, N] s8 in the graph's
// layout (n-contiguous; no transposed copy is kept), scales and zero points
// per tensor or per row / column, colsums optional (MatMulIntegerToFloat's
// input 7; the quantize pass emits none, so the kernels usually sum the
// columns themselves). Every integer sum is exact and the epilogue keeps
// its order, so the output is bit-identical to int8_matmul_dequant_plain
// (f64 sums of integers, then the same f32 roundings).
//
// Bound on the H100: at decode (M = the serving slots: 16, or 120 at the
// bench headline; 1 for a Generator step) a call streams the K x N s8
// weight once, so bytes bound it (TinyLlama's 155 calls of a step read 67
// MB of lm_head and 43.5 MB a layer: 0.32 ms at 3.35 TB/s). At admission
// (M = slots * 128) the 2 * M * K * N operations bind at the int8
// tensor-core rate (1,979 TOP/s) where the f32 output does not.
//
// Arithmetic: mma.sync.m16n8k32.row.col.s32.s8.s8.s32. Both operands of an
// 8-bit mma.sync are k-contiguous (.row.col only), and ldmatrix.trans
// transposes 16-bit pairs, not bytes. The byte transpose is finished in
// registers: ldmatrix.x4.trans over a stage of raw weight rows (k rows of
// 16 bytes, 16 columns) hands lane (g, t) of each 8 x 8 matrix the 2 x 2
// byte block (rows 2t, 2t + 1 of the matrix) x (columns 2g, 2g + 1), and
// the lane gives each matrix row its own k: matrix j's rows r hold k =
// 16 (j / 2) + 4 (r / 2) + r % 2 + 2 (j % 2), so that two matrices' blocks
// make, with one __byte_perm each, the words k 4t .. 4t + 3 of column 2g
// (selector 0x6420) and of column 2g + 1 (0x7531): the B fragments of two
// n8 tiles, the even and the odd columns of the 16. The activations need
// no permutation: plain ldmatrix on their k-contiguous rows is the s8 A
// fragment. So in every form the weights are the B operand (n8 side) and
// the activations the A operand (m16 side), at M <= 16 too: the M rows
// fill one m16 tile (its other rows zero), which costs mma issue slots
// the decode forms have to spare (they are bound by bytes), and keeps one
// transpose and one fragment layout for all three forms. Four PRMTs a 512-byte weight step, no shared-memory round
// trip. Where a has a zero point and no colsums are given, one more mma
// with an all-ones A sums each column; where b has one, one with an
// all-ones B (masked to k < K) sums each row. The u8 flip is applied to
// the A fragments (one XOR a register), so the activations are staged by
// cp.async as they are.
//
// Three forms; the wrapper's int8_form picks one from M, each with its own
// launch counter:
// * stream (M <= 16: every serve decode step at 16 slots, M 1 for a
//   Generator step) and rows (16 < M <= 128: the bench headline's 120
//   slots): one kernel, int8_stream_kernel<MT>, MT m16 tiles of
//   activations (1 for stream; 2, 4 or 8 for rows). A 128-thread block owns
//   64 weight columns (16 a warp) and a split of K. It stages the split's
//   activations (zero past K and M) in shared memory by cp.async as its
//   first copy group, then each warp streams its 16 columns through its own
//   ring of 8 cp.async stages of 64 k (64 rows of 16 bytes), waiting on its
//   own copies only (cp.async.wait_group, __syncwarp); one barrier, once
//   the activations have landed. Where the column tiles alone do not fill
//   the SMs, K is split over blocks (int8_split_plan, from the shapes only:
//   TinyLlama's k/v projections, N 256, take 8 splits at 16 rows); each
//   block adds its split's share of the zero-point terms to its int32
//   partial tile in a workspace, and the last block of a column tile to
//   arrive (an acquire-release counter, as in int4_matmul.cu) sums the
//   splits and applies the epilogue. Integer sums are exact in any order.
//   Unsplit calls (the lm_heads) run a grid of at most a few blocks an SM,
//   each walking its column tiles as one stream of stages, its activations
//   staged once. The epilogue loads its per-row and per-column operands
//   into registers before any of its stores.
// * tiled (M > 128: admissions): a 128 x 128 output tile a 256-thread block
//   (eight warps of 64 rows x 32 columns), 64 k a stage through a 4-stage
//   cp.async ring of both operands; the weight rows land XOR-swizzled so
//   that the permuted ldmatrix.trans rows fall in eight bank groups. K is
//   split (at most four ways) only where the tiles fill less than half the
//   card (TinyLlama's k/v projections at M 2048).
// Every form masks the ragged edges (M, N, K; K and N multiples of 4, rows
// that are no multiple of 16 bytes through 4-byte copies). No atomics on
// the data: outputs are written once, so two calls give the same bits.
//
// mma.sync, not wgmma: an 8-bit wgmma also needs K-major B in shared
// memory, so the transpose is needed either way, and the decode forms are
// bound by bytes, not by the tensor cores' rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>

namespace {

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b: A 16 x 32 s8 (row), B 32 x 8 s8 (col), C 16 x 8 s32. Not
// volatile: a pure function of its registers.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr uint32_t ONES = 0x01010101u;

// The k (0..31 of a 32-k step) that lane ``lane`` addresses for
// ldmatrix.x4.trans over raw weight rows: matrix j = lane / 8, row r =
// lane % 8 holds k = 16 (j / 2) + 4 (r / 2) + r % 2 + 2 (j % 2), so that
// the transposed 2 x 2 byte blocks of matrices 2i and 2i + 1 make the
// k-contiguous words of an s8 B fragment (weight_frags).
__device__ __forceinline__ int trans_row_k(int lane) {
  const int j = lane >> 3, r = lane & 7;
  return 16 * (j >> 1) + 4 * (r >> 1) + (r & 1) + 2 * (j & 1);
}

// The B fragments of the even and the odd columns of a 16-column group
// from one ldmatrix.x4.trans (see trans_row_k): b[0], b[1] for columns 2g,
// b[2], b[3] for columns 2g + 1.
__device__ __forceinline__ void weight_frags(const uint32_t (&w)[4], uint32_t (&b)[4]) {
  b[0] = __byte_perm(w[0], w[1], 0x6420);
  b[1] = __byte_perm(w[2], w[3], 0x6420);
  b[2] = __byte_perm(w[0], w[1], 0x7531);
  b[3] = __byte_perm(w[2], w[3], 0x7531);
}

// The epilogue's per-call operands.
struct Epi {
  const float* sa;
  int sa_stride;
  const float* sb;
  int sb_stride;
  const void* azp;
  int azp_kind, azp_stride;
  const void* bzp;
  int bzp_kind, bzp_stride;
  const int32_t* colsums;
  int a_u8;
  __device__ __forceinline__ bool has_azp() const { return azp_kind != ZP_NONE || a_u8; }
  __device__ __forceinline__ bool has_bzp() const { return bzp_kind != ZP_NONE; }
  __device__ __forceinline__ int zpa(int m) const {
    return has_azp() ? load_zp(azp, azp_kind, (long long)m * azp_stride) - (a_u8 ? 128 : 0) : 0;
  }
  __device__ __forceinline__ int zpb(int n) const {
    return load_zp(bzp, bzp_kind, (long long)n * bzp_stride);
  }
};

// The per-column operands of four columns n .. n + 3 (sb, given colsums,
// b's zero points) and the per-row ones of row m (a's zero point, sa),
// loaded into registers before any output is stored (the stores could
// alias them otherwise, and every row would wait on its own loads).
struct Cols {
  float sb[4];
  int cs[4], zb[4];
};
struct Row {
  int zpa;
  float sa;
};

__device__ __forceinline__ Cols load_cols(const Epi& e, int n) {
  Cols c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c.sb[j] = e.sb[(long long)(n + j) * e.sb_stride];
    c.cs[j] = e.colsums ? e.colsums[n + j] : 0;
    c.zb[j] = e.has_bzp() ? e.zpb(n + j) : 0;
  }
  return c;
}

__device__ __forceinline__ Row load_row(const Epi& e, int m) {
  return Row{e.zpa(m), e.sa[(long long)m * e.sa_stride]};
}

// A split's share of the zero-point terms for row m, columns n .. n + 3:
// - zp_a * (its colsums, where no colsums are given) - zp_b * (its row sum)
// + klen * zp_a * zp_b, all in int32 (the split's k count klen).
__device__ __forceinline__ void split_terms(int (&v)[4], const Epi& e, const Cols& c, int zpa,
                                            const int (&cs)[4], int rs, int klen) {
  const bool azp = e.has_azp(), bzp = e.has_bzp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (azp && !e.colsums) v[j] -= zpa * cs[j];
    if (bzp) {
      v[j] -= rs * c.zb[j];
      if (azp) v[j] += klen * zpa * c.zb[j];
    }
  }
}

// The whole sum's last term and the f32 epilogue, in the TPU kernel's
// order: v - zp_a * colsums (given ones), then ((float)v * s_a) * s_b; four
// columns n .. n + 3 of row m as one 16-byte store.
__device__ __forceinline__ void store_out(float* out, int N, const Epi& e, const Cols& c,
                                          const Row& r, int m, int n, int (&v)[4]) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e.has_azp() && e.colsums) v[j] -= r.zpa * c.cs[j];
    o[j] = (float)v[j] * r.sa * c.sb[j];
  }
  *reinterpret_cast<float4*>(out + (long long)m * N + n) = make_float4(o[0], o[1], o[2], o[3]);
}

// The split-K merge. Every thread has written its share of the block's
// int32 partial tile (its split's zero-point terms included) to ``ws``
// (split-major, [splits][M][N]); the block's last arrival for tile
// ``tile`` sums rows [m0, m0 + rows) x columns [n0, n0 + COLS) over the
// splits into ``out`` with the epilogue and resets the counter. The barrier
// orders the block's partial stores before thread 0's acquire-release
// increment, which makes them visible to the block that finds the count
// complete (cumulativity; no fence per thread). Each thread sums U
// four-column units at a time with SP splits' loads of each in flight:
// the merge is a chain of L2 round trips, as few as the registers allow.
template <int COLS, int U, int SP>
__device__ __forceinline__ void merge_splits(const int32_t* ws, float* out, unsigned* count,
                                             int tile, int splits, int M, int N, int m0, int rows,
                                             int n0, const Epi& e, bool& last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> cnt(count[tile]);
    last = cnt.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  const long long plane = (long long)M * N;
  constexpr int CQ = COLS / 4;  // four-column units a row
  const int units = rows * CQ;
  for (int u0 = threadIdx.x; u0 < units; u0 += U * blockDim.x) {
    const int32_t* src[U];
    int mm[U], nn[U], v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = u0 + u * blockDim.x;
      mm[u] = m0 + idx / CQ;
      nn[u] = n0 + 4 * (idx % CQ);
      const bool in = idx < units && mm[u] < M && nn[u] < N;
      src[u] = in ? ws + (long long)mm[u] * N + nn[u] : nullptr;
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0;
    }
    for (int sp0 = 0; sp0 < splits; sp0 += SP) {
      int4 x[U][SP];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < SP; ++j)
          x[u][j] = src[u] && sp0 + j < splits
                        ? __ldcg(reinterpret_cast<const int4*>(src[u] + (sp0 + j) * plane))
                        : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          v[u][0] += x[u][j].x;
          v[u][1] += x[u][j].y;
          v[u][2] += x[u][j].z;
          v[u][3] += x[u][j].w;
        }
    }
    Cols c[U];
    Row r[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (src[u]) {
        c[u] = load_cols(e, nn[u]);
        r[u] = load_row(e, mm[u]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (src[u]) store_out(out, N, e, c[u], r[u], mm[u], nn[u], v[u]);
  }
  if (threadIdx.x == 0) count[tile] = 0u;  // ready for the next call on this workspace
}

// --- M <= 128: the stream and rows forms --------------------------------------------

constexpr int ST_WARPS = 4;
constexpr int ST_THREADS = 32 * ST_WARPS;
constexpr int ST_COLS = 16 * ST_WARPS;  // weight columns a block
constexpr int ST_STAGES = 8;            // stages in flight a warp
constexpr int ST_KSTAGE = 64;           // k a stage
constexpr int ST_STAGE_BYTES = ST_KSTAGE * 16;

// The 16-byte unit of weight row k (0..63) in a stage: rows 8..15 of each
// 16 swap pairs of units, so that the eight rows an ldmatrix.trans matrix
// reads (trans_row_k) fall in eight bank groups.
__device__ __forceinline__ int stage_unit(int k) { return k ^ ((k >> 2) & 2); }

// Shared memory: the split's activations [16 MT][kchunk + 16] (s8, the u8
// flip applied; rows 16 bytes apart mod 128 so that ldmatrix's eight rows
// hit eight bank groups), then each warp's ring of ST_STAGES stages of 64
// weight rows x 16 bytes (stage_unit order). A block walks its column
// tiles cg = blockIdx.x, + gridDim.x, ... (one, where K is split) as one
// stream of stages a warp.
template <int MT, bool RS>
__global__ void __launch_bounds__(ST_THREADS) int8_stream_kernel(
    const uint8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K, Epi e,
    float* __restrict__ out, int32_t* __restrict__ ws, unsigned* __restrict__ count, int kchunk,
    int splits, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  constexpr int ROWS = 16 * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y;
  const int kb0 = split * kchunk, kend = min(K, kb0 + kchunk), klen = kend - kb0;
  const int pitch = kchunk + 16;
  unsigned char* act = st_smem;
  unsigned char* ring = st_smem + ROWS * pitch + warp * ST_STAGES * ST_STAGE_BYTES;
  const int tiles = (N + ST_COLS - 1) / ST_COLS;
  const int nst = (klen + ST_KSTAGE - 1) / ST_KSTAGE;  // stages a tile
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * nst;
  const bool cs_sums = e.has_azp() && !e.colsums;

  // The lane's copies: weight rows lane and lane + 32 of a stage.
  const int cu0 = 16 * stage_unit(lane), cu1 = 16 * stage_unit(lane + 32);
  int lj = 0, lst = 0;  // the next stage to load: tile lj of the block, stage lst
  auto load_next = [&](int i) {
    unsigned char* dst = ring + (i % ST_STAGES) * ST_STAGE_BYTES;
    const int n0 = ((int)blockIdx.x + lj * (int)gridDim.x) * ST_COLS + warp * 16;
    const int k0 = kb0 + lst * ST_KSTAGE;
    if (vec_b) {  // N % 16 == 0: a row's 16 columns are one aligned 16-byte word
      const bool nin = n0 < N;
      const int ka = k0 + lane, kb = k0 + lane + 32;
      const bool ia = nin && ka < kend, ib = nin && kb < kend;
      cp_async16(dst + cu0, ia ? B + (long long)ka * N + n0 : B, ia ? 16 : 0);
      cp_async16(dst + cu1, ib ? B + (long long)kb * N + n0 : B, ib ? 16 : 0);
    } else {  // 4-byte copies: 64 rows x 4 words
#pragma unroll
      for (int c = lane; c < ST_KSTAGE * 4; c += 32) {
        const int r = c >> 2, w = c & 3, k = k0 + r, n = n0 + 4 * w;
        const bool in = k < kend && n < N;
        cp_async4(dst + 16 * stage_unit(r) + 4 * w, in ? B + (long long)k * N + n : B, in);
      }
    }
    if (++lst == nst) {
      lst = 0;
      ++lj;
    }
  };
  // The split's activations first (one commit group, 16-byte copies where
  // rows are aligned words; zero past K and M), then the first stages of
  // weights; the u8 flip is applied to the A fragments.
  const int units = kchunk / 16;
  for (int idx = threadIdx.x; idx < ROWS * units; idx += ST_THREADS) {
    const int r = idx / units, u = idx % units, k = kb0 + 16 * u;
    unsigned char* dst = act + r * pitch + 16 * u;
    const uint8_t* src = A + (long long)r * K + k;
    if (vec_a) {
      const bool in = r < M && k < kend;
      cp_async16(dst, in ? src : A, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r < M && k + 4 * j < kend;
        cp_async4(dst + 4 * j, in ? src + 4 * j : A, in);
      }
    }
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ST_STAGES - 1; ++i) {
    if (i < total) load_next(i);
    cp_async_commit();
  }
  cp_async_wait<ST_STAGES - 1>();  // this thread's activations have landed
  __syncthreads();                 // ... and every thread's

  // The lane's reads: its ldmatrix.trans row of a stage; its ldmatrix row
  // of the activations (rows 0-7 / 8-15 of an m16 tile, bytes 0-15 / 16-31
  // of a 32-k step).
  const int lm_w = 16 * stage_unit(trans_row_k(lane));
  const unsigned char* act_l = act + ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + 16 * (lane >> 4);
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
  const uint32_t flip = e.a_u8 ? 0x80808080u : 0u;
  __shared__ bool last;

  int acc[MT][2][4], cs[2][4], rs[MT][4];
  int cj = 0, cst = 0;  // the stage being consumed: tile cj, stage cst
  for (int i = 0; i < total; ++i) {
    cp_async_wait<ST_STAGES - 2>();  // this lane's copies of stage i have landed
    __syncwarp();                    // ... and every lane's; stage i - 1 is consumed
    if (i + ST_STAGES - 1 < total) load_next(i + ST_STAGES - 1);
    cp_async_commit();
    if (cst == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][0][q] = acc[mt][1][q] = rs[mt][q] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) cs[0][q] = cs[1][q] = 0;
    }
    const unsigned char* cur = ring + (i % ST_STAGES) * ST_STAGE_BYTES;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kk = cst * ST_KSTAGE + 32 * s;  // k past kb0
      if (kk >= klen) break;
      uint32_t w[4], b[4];
      ldmatrix_x4_trans(w, cur + s * 512 + lm_w);
      weight_frags(w, b);
      // Row sums: an all-ones B masked to k < K (the flip turns the zero
      // fill into -128). K % 4 == 0: a lane's four k are all in or all out.
      const uint32_t rb0 = kk + 4 * t < klen ? ONES : 0u;
      const uint32_t rb1 = kk + 16 + 4 * t < klen ? ONES : 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, act_l + mt * 16 * pitch + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] ^= flip;
        mma_s8(acc[mt][0], a, b[0], b[1]);
        mma_s8(acc[mt][1], a, b[2], b[3]);
        if constexpr (RS) mma_s8(rs[mt], a, rb0, rb1);
      }
      if (cs_sums) {
        mma_s8(cs[0], ones, b[0], b[1]);
        mma_s8(cs[1], ones, b[2], b[3]);
      }
    }
    if (++cst == nst) {  // the tile's last stage: its outputs
      cst = 0;
      const int n0 = ((int)blockIdx.x + cj * (int)gridDim.x) * ST_COLS + warp * 16;
      const int n = n0 + 4 * t;  // the lane's four columns n .. n + 3
      ++cj;
      if (n < N) {  // N % 4 == 0: all four or none
        // Column n + j: the even tile's c0 / c1 (columns 4t, 4t + 2 of the
        // 16), the odd tile's (4t + 1, 4t + 3); row g + 8 in c2 / c3.
        const int csv[4] = {cs[0][0], cs[1][0], cs[0][1], cs[1][1]};
        const Cols cl = load_cols(e, n);
        Row rw[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) rw[mt][h] = load_row(e, min(mt * 16 + g + 8 * h, M - 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + g + 8 * h;
            if (m >= M) continue;
            int v[4] = {acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][0][2 * h + 1],
                        acc[mt][1][2 * h + 1]};
            split_terms(v, e, cl, rw[mt][h].zpa, csv, RS ? rs[mt][2 * h] : 0, klen);
            if (splits == 1) {
              store_out(out, N, e, cl, rw[mt][h], m, n, v);
            } else {
              *reinterpret_cast<int4*>(ws + split * (long long)M * N + (long long)m * N + n) =
                  make_int4(v[0], v[1], v[2], v[3]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();
  if (splits > 1)  // one column tile a block
    merge_splits<ST_COLS, MT == 1 ? 2 : 4, MT == 1 ? 8 : 4>(ws, out, count, blockIdx.x, splits, M,
                                                            N, 0, M, blockIdx.x * ST_COLS, e, last);
}

// --- M > 128: the tiled form ---------------------------------------------------------

constexpr int TL_THREADS = 256;
constexpr int TL_M = 128, TL_N = 128;  // the block's output tile
constexpr int TL_K = 64;               // k a stage
constexpr int TL_STAGES = 4;
constexpr int TL_A_PITCH = TL_K + 16;  // bytes an activation row: rows 16 bytes apart mod 128
constexpr int TL_A_BYTES = TL_M * TL_A_PITCH;
constexpr int TL_STAGE_BYTES = TL_A_BYTES + TL_K * TL_N;
constexpr int TL_SMEM = TL_STAGES * TL_STAGE_BYTES;

// The 16-byte unit of column group c in weight row k of a stage (128-byte
// rows): XOR-swizzled so that the eight rows of an ldmatrix.trans matrix
// (trans_row_k: k = 0, 1, 4, 5, 8, 9, 12, 13 or the others) fall in eight
// bank groups.
__device__ __forceinline__ int tl_unit(int k, int c) {
  return c ^ ((k & 1) | ((k >> 1) & 6));
}

// Shared memory: TL_STAGES stages of the activations [128][TL_A_PITCH]
// (raw bytes; the u8 flip is applied to the A fragments) and the weights
// [64 k][128 columns] (tl_unit order). Warp w owns rows 64 (w / 4) .. + 64
// (four m16 tiles) and columns 32 (w % 4) .. + 32 (two 16-column groups,
// four n8 tiles).
template <bool RS>
__global__ void __launch_bounds__(TL_THREADS, 2) int8_tiled_kernel(
    const uint8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K, Epi e,
    float* __restrict__ out, int32_t* __restrict__ ws, unsigned* __restrict__ count, int kchunk,
    int splits, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * TL_N, m0 = blockIdx.y * TL_M, split = blockIdx.z;
  const int kb0 = split * kchunk, kend = min(K, kb0 + kchunk), klen = kend - kb0;
  const int nstages = (klen + TL_K - 1) / TL_K;
  const bool cs_sums = e.has_azp() && !e.colsums;

  // The thread's 16-byte copies, fixed for the kernel: activation units
  // (row ar + 64 j, unit au), weight units (row wr + 32 j, group wc).
  const int ar = tid >> 2, au = tid & 3, wr = tid >> 3, wc = tid & 7;
  auto load_stage = [&](int st) {
    unsigned char* sa = tl_smem + (st % TL_STAGES) * TL_STAGE_BYTES;
    unsigned char* sw = sa + TL_A_BYTES;
    const int k0 = kb0 + st * TL_K;
    if (vec_a) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ar + 64 * j, m = m0 + r, k = k0 + 16 * au;
        const bool in = m < M && k < kend;
        cp_async16(sa + r * TL_A_PITCH + 16 * au, in ? A + (long long)m * K + k : A, in ? 16 : 0);
      }
    } else {
      for (int c = tid; c < TL_M * (TL_K / 4); c += TL_THREADS) {
        const int r = c >> 4, w = c & 15, m = m0 + r, k = k0 + 4 * w;
        const bool in = m < M && k < kend;
        cp_async4(sa + r * TL_A_PITCH + 4 * w, in ? A + (long long)m * K + k : A, in);
      }
    }
    if (vec_b) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = wr + 32 * j, k = k0 + r, n = n0 + 16 * wc;
        const bool in = k < kend && n < N;
        cp_async16(sw + r * TL_N + 16 * tl_unit(r, wc), in ? B + (long long)k * N + n : B,
                   in ? 16 : 0);
      }
    } else {
      for (int c = tid; c < TL_K * (TL_N / 4); c += TL_THREADS) {
        const int r = c >> 5, w = c & 31, k = k0 + r, n = n0 + 4 * w;
        const bool in = k < kend && n < N;
        cp_async4(sw + r * TL_N + 16 * tl_unit(r, w >> 2) + 4 * (w & 3),
                  in ? B + (long long)k * N + n : B, in);
      }
    }
  };

  int acc[4][4][4], cs[4][4], rs[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cs[i][q] = rs[i][q] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][q] = 0;
    }
  const uint32_t flip = e.a_u8 ? 0x80808080u : 0u;
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
  // The lane's ldmatrix rows: activations (rows 0-7 / 8-15 of an m16 tile,
  // bytes 0-15 / 16-31 of a 32-k step), weights (trans_row_k).
  const int a_off = (wm * 64 + (lane & 7) + 8 * ((lane >> 3) & 1)) * TL_A_PITCH + 16 * (lane >> 4);
  const int tk = trans_row_k(lane);

#pragma unroll
  for (int st = 0; st < TL_STAGES - 1; ++st) {
    if (st < nstages) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<TL_STAGES - 2>();  // stage st has landed (this thread's copies)
    __syncthreads();                 // ... and every thread's; stage st - 1 is consumed
    if (st + TL_STAGES - 1 < nstages) load_stage(st + TL_STAGES - 1);
    cp_async_commit();
    const unsigned char* sa = tl_smem + (st % TL_STAGES) * TL_STAGE_BYTES;
    const unsigned char* sw = sa + TL_A_BYTES;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kc = st * TL_K + 32 * s;  // k past kb0
      if (kc >= klen) break;
      uint32_t b[4][2];  // n8 tiles: group 0 even, odd; group 1 even, odd
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 32 * s + tk;
        uint32_t w[4], f[4];
        ldmatrix_x4_trans(w, sw + k * TL_N + 16 * tl_unit(k, 2 * wn + c));
        weight_frags(w, f);
        b[2 * c][0] = f[0];
        b[2 * c][1] = f[1];
        b[2 * c + 1][0] = f[2];
        b[2 * c + 1][1] = f[3];
      }
      // Row sums: an all-ones B masked to k < K (the flip turns padding
      // into -128). K % 4 == 0: a lane's four k are all in or all out.
      const uint32_t rb0 = kc + 4 * t < klen ? ONES : 0u;
      const uint32_t rb1 = kc + 16 + 4 * t < klen ? ONES : 0u;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, sa + a_off + mt * 16 * TL_A_PITCH + 32 * s);
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] ^= flip;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
        if constexpr (RS) mma_s8(rs[mt], a, rb0, rb1);
      }
      if (cs_sums) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(cs[nt], ones, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // C: tile 2c + odd, row g (+ 8 in c2 / c3): columns n0 + 32 wn + 16 c +
  // 4t + (even c0, odd c0, even c1, odd c1).
  Row r[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) r[mt][h] = load_row(e, min(m0 + wm * 64 + mt * 16 + g + 8 * h, M - 1));
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = n0 + 32 * wn + 16 * c + 4 * t;
    if (n >= N) continue;
    const int csv[4] = {cs[2 * c][0], cs[2 * c + 1][0], cs[2 * c][1], cs[2 * c + 1][1]};
    const Cols cl = load_cols(e, n);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        int v[4] = {acc[mt][2 * c][2 * h], acc[mt][2 * c + 1][2 * h], acc[mt][2 * c][2 * h + 1],
                    acc[mt][2 * c + 1][2 * h + 1]};
        split_terms(v, e, cl, r[mt][h].zpa, csv, RS ? rs[mt][2 * h] : 0, klen);
        if (splits == 1) {
          store_out(out, N, e, cl, r[mt][h], m, n, v);
        } else {
          *reinterpret_cast<int4*>(ws + split * (long long)M * N + (long long)m * N + n) =
              make_int4(v[0], v[1], v[2], v[3]);
        }
      }
  }
  if (splits > 1) {
    __shared__ bool last;
    merge_splits<TL_N, 4, 4>(ws, out, count, blockIdx.y * gridDim.x + blockIdx.x, splits, M, N, m0,
                       TL_M, n0, e, last);
  }
}

// The dynamic shared memory a kernel may use: raised once per device (and
// again only for more), as the attribute is per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, int (&allowed)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

struct Args {
  const uint8_t* a;
  const int8_t* b;
  int M, N, K;
  Epi e;
  float* out;
  int32_t* ws;
  unsigned* count;
  int kchunk, splits, vec_a, vec_b;
};

template <int MT, bool RS>
cudaError_t launch_stream(dim3 grid, int smem, cudaStream_t st, const Args& x) {
  static int allowed[64];
  const cudaError_t err = allow_smem(int8_stream_kernel<MT, RS>, smem, allowed);
  if (err != cudaSuccess) return err;
  int8_stream_kernel<MT, RS><<<grid, ST_THREADS, smem, st>>>(
      x.a, x.b, x.M, x.N, x.K, x.e, x.out, x.ws, x.count, x.kchunk, x.splits, x.vec_a, x.vec_b);
  return cudaGetLastError();
}

template <bool RS>
cudaError_t stream_by_rows(int mt, dim3 grid, int smem, cudaStream_t st, const Args& x) {
  switch (mt) {
    case 1: return launch_stream<1, RS>(grid, smem, st, x);
    case 2: return launch_stream<2, RS>(grid, smem, st, x);
    case 4: return launch_stream<4, RS>(grid, smem, st, x);
    case 8: return launch_stream<8, RS>(grid, smem, st, x);
    default: return cudaErrorInvalidValue;
  }
}

template <bool RS>
cudaError_t launch_tiled(dim3 grid, cudaStream_t st, const Args& x) {
  static int allowed[64];
  const cudaError_t err = allow_smem(int8_tiled_kernel<RS>, TL_SMEM, allowed);
  if (err != cudaSuccess) return err;
  int8_tiled_kernel<RS><<<grid, TL_THREADS, TL_SMEM, st>>>(
      x.a, x.b, x.M, x.N, x.K, x.e, x.out, x.ws, x.count, x.kchunk, x.splits, x.vec_a, x.vec_b);
  return cudaGetLastError();
}

}  // namespace

// form: 0 stream (M <= 16), 1 rows (16 < M <= 128), 2 tiled (any M; the
// wrapper sends M > 128). a [M, K] u8 (a_u8) or s8, b [K, N] s8, both
// row-major, 4-byte aligned, K and N multiples of 4; sa/sb f32 with stride
// 0 (per tensor) or 1; azp/bzp of kind 0 none, 1 u8, 2 s8, 3 int32, stride
// 0 or 1; colsums int32 [N] or null; out [M, N] f32. K is split into
// ``splits`` chunks of ``kchunk`` (a multiple of 64; int8_split_plan);
// with splits > 1, ``ws`` holds splits * M * N int32 and ``count`` one
// counter a column tile (0 on entry and on return). Forms 0 and 1 run
// ``grid_x`` blocks over their 64-column tiles (all of them where K is
// split). Returns the launch's CUDA error code (0 on success).
extern "C" int rten_int8_matmul_dequant(
    int form, const void* a, int a_u8, const void* b, int M, int N, int K, const void* sa,
    int sa_stride, const void* sb, int sb_stride, const void* azp, int azp_kind, int azp_stride,
    const void* bzp, int bzp_kind, int bzp_stride, const void* colsums, void* out, void* ws,
    void* count, int kchunk, int splits, int grid_x, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 4 || N % 4 || splits < 1 || kchunk < 64 || kchunk % 64 ||
      (long long)(splits - 1) * kchunk >= K || (long long)splits * kchunk < K ||
      (splits > 1 && (!ws || !count)) || reinterpret_cast<uintptr_t>(a) % 4 ||
      reinterpret_cast<uintptr_t>(b) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const Epi e{(const float*)sa, sa_stride, (const float*)sb, sb_stride,
              azp, azp_kind, azp_stride, bzp, bzp_kind, bzp_stride,
              (const int32_t*)colsums, a_u8};
  const Args x{(const uint8_t*)a, (const int8_t*)b, M, N, K, e, (float*)out, (int32_t*)ws,
               (unsigned*)count, kchunk, splits, K % 16 == 0 && al16(a), N % 16 == 0 && al16(b)};
  const bool rs = bzp_kind != ZP_NONE;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 0 || form == 1) {
    const int mt = M <= 16 ? 1 : M <= 32 ? 2 : M <= 64 ? 4 : 8;
    if (M > 128 || (form == 0) != (M <= 16) || grid_x < 1 ||
        (splits > 1 && grid_x != (N + ST_COLS - 1) / ST_COLS))
      return (int)cudaErrorInvalidValue;
    const int smem = 16 * mt * (kchunk + 16) + ST_WARPS * ST_STAGES * ST_STAGE_BYTES;
    const dim3 grid(grid_x, splits);
    return (int)(rs ? stream_by_rows<true>(mt, grid, smem, st, x)
                    : stream_by_rows<false>(mt, grid, smem, st, x));
  }
  if (form == 2) {
    const dim3 grid((N + TL_N - 1) / TL_N, (M + TL_M - 1) / TL_M, splits);
    return (int)(rs ? launch_tiled<true>(grid, st, x) : launch_tiled<false>(grid, st, x));
  }
  return (int)cudaErrorInvalidValue;
}
