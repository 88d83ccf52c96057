// decode_mha's per-head form at head dims 129-512 (instances DP 256 and
// 512) on tensor cores, for every cache kind: s8, int4 and bf16 caches in
// three bf16 parts (decode_heads_tc.cuh's arithmetic), f32 caches in 3xTF32
// (decode_heads_tf32.cuh's). The admissions of graphs at Gemma's D 256 and
// of any head dim past 128, and prefill_mha_cat's at D 129-256 through the
// strides of the cat caches' head-major views. Included by decode_mha.cuh.
//
// Replaces rten_tpu/kernels/flash_attention.py:935 decode_mha (the
// per-(slot, head, key block) pallas_call, body _decode_kernel at :237) at
// those head dims, and :3301 prefill_mha_cat at D 129-256.
//
// Function (as decode_mha.cu states it): query row s of slot b, head h, at
// position lens[b] + s, reads kv head h / (H / Hkv) and attends columns
// j <= lens[b] + s, j < cap and, with a window, j > lens[b] + s - window;
// s_j = (q . k_j) * scale * ks[j]; out = sum_j p_j vs[j] v_j / sum_j p_j;
// a row with no column gives 0; rows past S and dims past D are neither
// read nor written.
//
// Bound on the H100 at a D 256 admission (16 slots x 128 rows, H 8 over 1
// KV head, f32 caches): the f32 q read and output written (33.5 MB a call)
// and the K/V rows, against 2.1 GFLOP (4 * pairs * D) at the TF32 peak:
// bytes, about 12 us a call. The CUDA-core kernel this replaces took 490 us
// a call: every product an f32 FMA out of shared memory, scalar tile fills,
// two barriers a 16-key tile.
//
// Arithmetic: as at D <= 128, so the card's 1e-4 and the engine references
// hold. s8, int4 and bf16: mma.sync.m16n8k16 on bf16 operands with f32
// accumulation, K and V exact in bf16 (codes and bf16 values), q and
// p * vs[j] each as three bf16 parts (hi, mid, lo: about 24 bits). f32:
// mma.sync.m16n8k8 in 3xTF32 (mma_tf32.cuh). The softmax in base 2 (the
// scale carries log2(e); ex2.approx). No atomics: two calls give the same
// bits. Built without --use_fast_math.
//
// Resources decide the tiling. A warp that owns 16 query rows holds 4
// f32 accumulators a lane for every 8 output dims: 128 registers at DP 256
// and 256 at DP 512 (more than a thread has), and q's three bf16 parts
// would take 192 registers a lane at DP 256. So each warp owns 16 query
// rows and WD_DO = 128 of the head dims, in both products: the DP / 128
// warps that share 16 rows (a row group) each score the tile's keys over
// their own 128 dims, write the partial scores (the accumulator fragments
// as they are) to shared memory, meet at a barrier of the row group's
// threads, and each sums the group's partials in slice order, so all of
// them hold the same scores, bit for bit, and run the same online softmax;
// then each multiplies P by V's rows over its own 128 dims (64 accumulators
// a lane). No product is repeated, and a warp splits only its own dims of
// q. q's three bf16 parts are split once per block into three bf16 planes
// in shared memory and read by ldmatrix (f32 caches: q stays f32 in shared
// memory and each warp splits its fragments into TF32 parts as it reads
// them, as it does K's and V's: no second plane of small parts is kept).
// Each part of the score product has its own accumulators, so the mma
// chains stay short; the partial score is (lo + mid) + hi (3xTF32: (small.
// big + big.small) + big.big).
//
// Tiling: one 256-thread block (eight warps) per (head, slot, query tile),
// the grid's last query tiles (the most keys) first:
// 64 query rows at DP 256 (four row groups x two dim slices), 32 at DP 512
// (two x four); the key loop runs inside the block over tiles of 32 keys
// (16 at DP 512) from the block's first window column to its last row's
// position, double-buffered in shared memory by cp.async: 16-byte copies
// where the rows are whole aligned 16-byte words (the wrapper's ``vec``;
// dims past D zero-filled), element copies otherwise; keys past the
// block's last position zero-filled, not read. s8 and int4 rows land in
// raw staging buffers (with the tile's scales) and are widened to bf16 as
// the tile is filled (decode_heads_tc.cuh's widen_tile); bf16 and f32 rows
// land as they are. A tile costs one block barrier (two for s8 and int4)
// and one row-group barrier. A row group skips the products of a tile none
// of its rows attends and the 8-key n-tiles past its last row; a slice
// whose dims all lie past D writes zero partials and skips its value
// product. Shared memory (WideTile::SMEM, within the 227 KB a block may
// use; kernels/flash_attention.py:heads_plan mirrors it): q, two K/V
// buffers (s8/int4: one widened K/V tile, two raw buffers and their
// scales) and the partial scores; 154-211 KB, one block an SM.

#pragma once

#include <type_traits>

#include "decode_heads_tf32.cuh"

namespace {

constexpr int WD_THREADS = 256;  // eight warps
constexpr int WD_DO = 128;       // output dims a warp owns
constexpr int WD_MAX_SMEM = 232448;  // shared bytes a block may use on the H100

template <int DP, typename T>
struct WideTile {
  static_assert(DP == 256 || DP == 512, "the wide form holds DP 256 and 512");
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool QUANT = KvRow<T>::QUANT;
  static constexpr bool U4 = KvRow<T>::U4;
  static constexpr int WARPS = WD_THREADS / 32;
  static constexpr int SLICES = DP / WD_DO;       // warps in a row group
  static constexpr int ROWS = 16 * WARPS / SLICES;  // query rows a block
  static constexpr int KEYS = DP == 512 ? 16 : 32;  // key columns a tile
  static constexpr int NT = KEYS / 8;               // 8-key n-tiles of a tile
  // Row pitches (elements): 16 bytes past the row, so that the 8 rows an
  // ldmatrix reads start in 8 bank groups. q: f32 rows (F32), or three
  // planes of bf16 rows (its parts).
  static constexpr int QPITCH = F32 ? DP + 4 : DP + 8;
  static constexpr int QPLANE = ROWS * QPITCH;      // elements of a q plane
  static constexpr int Q_BYTES = F32 ? QPLANE * 4 : 3 * QPLANE * 2;
  static constexpr int PITCH = F32 ? DP + 4 : DP + 8;
  static constexpr int ESZ = F32 ? 4 : 2;         // bytes a tile element
  static constexpr int TILE = KEYS * PITCH;       // elements of a K or V tile
  static constexpr int MAT = TILE * ESZ;          // its bytes
  static constexpr int RAW_ROW = U4 ? DP / 2 : DP;  // staged bytes a row (s8, int4)
  static constexpr int RAW = KEYS * RAW_ROW;
  static constexpr int WIDE = 2 * TILE * 2;       // the widened K and V tiles (s8, int4)
  // bf16, f32: two buffers of K and V. s8, int4: the widened K and V, two
  // raw buffers of K and V, two of their scales.
  static constexpr int KV_BYTES = QUANT ? WIDE + 4 * RAW + 4 * KEYS * 4 : 4 * MAT;
  static constexpr int PSUM_BYTES = WARPS * NT * 32 * 16;  // each warp's partial scores
  static constexpr int SMEM = Q_BYTES + KV_BYTES + PSUM_BYTES;
  static_assert(SMEM <= WD_MAX_SMEM, "a block's shared memory");
  static_assert(!QUANT || (PITCH == TcTile<DP, T>::PITCH && RAW_ROW == TcTile<DP, T>::RAW_ROW),
                "widen_tile's layout");
};

// Waits at the barrier of the ``n`` threads of row group ``id`` (named
// barriers 1 to 4; 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keys [k0, k0 + KEYS) of K and V into buffer ``buf`` (s8/int4: the raw
// staging buffers, and the tile's scales), every DP column: 16-byte
// cp.async when ``vec`` (whole aligned 16-byte rows; chunks past the row's
// bytes zero-filled), else element copies (plain loads and stores,
// complete at the next barrier); keys at or past kend zero-filled, not
// read.
template <int DP, typename T>
__device__ __forceinline__ void wide_load(unsigned char* kv, int buf, int k0, const T* kb,
                                          const T* vb, long long kv_sj, const float* ks,
                                          const float* vs, long long sc_off, long long sc_sj,
                                          int D, int kend, bool vec, int tid) {
  using WT = WideTile<DP, T>;
  constexpr int KEYS = WT::KEYS;
  constexpr int DST = WT::QUANT ? WT::RAW_ROW : WT::PITCH * WT::ESZ;  // bytes between rows
  constexpr int ROW = WT::QUANT ? WT::RAW_ROW : DP * WT::ESZ;        // bytes of a DP row
  constexpr int VGAP = WT::QUANT ? WT::RAW : WT::MAT;                // K to V, bytes
  unsigned char* dk = kv + (WT::QUANT ? WT::WIDE + buf * 2 * WT::RAW : buf * 2 * WT::MAT);
  if constexpr (WT::QUANT) {
    if (tid < 2 * KEYS) {  // ks (tid < KEYS) or vs of column k0 + tid % KEYS; 0 past kend
      const int r = tid % KEYS, col = k0 + r;
      const bool in = col < kend;
      float* sc = reinterpret_cast<float*>(kv + WT::WIDE + 4 * WT::RAW) + buf * 2 * KEYS;
      const float* src = (tid < KEYS ? ks : vs) + sc_off + (in ? col : 0) * sc_sj;
      cp_async4(sc + (tid < KEYS ? 0 : KEYS) + r, src, in);
    }
  }
  const int rbytes = WT::U4 ? D / 2 : D * (int)sizeof(T);  // bytes a cache row holds
  const long long sj = kv_sj * (long long)sizeof(T);       // bytes between key rows
  const unsigned char* kb0 = reinterpret_cast<const unsigned char*>(kb);
  const unsigned char* vb0 = reinterpret_cast<const unsigned char*>(vb);
  if (vec) {
    constexpr int CPR = ROW / 16;
    for (int i = tid; i < KEYS * CPR; i += WD_THREADS) {
      const int r = i / CPR, c = i % CPR, col = k0 + r;
      const bool in = col < kend && 16 * c < rbytes;
      const long long off = in ? col * sj + 16 * c : 0;
      cp_async16(dk + r * DST + 16 * c, kb0 + off, in);
      cp_async16(dk + VGAP + r * DST + 16 * c, vb0 + off, in);
    }
  } else if constexpr (WT::QUANT) {
    for (int i = tid; i < KEYS * ROW; i += WD_THREADS) {
      const int r = i / ROW, c = i % ROW, col = k0 + r;
      const bool in = col < kend && c < rbytes;
      dk[r * DST + c] = in ? kb0[col * sj + c] : 0;
      dk[VGAP + r * DST + c] = in ? vb0[col * sj + c] : 0;
    }
  } else {
    T* tk = reinterpret_cast<T*>(dk);
    T* tv = reinterpret_cast<T*>(dk + VGAP);
    const T zero = from_f32<T>(0.f);
    for (int i = tid; i < KEYS * DP; i += WD_THREADS) {
      const int r = i / DP, d = i % DP, col = k0 + r;
      const bool in = col < kend && d < D;
      tk[r * WT::PITCH + d] = in ? kb[col * kv_sj + d] : zero;
      tv[r * WT::PITCH + d] = in ? vb[col * kv_sj + d] : zero;
    }
  }
}

// q's three bf16 parts of rows [r0, r0 + ROWS) (rows st floats apart) into
// planes qp (hi), qp + QPLANE (mid), qp + 2 QPLANE (lo), every DP column;
// rows at or past S and dims past D zero. Plain loads and stores, the
// caller's next barrier publishes them; with ``vec`` (16-byte rows) every
// load of the thread is issued before the first is split (one round trip
// to device memory, not one a pair).
template <int DP, int QP, int QPLANE, int ROWS>
__device__ __forceinline__ void wide_q_parts(__nv_bfloat16* qp, const float* src, long long st,
                                             int r0, int S, int D, bool vec, int tid) {
  auto put = [&](int r, int d, float x0, float x1) {
    uint32_t parts[3];
    split3_bf16x2(x0, x1, parts);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint32_t*>(qp + p * QPLANE + r * QP + d) = parts[p];
  };
  if (vec) {
    constexpr int QUADS = DP / 4, PER = ROWS * QUADS / WD_THREADS;  // float4s a thread
    float4 x[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * WD_THREADS, r = i / QUADS, d = 4 * (i % QUADS), row = r0 + r;
      x[u] = row < S && d < D ? __ldg(reinterpret_cast<const float4*>(src + row * st + d))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * WD_THREADS, r = i / QUADS, d = 4 * (i % QUADS);
      put(r, d, x[u].x, x[u].y);
      put(r, d + 2, x[u].z, x[u].w);
    }
  } else {
    constexpr int PAIRS = DP / 2;
#pragma unroll 4
    for (int i = tid; i < ROWS * PAIRS; i += WD_THREADS) {
      const int r = i / PAIRS, d = 2 * (i % PAIRS), row = r0 + r;
      const bool in = row < S && d < D;  // D even: d + 1 < D too
      const float* x = src + row * st + d;
      put(r, d, in ? x[0] : 0.f, in ? x[1] : 0.f);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(WD_THREADS, 1) decode_mha_heads_wide_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ kc, const T* __restrict__ vc, long long kv_sb, long long kv_sh,
    long long kv_sj, const float* __restrict__ ks, const float* __restrict__ vs,
    long long sc_sb, long long sc_sh, long long sc_sj, const int32_t* __restrict__ lens,
    float* __restrict__ out, long long o_sb, long long o_sh, long long o_ss, int H, int Hkv,
    int S, int D, int cap, int window, float scale, int vec) {
  using WT = WideTile<DP, T>;
  constexpr int KEYS = WT::KEYS, NT = WT::NT, SLICES = WT::SLICES;
  constexpr int OT = WD_DO / 8;  // 8-dim n-tiles of a warp's output
  constexpr int QP = WT::QPITCH, P = WT::PITCH;
  extern __shared__ __align__(16) unsigned char wd_smem[];
  unsigned char* kv = wd_smem + WT::Q_BYTES;
  float4* psum = reinterpret_cast<float4*>(kv + WT::KV_BYTES);  // [warp][n][lane]

  // Grid (H, B, query tiles), the last tile first: the tiles with the most
  // keys start in the first wave, the shorter ones fill in behind them.
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragments' row group and column pair
  const int rg = warp / SLICES;            // the warp's 16 rows of the block's
  const int d0 = (warp % SLICES) * WD_DO;  // its first head dim
  const int hk = h / (H / Hkv);
  const T* kb = kc + b * kv_sb + hk * kv_sh;
  const T* vb = vc + b * kv_sb + hk * kv_sh;
  const long long sc_off = b * sc_sb + hk * sc_sh;
  const int len = lens[b];
  const int r0 = qt * WT::ROWS;
  const int w0 = r0 + 16 * rg;  // the warp's first query row

  const int last_row = min(S - 1, r0 + WT::ROWS - 1);
  const int kmax = min(len + last_row, cap - 1);
  const int kmin = window > 0 ? max(0, len + r0 - window + 1) : 0;
  const int kstart = (kmin / KEYS) * KEYS;
  const int ntiles = kmax >= kstart ? (kmax - kstart) / KEYS + 1 : 0;
  const int kend = kmax + 1;  // keys from here on are not read (zero fill)
  const float* qb = q + b * q_sb + h * q_sh;
  const bool qvec = reinterpret_cast<uintptr_t>(qb) % 16 == 0 && q_ss % 4 == 0 && D % 4 == 0;

  if (ntiles > 0)
    wide_load<DP, T>(kv, 0, kstart, kb, vb, kv_sj, ks, vs, sc_off, sc_sj, D, kend, vec != 0, tid);
  if constexpr (WT::F32)
    tf32_rows<DP, QP, WD_THREADS>(reinterpret_cast<float*>(wd_smem), qb, q_ss, r0, WT::ROWS, S, D,
                                  qvec, tid);
  cp_async_commit();
  if constexpr (!WT::F32)  // while tile 0 is in flight
    wide_q_parts<DP, QP, WT::QPLANE, WT::ROWS>(reinterpret_cast<__nv_bfloat16*>(wd_smem), qb,
                                               q_ss, r0, S, D, qvec, tid);

  // The columns each of the thread's two rows (g, g + 8) attends: [lo, hi]
  // (hi < lo for a row past S). Scores in base 2: the scale carries log2(e).
  int clo[2], chi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = w0 + g + 8 * i, qpos = len + s;
    chi[i] = s < S ? min(qpos, cap - 1) : -1;
    clo[i] = window > 0 ? max(0, qpos - window + 1) : 0;
  }
  const float scale2 = scale * 1.4426950408889634f;
  const int wlast = min(S - 1, w0 + 15);
  const bool rows_live = w0 < S;   // the row group's (every slice's) decision
  const bool dims_live = d0 < D;   // this slice's
  // The lane's ldmatrix row of the warp's 16 (A fragments: rows g / g + 8).
  const int arow = 16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kstart + t * KEYS, buf = t & 1;
    cp_async_wait<0>();  // tile t (and, first, q) has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; tile t - 1 is consumed
    if (t + 1 < ntiles)
      wide_load<DP, T>(kv, buf ^ 1, k0 + KEYS, kb, vb, kv_sj, ks, vs, sc_off, sc_sj, D, kend,
                       vec != 0, tid);
    cp_async_commit();
    const unsigned char* tkb = WT::QUANT ? kv : kv + buf * 2 * WT::MAT;  // the tile's K
    const unsigned char* tvb = tkb + (WT::QUANT ? WT::TILE * 2 : WT::MAT);  // and V
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (WT::QUANT) {
      const uint8_t* raw = kv + WT::WIDE + buf * 2 * WT::RAW;
      __nv_bfloat16* wk = reinterpret_cast<__nv_bfloat16*>(kv);
      widen_tile<DP, T, KEYS>(raw, wk, D, tid, WD_THREADS);
      widen_tile<DP, T, KEYS>(raw + WT::RAW, wk + WT::TILE, D, tid, WD_THREADS);
      ksc = reinterpret_cast<const float*>(kv + WT::WIDE + 4 * WT::RAW) + buf * 2 * KEYS;
      vsc = ksc + KEYS;
      __syncthreads();  // the widened tile is whole
    }

    // A decision the row group takes together (its barrier below).
    const bool attend = rows_live && k0 <= len + wlast &&
                        (window <= 0 || k0 + KEYS - 1 > len + w0 - window);
    if (!attend) continue;
    // The rows' last key in this tile: n-tiles past it hold no column of
    // them and are skipped.
    const int kw = len + wlast - k0;
    // The partial scores over the warp's dims, each part in accumulators of
    // its own.
    float sp[3][NT][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int n = 0; n < NT; ++n) sp[p][n][0] = sp[p][n][1] = sp[p][n][2] = sp[p][n][3] = 0.f;
    }
    if constexpr (WT::F32) {
      // 3xTF32, 8 dims a step: q's A fragment (rows g / g + 8, dims t / t +
      // 4) and K's B fragments (keys g of two n-tiles) by ldmatrix of the
      // 4-byte words, both split as they are read; the terms small.big,
      // big.small and big.big in sp[0], sp[1], sp[2].
      const float* tk = reinterpret_cast<const float*>(tkb);
      const float* q_l = reinterpret_cast<const float*>(wd_smem) + arow * QP + 4 * (lane >> 4);
#pragma unroll 4
      for (int kk = 0; kk < WD_DO / 8; ++kk) {
        const int dim = d0 + kk * 8;
        if (dim >= D) break;
        uint32_t qa[4], qbig[4], qsml[4];
        ldmatrix_x4(qa, q_l + dim);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qa[i], qbig[i], qsml[i]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 > kw) continue;
          const int off = (n * 8 + 8 * (lane >> 4) + (lane & 7)) * P + dim + 4 * ((lane >> 3) & 1);
          uint32_t kr[4], kbig[4], ksml[4];
          ldmatrix_x4(kr, tk + off);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(kr[i], kbig[i], ksml[i]);
          mma_tf32(sp[0][n], qsml, kbig[0], kbig[1]);
          mma_tf32(sp[0][n + 1], qsml, kbig[2], kbig[3]);
          mma_tf32(sp[1][n], qbig, ksml[0], ksml[1]);
          mma_tf32(sp[1][n + 1], qbig, ksml[2], ksml[3]);
          mma_tf32(sp[2][n], qbig, kbig[0], kbig[1]);
          mma_tf32(sp[2][n + 1], qbig, kbig[2], kbig[3]);
        }
      }
    } else {
      // Three bf16 parts of q (lo, mid, hi in sp[0], sp[1], sp[2]) against
      // K's exact bf16 values, 16 dims a step: q's A fragments by ldmatrix
      // from the planes, K's by ldmatrix (each x4 load feeds two n-tiles).
      const __nv_bfloat16* tk = reinterpret_cast<const __nv_bfloat16*>(tkb);
      const __nv_bfloat16* q_l =
          reinterpret_cast<const __nv_bfloat16*>(wd_smem) + arow * QP + 8 * (lane >> 4);
#pragma unroll 4
      for (int kk = 0; kk < WD_DO / 16; ++kk) {
        const int dim = d0 + kk * 16;
        if (dim >= D) break;
        uint32_t qa[3][4];
#pragma unroll
        for (int p = 0; p < 3; ++p) ldmatrix_x4(qa[p], q_l + p * WT::QPLANE + dim);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 > kw) continue;
          // Matrices: keys n*8.. / dims dim, dim + 8; keys + 8, both.
          const int key = n * 8 + (lane >> 4) * 8 + (lane & 7);
          uint32_t bk[4];
          ldmatrix_x4(bk, tk + key * P + dim + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int p = 0; p < 3; ++p) {  // plane p: hi, mid, lo
            mma_bf16(sp[2 - p][n], qa[p], bk[0], bk[1]);
            mma_bf16(sp[2 - p][n + 1], qa[p], bk[2], bk[3]);
          }
        }
      }
    }
    // The row group's scores: every slice's partial, summed in slice order.
#pragma unroll
    for (int n = 0; n < NT; ++n)
      psum[(warp * NT + n) * 32 + lane] =
          make_float4((sp[0][n][0] + sp[1][n][0]) + sp[2][n][0],
                      (sp[0][n][1] + sp[1][n][1]) + sp[2][n][1],
                      (sp[0][n][2] + sp[1][n][2]) + sp[2][n][2],
                      (sp[0][n][3] + sp[1][n][3]) + sp[2][n][3]);
    group_sync(1 + rg, SLICES * 32);
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float4 x = psum[((rg * SLICES) * NT + n) * 32 + lane];
#pragma unroll
      for (int z = 1; z < SLICES; ++z) {
        const float4 y = psum[((rg * SLICES + z) * NT + n) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      sacc[n][0] = x.x;
      sacc[n][1] = x.y;
      sacc[n][2] = x.z;
      sacc[n][3] = x.w;
    }

    // Scale (base 2), mask, the online softmax of rows g (e < 2) and g + 8.
    const int lo0 = clo[0] - k0 - 2 * tg, hi0 = chi[0] - k0 - 2 * tg;
    const int lo1 = clo[1] - k0 - 2 * tg, hi1 = chi[1] - k0 - 2 * tg;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (e & 1);  // the column, less k0 + 2 tg
        const bool ok = e < 2 ? c >= lo0 && c <= hi0 : c >= lo1 && c <= hi1;
        const float kscale = WT::QUANT ? ksc[c + 2 * tg] : 1.f;
        sacc[n][e] = ok ? sacc[n][e] * scale2 * kscale : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], sacc[n][e]);
      }
    }
    float alpha[2], mu[2], psm[2] = {0.f, 0.f};
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
        psm[e >> 1] += p;
        sacc[n][e] = WT::QUANT ? p * vsc[n * 8 + (e & 1) + 2 * tg] : p;  // the value weight
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psm[i] += __shfl_xor_sync(FULL, psm[i], 1);
      psm[i] += __shfl_xor_sync(FULL, psm[i], 2);
      l[i] = l[i] * alpha[i] + psm[i];
    }
    if (!dims_live) continue;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    if constexpr (WT::F32) {
      // O += P V in 3xTF32, 8 keys a step in the score accumulator's order
      // (a0 = P[g][2t], a1 = P[g + 8][2t], a2 = P[g][2t + 1], a3 = P[g +
      // 8][2t + 1]); V's B fragment rows 2t, 2t + 1, the warp's column d0 +
      // g, split as read.
      const float* tv = reinterpret_cast<const float*>(tvb);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 > kw) continue;
        const uint32_t pa[4] = {__float_as_uint(sacc[n][0]), __float_as_uint(sacc[n][2]),
                                __float_as_uint(sacc[n][1]), __float_as_uint(sacc[n][3])};
        uint32_t pbig[4], psml[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(pa[i], pbig[i], psml[i]);
        const float* vr = tv + (n * 8 + 2 * tg) * P + d0 + g;
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          if (d0 + j * 8 >= D) continue;
          uint32_t vb0, vs0, vb1, vs1;
          split_tf32(__float_as_uint(vr[j * 8]), vb0, vs0);
          split_tf32(__float_as_uint(vr[P + j * 8]), vb1, vs1);
          mma_3xtf32(o[j], pbig, psml, vb0, vb1, vs0, vs1);
        }
      }
    } else {
      // O += the three parts of (p vs) . V, 16 keys a step: the score
      // accumulators of n-tiles 2kk and 2kk + 1 are the A fragment.
      const __nv_bfloat16* tv = reinterpret_cast<const __nv_bfloat16*>(tvb);
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
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
        for (int j = 0; j < OT; j += 2) {
          if (d0 + j * 8 >= D) continue;
          // Matrices: keys kk*16.. / + 8 at dims d0 + j*8, then + 8.
          const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int dim = d0 + j * 8 + (lane >> 4) * 8;
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, tv + key * P + dim);
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

  if (!rows_live || !dims_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = w0 + g + i * 8;
    if (s >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = out + b * o_sb + h * o_sh + (long long)s * o_ss;
#pragma unroll
    for (int j = 0; j < OT; ++j) {  // D even, rows 8-byte aligned: dims in pairs
      const int d = d0 + j * 8 + 2 * tg;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

}  // namespace
