// paged_decode_mha for Hopper (sm_90a): one decode step (S == 1) of
// attention over paged KV block pools.
//
// Replaces rten_tpu/kernels/flash_attention.py:3425 paged_decode_mha (the
// pallas_call whose K/V index maps DMA pool block bt[slot, j] at grid step
// (slot, j), with the block table in scalar prefetch).
//
// q [B, H, 1, D] f32 against pools [NB, Hkv, BS, D], either s8 with scale
// pools [NB, Hkv, 1, BS] f32 (positions lane-major per block), or f32 or
// bf16 with no scales (``kind``, KvKind; this library holds s8, f32 is in
// paged_decode_mha_f32.cu and bf16 in paged_decode_mha_bf16.cu, translation
// units of their own so that nvcc builds them in parallel). Slot b's logical position p lives at
// pool[bt[b, p / BS], :, p % BS] (bt [B, MB] int32), so cap = MB * BS. The
// query of slot b sits at position lens[b] (its row already written) and
// attends columns j <= lens[b] (every column once lens[b] >= cap) and,
// with a window, j > lens[b] - window; a row with no column gives 0. GQA
// is kv-major. These are decode_mha's fold semantics at cap = MB * BS.
//
// Bound on the H100: bytes. A call reads each live K/V row once
// (2 * (min(lens, cap - 1) + 1) * Hkv * (D + 4) bytes per slot with s8
// rows and their scales) and does 4 * group flops per byte of an s8 row.
//
// Design: decode_mha's fold (decode_fold.cuh) with table addressing and
// split-K. A call at 16 slots has 64 (slot, kv head) units, too few for
// 132 SMs, so each unit's columns are cut into chunks
// (kernels/flash_attention.py, decode_split_plan: 4 of 64 at TinyLlama's
// shape), one 128-thread block each, and the last block of a unit merges
// the chunks' softmax states in chunk order. A block reads each live K/V
// row of its chunk once for the group's query rows and reads the table
// itself: each lane resolves the table entry of the key it scores (16-byte
// K loads from the pool row), and the V stage takes each key's row offset
// from the lane that resolved it by a shuffle. A block resolves only its
// own chunk's entries, and entries past the slot's last live column are
// never read, so they may be 0 (the garbage sink). Rows of one pool block
// are contiguous in the head-major pool, so a warp's 32 keys touch at most
// two blocks when BS >= 32; a table entry per row covers any BS (a
// multiple of 8 is all the model graphs guarantee).
// Head dims: the fold's instances DP = 64, 128, 256 (group up to 8) and 512
// (group up to 4); any even D runs in the smallest that holds it.
// Its own source, so that nvcc builds it in parallel with decode_mha.cu.
// The pools' strides are arguments, so the block-table append
// (flash_attention.cu) attends its cat-layout pools [NB, BS, Hkv*D]
// through this entry point too (rows of Hkv * D, heads D apart).

#include "decode_fold.cuh"

extern "C" int rten_paged_decode_mha(int kind, RTEN_PAGED_PARAMS) {
  if (kind != KV_S8) return (int)cudaErrorInvalidValue;
  return launch_paged_decode_mha<int8_t>(RTEN_PAGED_NAMES);
}
