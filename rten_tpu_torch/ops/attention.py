"""Attention ops (the port of ``rten_tpu/ops/attention.py``): ONNX
``Attention`` and MS contrib ``MultiHeadAttention`` over whole K/V (the
Generator's graphs), and QuantizedKVAttention and GroupQueryAttention on
serving KV caches.

Attention / MultiHeadAttention (``attention.py:212-347``): 3-D or 4-D
inputs, past K/V concatenated in front (returned as the presents), bool or
additive masks. Routing follows the reference's ``mha`` rule
(``kernels/flash_attention.py:3588-3593``): a mask that folds to 2-D and
Tq >= 8 go to the flash-attention kernel wrapper ``mha`` (the CUDA kernel
on the card; its plain version on the CPU); anything else (a decode step,
a per-batch mask) to ``mha_plain``. The kernel gives 0 on a row with no
column to attend (left padding), the plain version the mean of V.

QuantizedKVAttention (int8 caches, or int4 with ``bits=4``: u8 nibbles
[..., D/2] from ``pack_int4``, scales absmax/7):

inputs: q, k, v [B,S,H*D] f32; past_k_q8; k_scales [B,Hkv,cap,1] f32;
        past_v_q8; v_scales; past_lens [B] i32; with ``rten_recent_kv`` the
        recent windows recent_k, recent_v [B,Hkv,W,D] and step_t [1] i32
        (inputs 8-10); with ``do_rotary`` the cos/sin tables [max_pos,
        rot/2] as the last two inputs
outputs: out [B,S,H*D], new_k_q8, new_k_scales, new_v_q8, new_v_scales
         (and, deferred, the windows)

* with ``do_rotary``, q and k rotate first, at positions past_lens + s
  (``attention.py:757-768``);
* ``rten_recent_kv`` (deferred KV, ``attention.py:786-822``): at S == 1
  ``decode_attention_deferred`` writes the step's row into window row
  step_t and attends the caches below lens0 = past_lens - step_t plus the
  window, the caches passing through unchanged; at S > 1 the rows are
  quantized and written into the caches, ``decode_mha`` attends, and the
  windows pass through;
* cat caches [B,cap,Hkv*D], S == 1 with ``rten_kernel_append``:
  ``decode_mha_append_cat`` quantizes the new row, appends it and attends
  (``attention.py:880-893``);
* cat caches otherwise: quantize the chunk's rows, write them at each
  slot's offset, then ``prefill_mha_cat`` (int4: ``decode_mha`` over
  head-major views) (``attention.py:903-932``);
* head-major caches [B,Hkv,cap,D], S == 1 with ``rten_kernel_append``:
  ``decode_mha_append`` (``attention.py:894-901``);
* head-major caches otherwise: quantize the rows, write them at each
  slot's clamped offset, then ``decode_mha`` (``attention.py:934-953``);
* ``rten_paged`` (``attention.py:824-878``): block pools addressed through
  the block table (input 8), scale pools [NB,Hkv,1,BS]. Head-major s8 pools
  [NB,Hkv,BS,D]: write the quantized rows, ``paged_attention``. Cat pools
  [NB,BS,Hkv*D]: at S == 1 with ``rten_kernel_append`` the block-table
  ``decode_mha_append_cat``; otherwise write the rows, gather each slot's
  blocks, ``decode_mha``.

GroupQueryAttention (the ``rten_past_lens`` serving form on f32 or bf16
caches, ``attention.py:380-468``): rotary first, then the new rows are
written as ``k.to(cache dtype)`` and attention reads the cache values in
f32:

* cat caches [B,cap,Hkv*D], S == 1 with ``rten_kernel_append``:
  ``decode_mha_append_cat`` writes the row and attends (``attention.py:577-593``);
* cat caches otherwise: write the chunk's rows at each slot's offset, then
  ``prefill_mha_cat`` (``attention.py:603-639``);
* head-major caches [B,Hkv,cap,D], S == 1 with ``rten_kernel_append``:
  ``decode_mha_append`` (``attention.py:594-601``); otherwise write the
  rows at each slot's clamped offset, ``decode_mha`` (``attention.py:641-676``);
* ``rten_recent_kv`` (deferred KV on head-major f32/bf16 caches, the
  windows and step_t as inputs 9-11, ``attention.py:522-570``): at S == 1
  ``decode_attention_deferred``, at S > 1 the caches written and
  ``decode_mha``; a local window and softcap are refused as the reference
  refuses them;
* ``rten_paged`` (``attention.py:470-520``, the block table as input 9):
  cat pools [NB,BS,Hkv*D] at S == 1 with ``rten_kernel_append`` the
  block-table ``decode_mha_append_cat``, otherwise write the rows, gather
  each slot's blocks, cast to f32, ``decode_mha``; head-major pools
  [NB,Hkv,BS,D]: write the rows, ``paged_attention``.

Paged writes follow the reference's two rules for a position past the
table: the pool helpers below send it to block 0 (the garbage sink), the
cat-pool append clamps it to cap - 1 first. Rows that several slots write
(idle slots all point at block 0) resolve as the reference's in-order
writes do, the last writer winning (``paged_targets``).

The caches (and the deferred windows) are updated in place and returned as
the present outputs (the executor copies them first unless the caller
donated them). Every other
branch raises ``NotImplementedError`` naming the ROADMAP.md item.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import (
    NEG_INF, cat_to_heads, decode_attention_deferred, decode_mha, decode_mha_append,
    decode_mha_append_cat, heads_to_cat, mha, mha_plain, pack_int4, paged_attention,
    paged_gather_cat, paged_gather_scales, paged_targets, prefill_mha_cat, quantize_rows,
)
from .registry import OpError, get_input, opt_input, register


def _todo(what: str, item: int):
    raise NotImplementedError(f"{what}: ROADMAP.md queue 1 item {item}")


def _attend(q, k, v, mask=None, *, scale=None, causal=False, softcap=0.0):
    """The reference's ``mha`` dispatch: the flash-attention kernel for
    prefill-sized queries (Tq >= 8) with at most a 2-D mask, the
    materialized-score plain version otherwise."""
    if q.shape[2] >= 8 and (mask is None or mask.ndim <= 2):
        return mha(q, k, v, mask, scale=scale, causal=causal, softcap=softcap)
    return mha_plain(q, k, v, mask, scale=scale, causal=causal, softcap=softcap)


@register("Attention")
def _attention(ctx, inputs, attrs):
    """ONNX opset-23 Attention (rten src/ops/attention.rs:645): Q
    [B,Hq,Tq,D] or [B,Tq,Hq*D], K/V likewise; optional attn_mask (bool, True
    keeps, or additive float); past_key/past_value in front of K/V. Outputs
    Y (+ present_key, present_value)."""
    q = get_input(inputs, 0, "query")
    k = get_input(inputs, 1, "key")
    v = get_input(inputs, 2, "value")
    mask = opt_input(inputs, 3)
    past_k = opt_input(inputs, 4)
    past_v = opt_input(inputs, 5)

    three_d = q.ndim == 3
    if three_d:
        q_heads = attrs.get("q_num_heads")
        kv_heads = attrs.get("kv_num_heads", q_heads)
        if q_heads is None:
            raise OpError("Attention with 3D inputs requires q_num_heads")
        q = cat_to_heads(q, q_heads)
        k = cat_to_heads(k, kv_heads)
        v = cat_to_heads(v, kv_heads)
    if past_k is not None:
        k = torch.cat([past_k, k], dim=2)
        v = torch.cat([past_v, v], dim=2)

    add_mask = None
    if mask is not None:
        add_mask = (torch.where(mask, 0.0, NEG_INF) if mask.dtype == torch.bool
                    else mask.to(torch.float32))
        # Fold leading unit dims: the kernel takes a 2-D mask.
        while add_mask.ndim > 2 and add_mask.shape[0] == 1:
            add_mask = add_mask[0]
    out = _attend(q, k, v, add_mask, scale=attrs.get("scale"),
                  causal=bool(attrs.get("is_causal", 0)), softcap=attrs.get("softcap", 0.0))
    if three_d:
        out = heads_to_cat(out)
    if attrs.get("__n_outputs__", 1) >= 3:
        return (out, k, v)
    return out


@register("MultiHeadAttention")
def _multi_head_attention(ctx, inputs, attrs):
    """MS contrib MultiHeadAttention (rten contrib.rs:48): query [B,Tq,H*D]
    (or packed QKV [B,Tq,H,3,D] when key is absent), key/value [B,Tk,H*D]
    or pre-split [B,H,Tk,D]; optional bias [3*H*D], key_padding_mask,
    attention_bias, past_key/past_value."""
    query = get_input(inputs, 0, "query")
    key = opt_input(inputs, 1)
    value = opt_input(inputs, 2)
    bias = opt_input(inputs, 3)
    key_padding_mask = opt_input(inputs, 4)
    attention_bias = opt_input(inputs, 5)
    past_k = opt_input(inputs, 6)
    past_v = opt_input(inputs, 7)
    n_heads = attrs.get("num_heads")
    if n_heads is None:
        raise OpError("MultiHeadAttention requires num_heads")
    scale = attrs.get("scale")
    causal = bool(attrs.get("unidirectional", 0))
    mask_filter = attrs.get("mask_filter_value", -10000.0)

    if query.ndim == 5:  # packed QKV [B,S,H,3,D]
        q, k, v = (query[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        hidden = query.shape[-1]
        if bias is not None:
            query = query + bias[:hidden]
            if key is not None and key.ndim == 3:
                key = key + bias[hidden:2 * hidden]
            if value is not None and value.ndim == 3:
                value = value + bias[2 * hidden:]
        q = cat_to_heads(query, n_heads)
        if key is not None and key.ndim == 4:
            k, v = key, value  # already [B,H,Tk,D]
        else:
            k = cat_to_heads(key, n_heads)
            v = cat_to_heads(value, n_heads)
    if past_k is not None:
        k = torch.cat([past_k, k], dim=2)
        v = torch.cat([past_v, v], dim=2)

    add_mask = None
    if attention_bias is not None:
        add_mask = attention_bias.to(torch.float32)
    if key_padding_mask is not None:
        keep = (key_padding_mask if key_padding_mask.dtype == torch.bool
                else key_padding_mask.to(torch.int32) != 0)
        pad = torch.where(keep, 0.0, float(mask_filter))[:, None, None, :]
        add_mask = pad if add_mask is None else add_mask + pad
    if add_mask is not None:
        while add_mask.ndim < 4:
            add_mask = add_mask[None]
        out = mha_plain(q, k, v, add_mask, scale=scale, causal=causal)
    else:
        out = _attend(q, k, v, None, scale=scale, causal=causal)
    out = heads_to_cat(out)
    if attrs.get("__n_outputs__", 1) >= 3:
        return (out, k, v)
    return out


def rotary(x, cos_cache, sin_cache, position_ids, interleaved: bool):
    """Rotary embedding of x [B,H,S,D] at positions [B,S] (rotates the
    first 2 * cos_cache.shape[-1] dims), the JAX package's ``_rotary``.

    The tables are read as ``jnp.asarray(table)[position_ids]`` reads them:
    a negative position counts from the end and the result is clamped to
    [0, max_pos - 1], so an idle slot whose length ran past the table
    reads its last row (not NaN, and no device assert)."""
    n = cos_cache.shape[0]
    pos = position_ids.to(torch.int64)
    pos = torch.where(pos < 0, pos + n, pos).clamp(0, n - 1)
    cos = cos_cache[pos][:, None]  # [B,1,S,rot/2]
    sin = sin_cache[pos][:, None]
    rot = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              dim=-1).reshape(x_rot.shape)
    else:
        half = rot // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1) if x_pass.shape[-1] else rotated


def _rotate_qk(q4, k4, cos_cache, sin_cache, lens, attrs):
    """Rotate q and k [B,H,S,D] at positions lens[b] + s."""
    if cos_cache is None or sin_cache is None:
        raise OpError("do_rotary requires cos/sin caches")
    S = q4.shape[2]
    pos = lens.to(torch.int64)[:, None] + torch.arange(S, device=lens.device)[None]
    interleaved = bool(attrs.get("rotary_interleaved", 0))
    return (rotary(q4, cos_cache, sin_cache, pos, interleaved),
            rotary(k4, cos_cache, sin_cache, pos, interleaved))


def _rows(starts: torch.Tensor, S: int, cap: int) -> torch.Tensor:
    """Row indices [B, S] of a per-slot S-row write, each start clamped to
    [0, cap - S] as ``dynamic_update_slice`` clamps it."""
    st = starts.to(torch.int64).clamp(0, cap - S)
    return st[:, None] + torch.arange(S, device=starts.device)[None]


def slot_kv_update_cat(buf, new, starts):
    """Write rows ``new`` [B, S, Hkv*D] into the [B, cap, Hkv*D] cache at
    per-slot offsets, in place."""
    B, S = new.shape[:2]
    rows = _rows(starts, S, buf.shape[1])
    buf[torch.arange(B, device=buf.device)[:, None], rows] = new.to(buf.dtype)
    return buf


def slot_kv_update(buf, new, starts):
    """Write ``new`` [B, H, S, X] into a [B, H, cap, X] buffer at per-slot
    offsets, in place."""
    B, H, S = new.shape[:3]
    rows = _rows(starts, S, buf.shape[2])
    bidx = torch.arange(B, device=buf.device)[:, None, None]
    hidx = torch.arange(H, device=buf.device)[None, :, None]
    buf[bidx, hidx, rows[:, None, :]] = new.to(buf.dtype)
    return buf


# --- paged KV pools (the JAX package's ``_paged_*`` helpers) -----------------
# Each writes in place and returns the pool. ``targets`` takes the result of
# ``paged_targets`` for these starts, so that the K, V and scale writes of
# one op share it.


def paged_kv_update(pool, new, starts, bt, targets=None):
    """Write rows ``new`` [B, H, S, D] into a head-major pool [NB, H, BS, D]
    at logical positions starts[b] + s (``_paged_kv_update``)."""
    B, H, S, D = new.shape
    blk, off, src = targets or paged_targets(starts, S, bt, pool.shape[0], pool.shape[2])
    rows = new.permute(0, 2, 1, 3).reshape(B * S, H, D).to(pool.dtype)
    pool[blk, :, off] = rows[src]
    return pool


def paged_kv_update_cat(pool, new_cat, starts, bt, targets=None):
    """Cat-layout sibling: rows ``new_cat`` [B, S, Hkv*D] into a pool
    [NB, BS, Hkv*D] (``_paged_kv_update_cat``)."""
    B, S, HkvD = new_cat.shape
    blk, off, src = targets or paged_targets(starts, S, bt, pool.shape[0], pool.shape[1])
    pool[blk, off] = new_cat.reshape(B * S, HkvD).to(pool.dtype)[src]
    return pool


def paged_scale_update(spool, s_new, starts, bt, targets=None):
    """Scales ``s_new`` [B, Hkv, S, 1] into a scale pool [NB, Hkv, 1, BS]
    (positions lane-major per block; ``_paged_scale_update``)."""
    B, Hkv, S, _ = s_new.shape
    blk, off, src = targets or paged_targets(starts, S, bt, spool.shape[0], spool.shape[3])
    rows = s_new[..., 0].permute(0, 2, 1).reshape(B * S, Hkv).to(spool.dtype)
    spool.select(2, 0)[blk, :, off] = rows[src]
    return spool


# The JAX package's ``_paged_gather_cat`` and ``_paged_gather_scales_flat``
# ([NB, Hkv, 1, BS] -> [B, Hkv, MB*BS], the same as ``paged_gather_scales``).
paged_gather_scales_flat = paged_gather_scales


def _block_table(inputs, i):
    bt = get_input(inputs, i, "block_table")
    if bt.dtype != torch.int32 or bt.dim() != 2:
        raise OpError(f"block_table must be [slots, max_blocks] int32, got "
                      f"{bt.dtype} {tuple(bt.shape)}")
    return bt


def _quantized_paged(q4, k4, v4, pk, ks, pv, vs, lens, bt, attrs, scale, window):
    """QuantizedKVAttention's ``rten_paged`` branch (s8 pools)."""
    B, S = q4.shape[0], q4.shape[2]
    kv_heads = k4.shape[1]
    if pk.ndim == 3:
        if S == 1 and attrs.get("rten_kernel_append", 0):
            out, nk, nv, nks, nvs = decode_mha_append_cat(
                q4, pk, pv, lens, ks, vs, k_new=k4, v_new=v4, scale=scale,
                window=window, block_table=bt,
            )
            return (out, nk, nks, nv, nvs)
        k_q8, k_s = quantize_rows(k4)
        v_q8, v_s = quantize_rows(v4)
        t = paged_targets(lens, S, bt, pk.shape[0], pk.shape[1])
        paged_kv_update_cat(pk, heads_to_cat(k_q8), lens, bt, t)
        paged_kv_update_cat(pv, heads_to_cat(v_q8), lens, bt, t)
        paged_scale_update(ks, k_s, lens, bt, t)
        paged_scale_update(vs, v_s, lens, bt, t)
        out = decode_mha(
            q4, cat_to_heads(paged_gather_cat(pk, bt), kv_heads),
            cat_to_heads(paged_gather_cat(pv, bt), kv_heads), lens,
            paged_gather_scales_flat(ks, bt), paged_gather_scales_flat(vs, bt),
            scale=scale, window=window,
        )
        return (heads_to_cat(out), pk, ks, pv, vs)
    k_q8, k_s = quantize_rows(k4)
    v_q8, v_s = quantize_rows(v4)
    t = paged_targets(lens, S, bt, pk.shape[0], pk.shape[2])
    paged_kv_update(pk, k_q8, lens, bt, t)
    paged_scale_update(ks, k_s, lens, bt, t)
    paged_kv_update(pv, v_q8, lens, bt, t)
    paged_scale_update(vs, v_s, lens, bt, t)
    out = paged_attention(q4, pk, pv, lens, bt, ks, vs, scale=scale, window=window)
    return (heads_to_cat(out), pk, ks, pv, vs)


_DEFERRED_WINDOW = ("local_window_size with deferred KV is unsupported; build the "
                    "serving graph with deferred_kv=False")


def _deferred_step(inputs, i, lens):
    """The deferred form's windows and step (inputs i, i + 1, i + 2) ->
    (recent_k, recent_v, t [1] int32, lens0 = past_lens - t)."""
    recent_k = get_input(inputs, i, "recent_k")
    recent_v = get_input(inputs, i + 1, "recent_v")
    t = get_input(inputs, i + 2, "step_t").reshape(-1)[:1].to(torch.int32)
    return recent_k, recent_v, t, (lens - t).to(torch.int32)


@register("QuantizedKVAttention", inplace=(3, 4, 5, 6, 8, 9))
def _quantized_kv_attention(ctx, inputs, attrs):
    q = get_input(inputs, 0, "query")
    k = get_input(inputs, 1, "key")
    v = get_input(inputs, 2, "value")
    past_k_q8 = get_input(inputs, 3, "past_k_q8")
    k_scales = get_input(inputs, 4, "k_scales")
    past_v_q8 = get_input(inputs, 5, "past_v_q8")
    v_scales = get_input(inputs, 6, "v_scales")
    past_lens = get_input(inputs, 7, "past_lens")
    n_heads = attrs.get("num_heads")
    kv_heads = attrs.get("kv_num_heads", n_heads)
    scale = attrs.get("scale")
    bits = int(attrs.get("bits", 8))
    quantize = pack_int4 if bits == 4 else quantize_rows
    lws = int(attrs.get("local_window_size", -1))
    window = lws if lws > 0 else 0
    deferred = bool(attrs.get("rten_recent_kv", 0))
    if past_lens.dtype != torch.int32:
        raise OpError("past_lens must be int32")

    B, S, _ = q.shape
    lens = past_lens.reshape(B)
    # [B, S, H*D] -> [B, H, S, D] views
    q4 = cat_to_heads(q, n_heads)
    k4 = cat_to_heads(k, kv_heads)
    v4 = cat_to_heads(v, kv_heads)
    if attrs.get("do_rotary", 0):
        q4, k4 = _rotate_qk(q4, k4, inputs[-2], inputs[-1], lens, attrs)

    if window and deferred:
        raise OpError(_DEFERRED_WINDOW)
    if deferred:
        # Decode steps keep their rows in the windows (the engine commits
        # them once per dispatch); prefill writes the caches directly.
        recent_k, recent_v, t, lens0 = _deferred_step(inputs, 8, lens)
        cap = past_k_q8.shape[2]
        if S == 1:
            out, rk, rv = decode_attention_deferred(
                q4, past_k_q8, past_v_q8, lens0, k_scales.reshape(B, kv_heads, cap),
                v_scales.reshape(B, kv_heads, cap), scale=scale, recent_k=recent_k,
                recent_v=recent_v, t=t, k_new=k4, v_new=v4,
            )
            return (heads_to_cat(out), past_k_q8, k_scales, past_v_q8, v_scales, rk, rv)
        k_q, k_s = quantize(k4)
        v_q, v_s = quantize(v4)
        new_k = slot_kv_update(past_k_q8, k_q, lens)
        new_ks = slot_kv_update(k_scales, k_s, lens)
        new_v = slot_kv_update(past_v_q8, v_q, lens)
        new_vs = slot_kv_update(v_scales, v_s, lens)
        out = decode_mha(q4, new_k, new_v, lens, new_ks.reshape(B, kv_heads, cap),
                         new_vs.reshape(B, kv_heads, cap), scale=scale)
        return (heads_to_cat(out), new_k, new_ks, new_v, new_vs, recent_k, recent_v)

    if attrs.get("rten_paged", 0):
        if bits != 8:
            raise OpError("rten_paged quantized KV supports bits=8 only")
        bt = _block_table(inputs, 8)
        return _quantized_paged(q4, k4, v4, past_k_q8, k_scales, past_v_q8, v_scales,
                                lens, bt, attrs, scale, window)

    if S == 1 and attrs.get("rten_kernel_append", 0):
        if bits != 8:
            raise OpError("rten_kernel_append supports bits=8 only")
        append = decode_mha_append if past_k_q8.ndim == 4 else decode_mha_append_cat
        out, nk, nv, nks, nvs = append(
            q4, past_k_q8, past_v_q8, lens, k_scales, v_scales,
            k_new=k4, v_new=v4, scale=scale, window=window,
        )
        # The cat append's out arrives in cat layout [B, 1, H*D] == merged heads.
        return (heads_to_cat(out) if out.ndim == 4 else out, nk, nks, nv, nvs)

    k_q8, k_s = quantize(k4)
    v_q8, v_s = quantize(v4)
    new_k_s = slot_kv_update(k_scales, k_s, lens)
    new_v_s = slot_kv_update(v_scales, v_s, lens)
    if past_k_q8.ndim == 4:
        # Head-major caches [B, Hkv, cap, D] (int4: [B, Hkv, cap, D/2]).
        new_k_q8 = slot_kv_update(past_k_q8, k_q8, lens)
        new_v_q8 = slot_kv_update(past_v_q8, v_q8, lens)
        cap = past_k_q8.shape[2]
        out = decode_mha(
            q4, new_k_q8, new_v_q8, lens, new_k_s.reshape(B, kv_heads, cap),
            new_v_s.reshape(B, kv_heads, cap), scale=scale, window=window,
        )
        return (heads_to_cat(out), new_k_q8, new_k_s, new_v_q8, new_v_s)

    new_kc = slot_kv_update_cat(past_k_q8, heads_to_cat(k_q8), lens)
    new_vc = slot_kv_update_cat(past_v_q8, heads_to_cat(v_q8), lens)
    if bits == 4:
        # int4 cat rows: decode_mha over head-major views of the caches.
        cap = past_k_q8.shape[1]
        out = decode_mha(
            q4, cat_to_heads(new_kc, kv_heads), cat_to_heads(new_vc, kv_heads), lens,
            new_k_s.reshape(B, kv_heads, cap), new_v_s.reshape(B, kv_heads, cap),
            scale=scale, window=window,
        )
    else:
        out = prefill_mha_cat(
            q4, new_kc, new_vc, lens, new_k_s, new_v_s, scale=scale, window=window,
        )
    return (heads_to_cat(out), new_kc, new_k_s, new_vc, new_v_s)


@register("GroupQueryAttention", inplace=(3, 4, 9, 10))
def _group_query_attention(ctx, inputs, attrs):
    """The ``rten_past_lens`` serving form: query/key/value [B,S,H*D] f32,
    past_key/past_value f32 or bf16 caches or pools (the module docstring
    lists the layouts), seqlens_k [B] per-slot PAST lengths, cos/sin tables
    (inputs 7, 8) with ``do_rotary``, the block table (input 9) with
    ``rten_paged``, the recent windows and step_t (inputs 9-11) with
    ``rten_recent_kv``. Outputs: out [B,S,H*D] and the updated caches (and,
    deferred, the windows)."""
    query = get_input(inputs, 0, "query")
    key = opt_input(inputs, 1)
    value = opt_input(inputs, 2)
    past_k = opt_input(inputs, 3)
    past_v = opt_input(inputs, 4)
    seqlens_k = opt_input(inputs, 5)
    n_heads = attrs.get("num_heads")
    kv_heads = attrs.get("kv_num_heads")
    if n_heads is None or kv_heads is None:
        raise OpError("GroupQueryAttention requires num_heads and kv_num_heads")
    paged = bool(attrs.get("rten_paged", 0))
    deferred = bool(attrs.get("rten_recent_kv", 0)) and not paged
    if not attrs.get("rten_past_lens", 0):
        _todo("ONNX (ORT-compatible) GroupQueryAttention", 12)
    if not deferred and (attrs.get("softcap", 0.0) or (not paged and any(
            opt_input(inputs, i) is not None for i in (9, 10, 11)))):
        _todo("GroupQueryAttention with softcap, position ids, bias or sinks", 12)
    if key is None or value is None:
        _todo("packed QKV GroupQueryAttention", 12)
    if seqlens_k is None or past_k is None or past_v is None:
        raise OpError("rten_past_lens requires seqlens_k and the caches")
    if past_k.dtype not in (torch.float32, torch.bfloat16) or past_k.ndim not in (3, 4):
        raise OpError(f"rten_past_lens caches must be [B, Hkv, cap, D] or [B, cap, Hkv*D] "
                      f"float32 or bfloat16, got {past_k.dtype} {tuple(past_k.shape)}")
    lws = int(attrs.get("local_window_size", -1))
    window = lws if lws > 0 else 0

    B = query.shape[0]
    lens = seqlens_k.to(torch.int32).reshape(B)
    q4 = cat_to_heads(query, n_heads)
    k4 = cat_to_heads(key, kv_heads)
    v4 = cat_to_heads(value, kv_heads)
    if attrs.get("do_rotary", 0):
        q4, k4 = _rotate_qk(q4, k4, opt_input(inputs, 7), opt_input(inputs, 8),
                            lens, attrs)
    scale = attrs.get("scale")
    S = q4.shape[2]
    kernel_append = S == 1 and bool(attrs.get("rten_kernel_append", 0))
    n_out = attrs.get("__n_outputs__", 1)
    if deferred:
        if window:
            raise OpError(_DEFERRED_WINDOW)
        if attrs.get("softcap", 0.0):
            raise OpError("rten_recent_kv (deferred KV) does not support softcap; "
                          "build the serving graph with deferred_kv=False")
        recent_k, recent_v, t, lens0 = _deferred_step(inputs, 9, lens)
        if S == 1:
            out, rk, rv = decode_attention_deferred(
                q4, past_k, past_v, lens0, scale=scale, recent_k=recent_k,
                recent_v=recent_v, t=t, k_new=k4, v_new=v4,
            )
            return (heads_to_cat(out), past_k, past_v, rk, rv)[:n_out]
        k_all = slot_kv_update(past_k, k4, lens)
        v_all = slot_kv_update(past_v, v4, lens)
        out = heads_to_cat(decode_mha(q4, k_all, v_all, lens, scale=scale))
        return (out, k_all, v_all, recent_k, recent_v)[:n_out]
    if paged:
        bt = _block_table(inputs, 9)
        if past_k.ndim == 3:  # cat pools [NB, BS, Hkv*D]
            if kernel_append:
                out, k_all, v_all = decode_mha_append_cat(
                    q4, past_k, past_v, lens, k_new=k4, v_new=v4, scale=scale,
                    window=window, block_table=bt,
                )
            else:
                t = paged_targets(lens, S, bt, past_k.shape[0], past_k.shape[1])
                k_all = paged_kv_update_cat(past_k, heads_to_cat(k4), lens, bt, t)
                v_all = paged_kv_update_cat(past_v, heads_to_cat(v4), lens, bt, t)
                out = heads_to_cat(decode_mha(
                    q4, cat_to_heads(paged_gather_cat(k_all, bt), kv_heads).float(),
                    cat_to_heads(paged_gather_cat(v_all, bt), kv_heads).float(), lens,
                    scale=scale, window=window,
                ))
        else:
            t = paged_targets(lens, S, bt, past_k.shape[0], past_k.shape[2])
            k_all = paged_kv_update(past_k, k4, lens, bt, t)
            v_all = paged_kv_update(past_v, v4, lens, bt, t)
            out = heads_to_cat(paged_attention(q4, k_all, v_all, lens, bt, scale=scale,
                                               window=window))
    elif past_k.ndim == 3:  # cat caches [B, cap, Hkv*D]
        if kernel_append:
            out, k_all, v_all = decode_mha_append_cat(
                q4, past_k, past_v, lens, k_new=k4, v_new=v4, scale=scale, window=window,
            )
        else:
            k_all = slot_kv_update_cat(past_k, heads_to_cat(k4), lens)
            v_all = slot_kv_update_cat(past_v, heads_to_cat(v4), lens)
            out = heads_to_cat(prefill_mha_cat(q4, k_all, v_all, lens, scale=scale,
                                               window=window))
    elif kernel_append:
        out, k_all, v_all = decode_mha_append(q4, past_k, past_v, lens, k_new=k4, v_new=v4,
                                              scale=scale, window=window)
        out = heads_to_cat(out)
    else:
        k_all = slot_kv_update(past_k, k4, lens)
        v_all = slot_kv_update(past_v, v4, lens)
        out = heads_to_cat(decode_mha(q4, k_all, v_all, lens, scale=scale, window=window))
    if n_out >= 3:
        return (out, k_all, v_all)
    return out
