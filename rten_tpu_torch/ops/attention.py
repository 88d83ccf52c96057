"""QuantizedKVAttention on int8 cat-layout caches (the port of the two
cat-layout branches of ``rten_tpu/ops/attention.py``).

inputs: q, k, v [B,S,H*D] f32; past_k_q8 [B,cap,Hkv*D] s8;
        k_scales [B,Hkv,cap,1] f32; past_v_q8; v_scales; past_lens [B] i32
outputs: out [B,S,H*D], new_k_q8, new_k_scales, new_v_q8, new_v_scales

* S == 1 with ``rten_kernel_append``: ``decode_mha_append_cat`` quantizes
  the new row, appends it and attends (``attention.py:880-893``).
* otherwise: quantize the chunk's rows, write them at each slot's offset
  (``_slot_kv_update_cat`` / ``_slot_kv_update``), then
  ``prefill_mha_cat`` (``attention.py:903-932``).

The caches are updated in place and returned as the present outputs (the
executor copies them first unless the caller donated them).
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import (
    cat_to_heads, decode_mha_append_cat, heads_to_cat, prefill_mha_cat,
    quantize_rows,
)
from .registry import OpError, get_input, register


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


@register("QuantizedKVAttention", inplace=(3, 4, 5, 6))
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
    lws = int(attrs.get("local_window_size", -1))
    window = lws if lws > 0 else 0
    if int(attrs.get("bits", 8)) != 8:
        raise NotImplementedError("int4 KV caches: ROADMAP.md queue 1 item 11")
    if attrs.get("do_rotary", 0):
        raise NotImplementedError("rotary QuantizedKVAttention: ROADMAP.md queue 1 item 7")
    if attrs.get("rten_recent_kv", 0):
        raise NotImplementedError("deferred KV: ROADMAP.md queue 1 item 9")
    if attrs.get("rten_paged", 0):
        raise NotImplementedError("paged KV caches: ROADMAP.md queue 1 item 8")
    if past_k_q8.ndim != 3:
        raise NotImplementedError(
            "head-major [B,H,cap,D] int8 caches: ROADMAP.md queue 1 item 7"
        )
    if past_lens.dtype != torch.int32:
        raise OpError("past_lens must be int32")

    B, S, _ = q.shape
    lens = past_lens.reshape(B)
    # [B, S, H*D] -> [B, H, S, D] views
    q4 = cat_to_heads(q, n_heads)
    k4 = cat_to_heads(k, kv_heads)
    v4 = cat_to_heads(v, kv_heads)

    if S == 1 and attrs.get("rten_kernel_append", 0):
        # out arrives in cat layout [B, 1, H*D] == merged heads.
        out, nk, nv, nks, nvs = decode_mha_append_cat(
            q4, past_k_q8, past_v_q8, lens, k_scales, v_scales,
            k_new=k4, v_new=v4, scale=scale, window=window,
        )
        return (out, nk, nks, nv, nvs)

    k_q8, k_s = quantize_rows(k4)
    v_q8, v_s = quantize_rows(v4)
    new_kc = slot_kv_update_cat(past_k_q8, heads_to_cat(k_q8), lens)
    new_vc = slot_kv_update_cat(past_v_q8, heads_to_cat(v_q8), lens)
    new_k_s = slot_kv_update(k_scales, k_s, lens)
    new_v_s = slot_kv_update(v_scales, v_s, lens)
    out = prefill_mha_cat(
        q4, new_kc, new_vc, lens, new_k_s, new_v_s, scale=scale, window=window,
    )
    return (heads_to_cat(out), new_kc, new_k_s, new_vc, new_v_s)
