"""Quantization passes over the IR (the port of ``rten_tpu/quantize_pass.py``):
dynamic int8 and weight-only int4.

Rewrites every MatMul/MatMulAdd/Gemm(activation, constant_weight) into

    DynamicQuantizeLinear(act) -> u8 act + per-tensor scale/zp   (runtime)
    weight -> s8 per-column symmetric (offline, zp = 0)
    MatMulIntegerToFloat(act_q, w_q, act_scale, w_scales) [+ bias]

which the executor lowers onto the int8 kernel
(``rten_tpu_torch/kernels/int8_matmul.py``); ``quantize_weight_only_int4``
rewrites the same matmuls into MatMulNBits (+ a bias Add) on the int4
kernel (``rten_tpu_torch/kernels/int4_matmul.py``). Convolutions become
DynamicQuantizeLinear + ConvIntegerToFloat (s8 per-output-channel
weights) only where ``RTEN_QUANT_CONV`` asks for it (``_maybe_quantize_conv``:
the JAX package's switch and its default, ``none``). numpy only: the
rewritten graphs, packed bytes included, are identical to the ones the JAX
package's passes produce.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .ir.graph import Constant, Graph, Operator


def quantize_weight_per_col(w: np.ndarray):
    """f32 [K, N] -> (s8 [K, N], f32 scales [N]). Symmetric, zp=0."""
    absmax = np.max(np.abs(w), axis=0)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scales[None, :]), -127, 127).astype(np.int8)
    return q, scales


def quantize_conv_weight(w: np.ndarray):
    """f32 [O, C, *k] -> (s8 same shape, f32 scales [O]). Symmetric."""
    absmax = np.max(np.abs(w.reshape(w.shape[0], -1)), axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    shape = (-1,) + (1,) * (w.ndim - 1)
    q = np.clip(np.round(w / scales.reshape(shape)), -127, 127).astype(np.int8)
    return q, scales


def _constant_weight(g: Graph, op, min_elements: int, skip_names: set):
    """(weight node, f32 [K, N] weight, trans_b) of a MatMul, MatMulAdd or
    plain Gemm (transB allowed) whose weight is a 2-D f32 constant of at
    least ``min_elements`` and whose name is not skipped; else None. A
    Gemm(transB=1) weight (torch Linear's export) comes back transposed, so
    the transpose folds into the offline quantization."""
    if op.op_type not in ("MatMul", "MatMulAdd", "Gemm") or op.name in skip_names:
        return None
    trans_b = False
    if op.op_type == "Gemm":
        if (
            op.attrs.get("transA")
            or op.attrs.get("alpha", 1.0) != 1.0
            or op.attrs.get("beta", 1.0) != 1.0
        ):
            return None
        trans_b = bool(op.attrs.get("transB", 0))
    if len(op.inputs) < 2 or op.inputs[1] is None:
        return None
    w_node = g.nodes.get(op.inputs[1])
    if not isinstance(w_node, Constant):
        return None
    w = w_node.array
    if w.ndim != 2 or w.dtype != np.float32 or w.size < min_elements:
        return None
    return w_node, (np.ascontiguousarray(w.T) if trans_b else w), trans_b


def quantize_dynamic(
    g: Graph,
    min_elements: int = 32 * 32,
    skip_names: Optional[set] = None,
    quantize_conv: bool = True,
) -> Graph:
    """Rewrite eligible float matmuls (and convs) to the quantized form,
    in place.

    ``min_elements`` skips tiny weights where quantization overhead wins.
    A Conv is rewritten only where ``quantize_conv`` and ``RTEN_QUANT_CONV``
    allow (``_maybe_quantize_conv``).
    """
    skip_names = skip_names or set()
    # Cache: one quantized copy per weight constant, shared by consumers.
    quantized: Dict[tuple, tuple] = {}

    for nid, op in list(g.operators()):
        if quantize_conv and op.op_type == "Conv":
            _maybe_quantize_conv(g, nid, op, min_elements, skip_names)
            continue
        found = _constant_weight(g, op, min_elements, skip_names)
        if found is None:
            continue
        w_node, w, trans_b = found
        act_id = op.inputs[0]
        bias_id = op.inputs[2] if len(op.inputs) > 2 else None

        entry = quantized.get((op.inputs[1], trans_b))
        if entry is None:
            q, scales = quantize_weight_per_col(w)
            wq_id = g.add_constant((w_node.name or "w") + ".q8", q)
            ws_id = g.add_constant((w_node.name or "w") + ".scales", scales)
            entry = (wq_id, ws_id)
            quantized[(op.inputs[1], trans_b)] = entry
        wq_id, ws_id = entry

        # DynamicQuantizeLinear: act -> (u8, scale, zp)
        aq_id = g.add_value(f"{g.node_name(nid)}.act_q")
        as_id = g.add_value(f"{g.node_name(nid)}.act_scale")
        azp_id = g.add_value(f"{g.node_name(nid)}.act_zp")
        g.add_op(
            "DynamicQuantizeLinear", [act_id], [aq_id, as_id, azp_id],
            name=f"{op.name or g.node_name(nid)}.dql",
        )
        # Replace the op in place: same outputs, new inputs.
        op.op_type = "MatMulIntegerToFloat"
        op.inputs = [aq_id, wq_id, as_id, ws_id, azp_id, None, bias_id]
        op.attrs = {}
    return g


def pack_int4_weight(w: np.ndarray, block_size: int = 32):
    """f32 [K, N] -> MatMulNBits operands: packed nibbles [N, nb, bs/2],
    scales [N, nb] (unsigned 4-bit, zero point 8 — the ort-quantize nbits
    layout, rten block_quant.rs)."""
    K, N = w.shape
    nb = -(-K // block_size)
    wt = np.zeros((N, nb * block_size), np.float32)
    wt[:, :K] = np.ascontiguousarray(w.T)
    blocks = wt.reshape(N, nb, block_size)
    absmax = np.abs(blocks).max(axis=2)
    scales = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, :, None]) + 8, 0, 15).astype(np.uint8)
    lo = q[:, :, 0::2]
    hi = q[:, :, 1::2]
    packed = (lo | (hi << 4)).astype(np.uint8)  # [N, nb, bs/2]
    return packed, scales


def quantize_weight_only_int4(
    g: Graph,
    block_size: int = 32,
    min_elements: int = 64 * 64,
    skip_names: Optional[set] = None,
) -> Graph:
    """Weight-only int4, in place: MatMul/MatMulAdd/Gemm(transB ok) with
    constant weights become MatMulNBits (+ a separate bias Add).
    Activations stay f32 — the memory-bound-decode trade (8x fewer weight
    bytes than f32), rten's MatMulNBits path (docs/quantization.md nbits
    mode)."""
    skip_names = skip_names or set()
    cache: Dict[tuple, tuple] = {}
    for nid, op in list(g.operators()):
        found = _constant_weight(g, op, min_elements, skip_names)
        if found is None:
            continue
        w_node, w, trans_b = found
        K, N = w.shape
        entry = cache.get((op.inputs[1], trans_b))
        if entry is None:
            packed, scales = pack_int4_weight(w, block_size)
            pk_id = g.add_constant((w_node.name or "w") + ".q4", packed)
            sc_id = g.add_constant((w_node.name or "w") + ".q4scales", scales)
            entry = (pk_id, sc_id)
            cache[(op.inputs[1], trans_b)] = entry
        pk_id, sc_id = entry
        act_id = op.inputs[0]
        bias_id = op.inputs[2] if len(op.inputs) > 2 else None
        attrs = {"K": K, "N": N, "bits": 4, "block_size": block_size}
        if bias_id is not None:
            mm_out = g.add_value(f"{g.node_name(nid)}.q4_out")
            g.add_op("MatMulNBits", [act_id, pk_id, sc_id], [mm_out], attrs, name=op.name)
            op.op_type = "Add"
            op.inputs = [mm_out, bias_id]
            op.attrs = {}
        else:
            op.op_type = "MatMulNBits"
            op.inputs = [act_id, pk_id, sc_id]
            op.attrs = attrs
    return g


def _maybe_quantize_conv(g: Graph, nid, op: Operator, min_elements, skip_names):
    """Conv(x, const_w [O, C, *k], bias?) -> DynamicQuantizeLinear +
    ConvIntegerToFloat: u8 dynamic activations x s8 per-output-channel
    symmetric weights (rten src/ops/conv.rs:479, fused :552).

    ``RTEN_QUANT_CONV`` picks the convs, as in the JAX package: ``none``
    (the default: every conv stays f32), ``1x1`` (1x1 convs of stride 1)
    or ``all``; in both, only convs of group 1 with C·k >= 128 and O >= 64
    and at least ``min_elements`` weights."""
    if op.name in skip_names or op.attrs.get("group", 1) != 1:
        return
    if len(op.inputs) < 2 or op.inputs[1] is None:
        return
    w_node = g.nodes.get(op.inputs[1])
    if not isinstance(w_node, Constant):
        return
    w = w_node.array
    if w.dtype != np.float32 or w.size < min_elements:
        return
    mode = os.environ.get("RTEN_QUANT_CONV", "none")
    if mode not in ("1x1", "all"):
        return
    O = w.shape[0]
    K = int(np.prod(w.shape[1:]))
    if K < 128 or O < 64:
        return
    spatial = int(np.prod(w.shape[2:])) > 1
    if mode != "all" and (
        spatial
        or any(int(s) != 1 for s in op.attrs.get("strides", [1]))
    ):
        return
    q, scales = quantize_conv_weight(w)
    wq_id = g.add_constant((w_node.name or "w") + ".q8", q)
    ws_id = g.add_constant((w_node.name or "w") + ".scales", scales)
    act_id = op.inputs[0]
    bias_id = op.inputs[2] if len(op.inputs) > 2 else None
    aq_id = g.add_value(f"{g.node_name(nid)}.act_q")
    as_id = g.add_value(f"{g.node_name(nid)}.act_scale")
    azp_id = g.add_value(f"{g.node_name(nid)}.act_zp")
    g.add_op(
        "DynamicQuantizeLinear", [act_id], [aq_id, as_id, azp_id],
        name=f"{op.name or g.node_name(nid)}.dql",
    )
    op.op_type = "ConvIntegerToFloat"
    op.inputs = [aq_id, wq_id, as_id, ws_id, azp_id, None, bias_id]
    # attrs (strides, pads, dilations, group) carry over unchanged.
