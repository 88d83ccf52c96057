"""Dynamic int8 quantization pass over the IR (the port of
``rten_tpu/quantize_pass.py``, matmul part).

Rewrites every MatMul/MatMulAdd/Gemm(activation, constant_weight) into

    DynamicQuantizeLinear(act) -> u8 act + per-tensor scale/zp   (runtime)
    weight -> s8 per-column symmetric (offline, zp = 0)
    MatMulIntegerToFloat(act_q, w_q, act_scale, w_scales) [+ bias]

which the executor lowers onto the int8 kernel
(``rten_tpu_torch/kernels/int8_matmul.py``). numpy only: the rewritten
graph is identical to the one the JAX package's pass produces.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .ir.graph import Constant, Graph


def quantize_weight_per_col(w: np.ndarray):
    """f32 [K, N] -> (s8 [K, N], f32 scales [N]). Symmetric, zp=0."""
    absmax = np.max(np.abs(w), axis=0)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scales[None, :]), -127, 127).astype(np.int8)
    return q, scales


def quantize_dynamic(
    g: Graph,
    min_elements: int = 32 * 32,
    skip_names: Optional[set] = None,
) -> Graph:
    """Rewrite eligible float matmuls to the quantized form, in place.

    ``min_elements`` skips tiny weights where quantization overhead wins.
    Convolutions are left as they are (ROADMAP.md queue 1 item 12).
    """
    skip_names = skip_names or set()
    # Cache: one quantized copy per weight constant, shared by consumers.
    quantized: Dict[tuple, tuple] = {}

    for nid, op in list(g.operators()):
        if op.op_type not in ("MatMul", "MatMulAdd", "Gemm"):
            continue
        if op.name in skip_names:
            continue
        trans_b = False
        if op.op_type == "Gemm":
            if (
                op.attrs.get("transA")
                or op.attrs.get("alpha", 1.0) != 1.0
                or op.attrs.get("beta", 1.0) != 1.0
            ):
                continue
            trans_b = bool(op.attrs.get("transB", 0))
        if len(op.inputs) < 2 or op.inputs[1] is None:
            continue
        w_node = g.nodes.get(op.inputs[1])
        if not isinstance(w_node, Constant):
            continue
        w = w_node.array
        if w.ndim != 2 or w.dtype != np.float32 or w.size < min_elements:
            continue
        if trans_b:
            # torch Linear exports Gemm(transB=1): fold the transpose into
            # the offline weight quantization.
            w = np.ascontiguousarray(w.T)
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
