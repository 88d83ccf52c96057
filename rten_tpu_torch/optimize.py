"""Graph optimizer (the port of ``rten_tpu/optimize.py``, the passes the
serving graph needs).

Pipeline (``optimize_graph``, the order of the JAX package's): constant
propagation through the port's own ``Executor.partial_run`` on the CPU,
the int8 weight prepack, then dead-code and dead-constant elimination.
The pattern fusions and ``fold_shape_computations`` change nothing on the
serving graph; they wait for ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .ir.graph import Constant, Graph, NodeId, Operator


def propagate_constants(g: Graph) -> bool:
    """Fold every operator whose inputs are (transitively) constant.

    A partial evaluation with no runtime inputs on the CPU (rten
    optimize.rs:705-750 -> Graph::partial_run). Folded values become
    Constant nodes in place (same NodeId, so edges stay valid).
    """
    from .runtime.executor import Executor

    candidates = []
    for _, op in g.operators():
        if op.subgraphs():
            raise NotImplementedError(
                "control-flow subgraphs: ROADMAP.md queue 1 item 12"
            )
        candidates.extend(op.outputs)
    if not candidates:
        return False

    outs = Executor(g, device="cpu").partial_run({}, candidates)

    changed = False
    folded_values = set()
    for vid, val in outs:
        if val is None:
            continue
        node = g.nodes[vid]
        if isinstance(node, Constant):
            continue
        g.nodes[vid] = Constant(name=getattr(node, "name", None), array=val)
        folded_values.add(vid)
        changed = True

    # Remove operators whose outputs are now all constants.
    dead = [
        nid
        for nid, op in list(g.operators())
        if all(o in folded_values or isinstance(g.nodes[o], Constant) for o in op.outputs)
    ]
    g.remove_nodes(dead)
    return changed


def _producer_map(g: Graph) -> Dict[NodeId, Tuple[NodeId, Operator]]:
    m = {}
    for nid, op in g.operators():
        for out in op.outputs:
            m[out] = (nid, op)
    return m


def eliminate_dead_code(g: Graph) -> bool:
    """Remove operators (and private values) not reachable from outputs."""
    needed = set(g.output_ids)
    producers = _producer_map(g)
    stack = list(g.output_ids)
    live_ops = set()
    while stack:
        vid = stack.pop()
        prod = producers.get(vid)
        if prod is None:
            continue
        nid, op = prod
        if nid in live_ops:
            continue
        live_ops.add(nid)
        for i in op.inputs:
            if i is not None and i not in needed:
                needed.add(i)
                stack.append(i)
    dead_ops = [nid for nid, _ in g.operators() if nid not in live_ops]
    if not dead_ops:
        return False
    dead_values: List[NodeId] = []
    for nid in dead_ops:
        op = g.nodes[nid]
        for o in op.outputs:
            if o not in needed:
                dead_values.append(o)
    g.remove_nodes(dead_ops + dead_values)
    return True


def eliminate_dead_constants(g: Graph) -> bool:
    """Drop Constant nodes nothing consumes.

    Rewrite passes (quantize_dynamic, the int8 prepack) re-point operator
    inputs at new constants and leave the f32 originals orphaned; the
    executor would otherwise still move them to the device."""
    used = set(g.output_ids)
    for _, op in g.operators():
        used.update(i for i in op.inputs if i is not None)
    dead = [
        nid for nid, node in g.nodes.items()
        if isinstance(node, Constant) and nid not in used
    ]
    if not dead:
        return False
    g.remove_nodes(dead)
    return True


def prepack_int8_weights(g: Graph) -> bool:
    """Load-time prepack for MatMulIntegerToFloat weights (the WeightCache/
    prepack analog, rten src/weight_cache.rs + rten-gemm packing/int8.rs):

    * precompute the weight matrix's int32 column sums (needed for the
      activation-zero-point correction) as constant input 7, so the kernel
      never re-reads the weight to sum it;
    * pad N up to a multiple of 128 (2048 for N >= 8192, e.g. the GPT-2
      lm_head 50257 -> 51200), recording the logical width in the
      ``rten_orig_n`` attribute; the lowering slices the output back.
    """
    changed = False
    padded: Dict[NodeId, Tuple] = {}
    for _, op in list(g.operators()):
        if op.op_type != "MatMulIntegerToFloat":
            continue
        if len(op.inputs) >= 8 and op.inputs[7] is not None:
            continue  # already prepacked
        b_id = op.inputs[1]
        b_node = g.nodes.get(b_id)
        if not isinstance(b_node, Constant) or b_node.array.ndim != 2:
            continue
        if b_node.array.dtype not in (np.int8, np.uint8):
            continue
        zp_id = op.inputs[5] if len(op.inputs) > 5 else None
        zp_node = g.nodes.get(zp_id) if zp_id is not None else None
        zp_is_const = zp_id is None or isinstance(zp_node, Constant)
        # u8 weight with a runtime zero point: colsums of the raw u8 bytes
        # would be off by 128*K after the kernel's s8 shift — skip.
        if b_node.array.dtype == np.uint8 and not zp_is_const:
            continue
        entry = padded.get(b_id)
        if entry is None:
            b = b_node.array
            b_name = b_node.name or "w"
            K, N = b.shape
            align = 2048 if N >= 8192 else 128
            Np = -(-N // align) * align
            will_pad = Np != N
            # Padding N needs the per-column zero point padded alongside,
            # impossible for a runtime zero point.
            if will_pad and not zp_is_const:
                continue
            # u8 weights: fold the u8 -> s8 sign flip into the constant,
            # shifting the zero point (kernels/common.u8_to_s8_shift).
            nzp_id = None
            nzp_arr = None
            if b.dtype == np.uint8:
                zp_arr = (
                    zp_node.array if zp_node is not None else np.uint8(0)
                )
                b = (b ^ np.uint8(0x80)).view(np.int8)
                nzp_arr = np.asarray(zp_arr, np.int32) - 128
            elif will_pad and zp_node is not None and zp_node.array.ndim >= 1 \
                    and zp_node.array.size > 1:
                nzp_arr = np.asarray(zp_node.array, np.int32)
            orig_n = None
            if will_pad:
                bp = np.zeros((K, Np), b.dtype)
                bp[:, :N] = b
                b = bp
                orig_n = N
                if nzp_arr is not None and nzp_arr.ndim >= 1 and nzp_arr.size > 1:
                    zpad = np.zeros(Np, np.int32)
                    zpad[:N] = nzp_arr.reshape(-1)
                    nzp_arr = zpad
            if nzp_arr is not None:
                nzp_id = g.add_constant(b_name + ".zp_s8", nzp_arr)
            if orig_n is not None or b is not b_node.array:
                bp_id = g.add_constant(b_name + ".prepack", b)
            else:
                bp_id = b_id
            colsums = b.astype(np.int32).sum(axis=0)[None, :]  # [1, Np]
            cs_id = g.add_constant(b_name + ".colsums", colsums)
            entry = (bp_id, cs_id, orig_n, nzp_id)
            padded[b_id] = entry
        bp_id, cs_id, orig_n, nzp_id = entry
        ins = list(op.inputs) + [None] * (8 - len(op.inputs))
        ins[1] = bp_id
        ins[7] = cs_id
        if nzp_id is not None:
            ins[5] = nzp_id
        if orig_n is not None:
            # Pad per-col scales to match (scale=1 on pad cols).
            ws_id = ins[3]
            ws_node = g.nodes.get(ws_id)
            if isinstance(ws_node, Constant) and ws_node.array.ndim == 1:
                ws = np.ones(
                    g.nodes[bp_id].array.shape[1], ws_node.array.dtype
                )
                ws[: orig_n] = ws_node.array
                ins[3] = g.add_constant(
                    (ws_node.name or "scales") + ".pad", ws
                )
            op.attrs = {**op.attrs, "rten_orig_n": orig_n}
        op.inputs = ins
        changed = True
    if changed:
        eliminate_dead_code(g)
    return changed


def optimize_graph(g: Graph, constant_prop: bool = True) -> Graph:
    """The pipeline (rten optimize.rs:502-661) as far as the serving graph
    needs it, in the JAX package's order."""
    if constant_prop:
        propagate_constants(g)
    prepack_int8_weights(g)
    eliminate_dead_code(g)
    eliminate_dead_constants(g)
    return g
