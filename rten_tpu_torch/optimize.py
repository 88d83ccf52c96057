"""Graph optimizer: constant propagation and the fusion pipeline (the port
of ``rten_tpu/optimize.py``; rten GraphOptimizer, src/optimize.rs:502-661).

``optimize_graph`` runs the JAX package's pipeline in its order: fold the
shape computations that symbolic shape inference makes concrete,
propagate constants (through the port's own executor on the CPU),
optimize each subgraph after promoting the constants it captures, loop
over ``FUSIONS`` (identity and cast elimination, LayerNorm, RMSNorm, Gelu,
Silu/Swish, the quantized MatMul and Conv chains, attention) to a fixpoint
of at most three rounds, then prepack the int8 weights and remove dead
code and dead constants. Every pass is a graph rewrite in numpy; the
graphs it gives are those the JAX package gives, node for node.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .ir.graph import Constant, Graph, NodeId, Operator, Value

# Ops whose results must not be folded even when inputs are constant
# (rten Operator::is_deterministic, src/operator.rs:560).
NON_DETERMINISTIC = {
    "RandomNormal",
    "RandomNormalLike",
    "RandomUniform",
    "RandomUniformLike",
    "Multinomial",
}

_DEBUG = os.environ.get("RTEN_OPTIMIZER_DEBUG", "") not in ("", "0")


def _log(msg: str):
    if _DEBUG:
        print(f"[optimizer] {msg}")


# --- constant propagation --------------------------------------------------


def propagate_constants(g: Graph) -> bool:
    """Fold every operator whose inputs are (transitively) constant.

    A partial evaluation with no runtime inputs through the port's own
    ``Executor.partial_run`` on the CPU (rten optimize.rs:705-750 ->
    Graph::partial_run). Folded values become Constant nodes in place (same
    NodeId, so edges stay valid). Ops with subgraphs are left alone, as in
    the JAX package; so are the ops the port does not register yet, and
    everything downstream of them, which keeps such a graph loadable.
    """
    from .ops.registry import REGISTRY
    from .runtime.executor import Executor

    # Values transitively downstream of a non-deterministic (or unported)
    # op must not be folded either: folding would freeze one random sample
    # forever (rten excludes them via Operator::is_deterministic on the
    # whole chain).
    tainted: set = set()
    while True:  # fixpoint: node order is not guaranteed topological
        n_before = len(tainted)
        for nid, op in g.operators():
            if op.op_type in NON_DETERMINISTIC or op.op_type not in REGISTRY or any(
                i in tainted for i in op.inputs if i is not None
            ):
                tainted.update(op.outputs)
        if len(tainted) == n_before:
            break

    candidates = []
    for nid, op in g.operators():
        if op.subgraphs():
            continue
        candidates.extend(o for o in op.outputs if o not in tainted)
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
    if dead:
        _log(f"constant-folded {len(dead)} operators")
    g.remove_nodes(dead)
    return changed


# --- fusion helpers --------------------------------------------------------


def _producer_map(g: Graph) -> Dict[NodeId, Tuple[NodeId, Operator]]:
    m = {}
    for nid, op in g.operators():
        for out in op.outputs:
            m[out] = (nid, op)
    return m


def _consumer_count(g: Graph) -> Dict[NodeId, int]:
    c: Dict[NodeId, int] = {}
    for _, op in g.operators():
        for i in op.inputs:
            if i is not None:
                c[i] = c.get(i, 0) + 1
    for o in g.output_ids:
        c[o] = c.get(o, 0) + 1
    return c


def _const_scalar(g: Graph, nid: Optional[NodeId]):
    if nid is None:
        return None
    node = g.nodes.get(nid)
    if isinstance(node, Constant) and node.array.size == 1:
        return node.array.reshape(())
    return None


# --- individual fusions ----------------------------------------------------


def fuse_identity(g: Graph) -> bool:
    """Remove Identity / inference-mode Dropout (rten IdentityFusion)."""
    changed = False
    for nid, op in list(g.operators()):
        if op.op_type == "Identity" or (
            op.op_type == "Dropout" and len(op.outputs) == 1
        ):
            src = op.inputs[0]
            if src is None:
                continue
            out = op.outputs[0]
            # Preserve graph-output names: if the Identity's output is itself
            # a named graph output, keep the op so the name is still produced
            # (replace_input would rewrite output_ids and lose the name —
            # same ordering as fuse_cast_elimination).
            if out in g.output_ids:
                continue
            g.replace_input(out, src)
            g.remove_nodes([nid, out])
            changed = True
    return changed


def fuse_cast_elimination(g: Graph) -> bool:
    """Drop casts to the value's existing dtype (rten CastElimination)."""
    changed = False
    for nid, op in list(g.operators()):
        if op.op_type != "Cast":
            continue
        src = op.inputs[0]
        src_node = g.nodes.get(src)
        to = op.attrs.get("to")
        src_dtype = None
        if isinstance(src_node, Constant):
            from .dtypes import DataType

            try:
                src_dtype = DataType.from_np(src_node.array.dtype)
            except ValueError:
                pass
        elif isinstance(src_node, Value):
            src_dtype = src_node.dtype
        if src_dtype is not None and src_dtype == to:
            out = op.outputs[0]
            if out in g.output_ids:
                continue
            g.replace_input(out, src)
            g.remove_nodes([nid, out])
            changed = True
    return changed


def fuse_matmul_integer_to_float(g: Graph) -> bool:
    """MatMulInteger -> Cast(f32) -> Mul(a_scale*b_scale) [+ Add(bias)]
    becomes MatMulIntegerToFloat, which runs the int8 kernel
    (rten src/optimize/fusions.rs:966 analog).

    The scale multiplier may itself be a Mul of the two scales (dynamic
    quant) or a single constant; both forms are accepted as one input.
    """
    producers = _producer_map(g)
    consumers = _consumer_count(g)
    changed = False
    for cast_id, cast_op in list(g.operators()):
        if cast_op.op_type != "Cast":
            continue
        from .dtypes import DataType

        if cast_op.attrs.get("to") != DataType.Float:
            continue
        prod = producers.get(cast_op.inputs[0])
        if prod is None or prod[1].op_type != "MatMulInteger":
            continue
        mm_id, mm_op = prod
        if consumers.get(mm_op.outputs[0], 0) != 1:
            continue
        cast_out = cast_op.outputs[0]
        if consumers.get(cast_out, 0) != 1 or cast_out in g.output_ids:
            continue
        # Find the Mul consuming the cast output.
        mul = None
        for mnid, mop in g.operators():
            if mop.op_type == "Mul" and cast_out in mop.inputs:
                mul = (mnid, mop)
                break
        if mul is None:
            continue
        mul_id, mul_op = mul
        scale_id = next(i for i in mul_op.inputs if i != cast_out)

        a, b = mm_op.inputs[0], mm_op.inputs[1]
        a_zp = mm_op.inputs[2] if len(mm_op.inputs) > 2 else None
        b_zp = mm_op.inputs[3] if len(mm_op.inputs) > 3 else None

        # Express combined scale as a_scale=scale, b_scale=1.
        one = g.add_constant(None, np.float32(1.0))
        new_out = mul_op.outputs[0]
        g.remove_nodes([mm_id, cast_id, mul_id, mm_op.outputs[0], cast_out])
        g.add_op(
            "MatMulIntegerToFloat",
            [a, b, scale_id, one, a_zp, b_zp],
            [new_out],
            name=mm_op.name,
        )
        _log(f"fused MatMulIntegerToFloat at {mm_op.name}")
        changed = True
        producers = _producer_map(g)
        consumers = _consumer_count(g)
    return changed


def fuse_conv_integer_to_float(g: Graph) -> bool:
    """ConvInteger -> Cast(f32) -> Mul(scale) => ConvIntegerToFloat."""
    producers = _producer_map(g)
    consumers = _consumer_count(g)
    changed = False
    for cast_id, cast_op in list(g.operators()):
        if cast_op.op_type != "Cast":
            continue
        from .dtypes import DataType

        if cast_op.attrs.get("to") != DataType.Float:
            continue
        prod = producers.get(cast_op.inputs[0])
        if prod is None or prod[1].op_type != "ConvInteger":
            continue
        conv_id, conv_op = prod
        if consumers.get(conv_op.outputs[0], 0) != 1:
            continue
        cast_out = cast_op.outputs[0]
        if consumers.get(cast_out, 0) != 1 or cast_out in g.output_ids:
            continue
        mul = None
        for mnid, mop in g.operators():
            if mop.op_type == "Mul" and cast_out in mop.inputs:
                mul = (mnid, mop)
                break
        if mul is None:
            continue
        mul_id, mul_op = mul
        scale_id = next(i for i in mul_op.inputs if i != cast_out)
        # Per-channel scale constants arrive shaped [1, C, 1, 1] or [C];
        # the lowering handles both.
        x, w = conv_op.inputs[0], conv_op.inputs[1]
        x_zp = conv_op.inputs[2] if len(conv_op.inputs) > 2 else None
        w_zp = conv_op.inputs[3] if len(conv_op.inputs) > 3 else None
        one = g.add_constant(None, np.float32(1.0))
        new_out = mul_op.outputs[0]
        g.remove_nodes([conv_id, cast_id, mul_id, conv_op.outputs[0], cast_out])
        g.add_op(
            "ConvIntegerToFloat",
            [x, w, scale_id, one, x_zp, w_zp],
            [new_out],
            conv_op.attrs,
            name=conv_op.name,
        )
        _log(f"fused ConvIntegerToFloat at {conv_op.name}")
        changed = True
        producers = _producer_map(g)
        consumers = _consumer_count(g)
    return changed


def fuse_attention(g: Graph) -> bool:
    """Decomposed attention -> fused Attention op (the mha kernel).

    Matches the shape real exporters emit (torch sdpa/BERT-style):

        MatMul(q, Transpose(k, [..., -1, -2]))
          -> Div(c) | Mul(c)            (optional)
          -> Add(mask)                  (optional)
          -> Softmax(axis=-1)
          -> MatMul(., v)

    The reference does the same family of rewrites (AddSoftmax /
    Attention-related fusions, src/optimize/fusions.rs); here the payoff is
    routing onto the blockwise flash-attention kernel instead of
    materializing the score matrix.
    """
    producers = _producer_map(g)
    consumers = _consumer_count(g)
    changed = False

    def single(prod_out):
        return consumers.get(prod_out, 0) == 1 and prod_out not in g.output_ids

    for sm_id, sm in list(g.operators()):
        if sm.op_type != "Softmax" or sm.attrs.get("axis", -1) not in (-1, 3):
            continue
        # Downstream: the only consumer is MatMul(probs, v).
        sm_out = sm.outputs[0]
        if consumers.get(sm_out, 0) != 1 or sm_out in g.output_ids:
            continue
        mm2 = next(
            ((nid, op) for nid, op in g.operators()
             if op.op_type == "MatMul" and op.inputs[0] == sm_out),
            None,
        )
        if mm2 is None:
            continue
        mm2_id, mm2_op = mm2
        v_id = mm2_op.inputs[1]

        # Upstream chain: optional Add(mask) | Where(cond, fill, .),
        # optional Div/Mul(scale), then MatMul(q, kT).
        cur = sm.inputs[0]
        mask_add_id = None   # additive mask value id
        where_mask = None    # (cond_id, fill_id) to synthesize one
        scale = None
        chain = [sm_id]
        for _ in range(2):
            prod = producers.get(cur)
            if prod is None:
                break
            pid, pop = prod
            if (
                pop.op_type == "Add" and mask_add_id is None
                and where_mask is None and single(cur)
            ):
                lhs, rhs = pop.inputs[0], pop.inputs[1]
                lhs_prod = producers.get(lhs)
                if lhs_prod and lhs_prod[1].op_type in ("MatMul", "Div", "Mul"):
                    cur, mask_add_id = lhs, rhs
                else:
                    cur, mask_add_id = rhs, lhs
                chain.append(pid)
            elif (
                pop.op_type == "Where" and mask_add_id is None
                and where_mask is None and single(cur)
            ):
                # Where(cond, fill, scores): blocked positions take `fill`.
                cond_id, fill_id, src = pop.inputs[0], pop.inputs[1], pop.inputs[2]
                if _const_scalar(g, fill_id) is None:
                    break
                where_mask = (cond_id, fill_id)
                cur = src
                chain.append(pid)
            elif pop.op_type in ("Div", "Mul") and scale is None and single(cur):
                c = _const_scalar(g, pop.inputs[1])
                if c is None:
                    break
                scale = (1.0 / float(c)) if pop.op_type == "Div" else float(c)
                cur = pop.inputs[0]
                chain.append(pid)
            else:
                break
        prod = producers.get(cur)
        if prod is None or prod[1].op_type != "MatMul" or not single(cur):
            continue
        mm1_id, mm1_op = prod
        q_id, kt_id = mm1_op.inputs[0], mm1_op.inputs[1]
        chain.append(mm1_id)

        out_id = mm2_op.outputs[0]
        # Remove the matched ops (+ their intermediate values).
        dead_vals = {sm_out, cur}
        for nid in chain:
            node = g.nodes.get(nid)
            if isinstance(node, Operator):
                for o in node.outputs:
                    if o != out_id:
                        dead_vals.add(o)
        g.remove_nodes(set(chain + [mm2_id]) | dead_vals)

        # K arrives pre-transposed for the score matmul; restore [B,H,T,D]
        # (a view: the transpose is never copied).
        k_id = g.add_value(None)
        g.add_op("Transpose", [kt_id], [k_id], {"perm": [0, 1, 3, 2]})
        if where_mask is not None:
            cond_id, fill_id = where_mask
            zero = g.add_constant(None, np.float32(0.0))
            mask_add_id = g.add_value(None)
            g.add_op("Where", [cond_id, fill_id, zero], [mask_add_id])
        attrs = {"scale": scale if scale is not None else 1.0}
        g.add_op(
            "Attention", [q_id, k_id, v_id, mask_add_id], [out_id], attrs,
            name=mm2_op.name or "fused_attention",
        )
        _log("fused decomposed attention")
        changed = True
        producers = _producer_map(g)
        consumers = _consumer_count(g)
    return changed


def _capture_dep_ids(g: Graph, op: Operator) -> List[NodeId]:
    """Outer-graph values an op's subgraphs capture by name (transitively).
    Mirrors Graph.plan's capture_deps: these are real data dependencies even
    though they never appear in op.inputs."""
    names: List[str] = []

    def walk(sub: Graph):
        names.extend(sub.captures)
        for _, sub_op in sub.operators():
            for sg in sub_op.subgraphs():
                walk(sg)

    for sg in op.subgraphs():
        walk(sg)
    deps = []
    for name in names:
        nid = g.find_node(name)
        if nid is not None:
            deps.append(nid)
    return deps


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
        deps = list(op.inputs)
        if op.subgraphs():
            deps += _capture_dep_ids(g, op)
        for i in deps:
            if i is not None and i not in needed:
                needed.add(i)
                stack.append(i)
    dead_ops = [nid for nid, _ in g.operators() if nid not in live_ops]
    if not dead_ops:
        return False
    dead_values = []
    for nid in dead_ops:
        op = g.nodes[nid]
        assert isinstance(op, Operator)
        for o in op.outputs:
            if o not in needed:
                dead_values.append(o)
    g.remove_nodes(dead_ops + dead_values)
    _log(f"removed {len(dead_ops)} dead operators")
    return True


def eliminate_dead_constants(g: Graph) -> bool:
    """Drop Constant nodes nothing consumes.

    Rewrite passes (int8 prepack, quantize_dynamic, fusions) re-point
    operator inputs at new constants and leave the originals orphaned —
    for a quantized GPT-2 that is ~600MB of f32 weights the executor
    would otherwise still move to the card (Executor._weight_args moves
    every weight constant in the graph)."""
    from .ir.graph import Constant

    used = set(g.output_ids)
    for _, op in g.operators():
        used.update(i for i in op.inputs if i is not None)
        for dep in _capture_dep_ids(g, op):
            used.add(dep)
    dead = [
        nid for nid, node in g.nodes.items()
        if isinstance(node, Constant) and nid not in used
    ]
    if not dead:
        return False
    g.remove_nodes(dead)
    _log(f"removed {len(dead)} dead constants")
    return True


def fuse_rms_norm(g: Graph) -> bool:
    """Decomposed RMSNorm -> RMSNormalization (rten RMSNormalization fusion,
    src/optimize/fusions.rs).

    torch exports `w * (x * rsqrt(mean(x^2) + eps))` as
    Pow(x,2) -> ReduceMean -> Add(eps) -> Sqrt -> [Div(x,s) | Div(1,s)+Mul]
    -> Mul(w). Recognizing it matters beyond op count: derive_tp_plan's
    Megatron pairing uses normalization ops as all-reduce boundaries, so an
    unrecognized norm would let the pairing leak across it on ONNX-loaded
    llama-family graphs.
    """
    producers = _producer_map(g)
    consumers = _consumer_count(g)
    changed = False

    def producer_op(vid, op_type):
        p = producers.get(vid)
        if p is not None and p[1].op_type == op_type:
            return p
        return None

    for sqrt_id, sqrt_op in list(g.operators()):
        if sqrt_op.op_type != "Sqrt":
            continue
        add = producer_op(sqrt_op.inputs[0], "Add")
        if add is None:
            continue
        add_id, add_op = add
        eps = None
        rm = None
        for a, b in (add_op.inputs[:2], add_op.inputs[:2][::-1]):
            e = _const_scalar(g, b)
            r = producer_op(a, "ReduceMean")
            if e is not None and r is not None:
                eps, rm = float(e), r
                break
        if rm is None:
            continue
        rm_id, rm_op = rm
        axes = rm_op.attrs.get("axes")
        if axes is None and len(rm_op.inputs) > 1:
            node = g.nodes.get(rm_op.inputs[1])
            if isinstance(node, Constant):
                axes = node.array.reshape(-1).tolist()
        if axes is not None and list(axes) not in ([-1],):
            # last-axis only (rank unknown here; -1 is what torch emits)
            continue
        pw = producer_op(rm_op.inputs[0], "Pow")
        if pw is None:
            continue
        pw_id, pw_op = pw
        two = _const_scalar(g, pw_op.inputs[1])
        if two is None or float(two) != 2.0:
            continue
        x_id = pw_op.inputs[0]

        # Normalization value: Div(x, sqrt) or Mul(x, Div(1, sqrt)).
        sqrt_out = sqrt_op.outputs[0]
        norm_id = None
        chain_ids = [pw_id, rm_id, add_id, sqrt_id]
        chain_vals = [pw_op.outputs[0], rm_op.outputs[0], add_op.outputs[0], sqrt_out]
        for div_id, div_op in list(g.operators()):
            if div_op.op_type != "Div" or div_op.inputs[1] != sqrt_out:
                continue
            if div_op.inputs[0] == x_id:
                norm_id = div_op.outputs[0]
                chain_ids.append(div_id)
                chain_vals.append(norm_id)
            else:
                one = _const_scalar(g, div_op.inputs[0])
                if one is None or float(one) != 1.0:
                    continue
                recip = div_op.outputs[0]
                for mul_id, mul_op in list(g.operators()):
                    if mul_op.op_type == "Mul" and recip in mul_op.inputs:
                        other = next(i for i in mul_op.inputs if i != recip)
                        if other == x_id:
                            norm_id = mul_op.outputs[0]
                            chain_ids.extend([div_id, mul_id])
                            chain_vals.extend([recip, norm_id])
                            break
            break
        if norm_id is None:
            continue
        # Outer weight multiply.
        out_mul = None
        for mul_id, mul_op in list(g.operators()):
            if mul_op.op_type != "Mul" or norm_id not in mul_op.inputs:
                continue
            w_id = next(i for i in mul_op.inputs if i != norm_id)
            w_node = g.nodes.get(w_id)
            if isinstance(w_node, Constant) and w_node.array.ndim == 1:
                out_mul = (mul_id, mul_op, w_id)
                break
        if out_mul is None:
            continue
        mul_id, mul_op, w_id = out_mul
        # All chain values single-consumer and not graph outputs.
        if any(v in g.output_ids for v in chain_vals):
            continue
        if any(consumers.get(v, 0) != 1 for v in chain_vals):
            continue
        final_out = mul_op.outputs[0]
        g.remove_nodes(chain_ids + [mul_id] + chain_vals)
        g.add_op(
            "RMSNormalization", [x_id, w_id], [final_out],
            {"epsilon": eps, "axis": -1},
        )
        _log("fused decomposed RMSNorm")
        changed = True
        producers = _producer_map(g)
        consumers = _consumer_count(g)
    return changed


# --- expression-pattern fusion engine ---------------------------------------
#
# Declarative analog of the reference's Pattern/PatternFusion machinery
# (rten src/optimize/pattern_matcher.rs + fusions.rs): patterns are small
# expression trees matched backwards through the producer map, with
# commutative binary ops tried in both argument orders and symbol/constant
# captures required to bind consistently. Used for the fusions whose shapes
# are genuine expressions (LayerNorm, Gelu variants, Silu/Swish) — the
# quantization rewrites keep their bespoke matchers above.


class _Pat:
    __slots__ = ("kind", "op_type", "args", "name", "value", "alts")

    def __init__(self, kind, op_type=None, args=(), name=None, value=None,
                 alts=()):
        self.kind = kind          # "sym" | "cst" | "op" | "any"
        self.op_type = op_type
        self.args = args
        self.name = name
        self.value = value        # required scalar value for "cst"
        self.alts = alts


def p_sym(name: str) -> _Pat:
    return _Pat("sym", name=name)


def p_cst(value: Optional[float] = None, name: Optional[str] = None) -> _Pat:
    """A Constant node; if ``value`` is given it must be a scalar equal to
    it (within fp32 tolerance), like Pattern::exact_constant."""
    return _Pat("cst", name=name, value=value)


def p_op(op_type: str, *args: _Pat, name: Optional[str] = None) -> _Pat:
    return _Pat("op", op_type=op_type, args=args, name=name)


def p_any(*alts: _Pat) -> _Pat:
    return _Pat("any", alts=alts)


_COMMUTATIVE = {"Add", "Mul"}


def _match_pattern(g: Graph, producers, pat: _Pat, vid, state):
    """Returns (binds, matched_ops) or None. ``binds`` maps
    ("s"|"c"|"o", name) -> node id; ``matched_ops`` is a tuple of matched
    operator node ids (pattern-interior; the caller owns safety checks)."""
    if pat.kind == "any":
        for alt in pat.alts:
            m = _match_pattern(g, producers, alt, vid, state)
            if m is not None:
                return m
        return None
    if pat.kind == "sym":
        key = ("s", pat.name)
        prev = state[0].get(key)
        if prev is None:
            binds = dict(state[0])
            binds[key] = vid
            return (binds, state[1])
        return state if prev == vid else None
    if pat.kind == "cst":
        node = g.nodes.get(vid)
        if not isinstance(node, Constant):
            return None
        if pat.value is not None:
            if node.array.size != 1:
                return None
            c = float(node.array.reshape(()))
            if abs(c - pat.value) > 1e-6 * max(1.0, abs(pat.value)):
                return None
        if pat.name is not None:
            key = ("c", pat.name)
            prev = state[0].get(key)
            if prev is not None and prev != vid:
                return None
            binds = dict(state[0])
            binds[key] = vid
            return (binds, state[1])
        return state
    # op
    prod = producers.get(vid)
    if prod is None:
        return None
    nid, op = prod
    if op.op_type != pat.op_type:
        return None
    ins = op.inputs
    if len(ins) < len(pat.args):
        return None
    orders = [pat.args]
    if op.op_type in _COMMUTATIVE and len(pat.args) == 2:
        orders.append(pat.args[::-1])
    if pat.name is not None:
        prev = state[0].get(("o", pat.name))
        if prev is not None and prev != nid:
            return None
    for order in orders:
        binds = dict(state[0])
        if pat.name is not None:
            binds[("o", pat.name)] = nid
        cur = (binds, state[1] + (nid,))
        ok = True
        for sub, in_vid in zip(order, ins):
            if in_vid is None:
                ok = False
                break
            cur = _match_pattern(g, producers, sub, in_vid, cur)
            if cur is None:
                ok = False
                break
        if ok:
            return cur
    return None


def _consumer_ops(g: Graph) -> Dict[NodeId, set]:
    c: Dict[NodeId, set] = {}
    for nid, op in g.operators():
        for i in op.inputs:
            if i is not None:
                c.setdefault(i, set()).add(nid)
    return c


def _apply_pattern_fusion(g: Graph, pattern: _Pat, build, label: str) -> bool:
    """Match ``pattern`` rooted at every operator output; on success call
    ``build(g, binds, matched_op)`` -> (op_type, inputs, attrs) or None to
    reject. The matched subgraph is replaced by the single fused op writing
    the original root output id (so downstream edges stay valid)."""
    changed = False
    producers = _producer_map(g)
    consumers = _consumer_ops(g)
    for root_id, root_op in list(g.operators()):
        if root_id not in g.nodes:
            continue  # consumed by an earlier match this pass
        if not root_op.outputs:
            continue
        out_vid = root_op.outputs[0]
        m = _match_pattern(g, producers, pattern, out_vid, ({}, ()))
        if m is None:
            continue
        binds, matched = m
        matched_set = set(matched)
        # Interior values (every matched op output except the root's) must
        # be consumed only inside the match and must not be graph outputs —
        # otherwise removal would orphan a live edge (reference
        # find_fusable_subgraph's same rule, pattern_matcher.rs).
        safe = True
        inter_vals = []
        for nid in matched_set:
            node = g.nodes.get(nid)
            if node is None:
                safe = False
                break
            for o in node.outputs:
                if o == out_vid:
                    continue
                inter_vals.append(o)
                if o in g.output_ids or not (
                    consumers.get(o, set()) <= matched_set
                ):
                    safe = False
                    break
            if not safe:
                break
        if not safe:
            continue
        repl = build(g, binds, root_op)
        if repl is None:
            continue
        op_type, inputs, attrs = repl
        g.remove_nodes(list(matched_set) + inter_vals)
        g.add_op(op_type, inputs, [out_vid], attrs, name=root_op.name)
        _log(f"fused {label}")
        changed = True
        producers = _producer_map(g)
        consumers = _consumer_ops(g)
    return changed


def _reduce_is_last_axis(g: Graph, op: Operator, x_vid) -> bool:
    """ReduceMean applied to the input's last axis (axes attr or opset-18
    axes input; positive axes need a known input rank — reference
    op_applied_to_last_axis, fusions.rs:646)."""
    axes = op.attrs.get("axes")
    if axes is None and len(op.inputs) > 1 and op.inputs[1] is not None:
        node = g.nodes.get(op.inputs[1])
        if isinstance(node, Constant):
            axes = node.array.reshape(-1).tolist()
    if axes is None:
        return False
    axes = [int(a) for a in axes]
    if axes == [-1]:
        return True
    x_node = g.nodes.get(x_vid)
    shape = getattr(x_node, "shape", None)
    return shape is not None and axes == [len(shape) - 1]


def _product_of(a: _Pat, b: _Pat, c: _Pat) -> _Pat:
    """x*y*z under any association/order (2-arg commutativity is handled by
    the matcher; this covers the three distinct association groupings)."""
    return p_any(
        p_op("Mul", p_op("Mul", a, b), c),
        p_op("Mul", p_op("Mul", a, c), b),
        p_op("Mul", p_op("Mul", b, c), a),
    )


_SQRT_2 = float(np.sqrt(2.0))
_SQRT_2_PI = float(np.sqrt(2.0 / np.pi))

_X = p_sym("x")

# x/sqrt(2) as exported: Div by sqrt(2) or Mul by 1/sqrt(2).
_X_OVER_SQRT2 = p_any(
    p_op("Div", _X, p_cst(_SQRT_2)),
    p_op("Mul", _X, p_cst(1.0 / _SQRT_2)),
)
_GELU_PAT = _product_of(
    _X, p_op("Add", p_op("Erf", _X_OVER_SQRT2), p_cst(1.0)), p_cst(0.5)
)

_APPROX_GELU_PAT = _product_of(
    _X,
    p_op(
        "Add",
        p_op(
            "Tanh",
            p_op(
                "Mul",
                p_cst(_SQRT_2_PI),
                p_op(
                    "Add",
                    _X,
                    p_op("Mul", p_op("Pow", _X, p_cst(3.0)), p_cst(0.044715)),
                ),
            ),
        ),
        p_cst(1.0),
    ),
    p_cst(0.5),
)

_CENTER = p_op("Sub", _X, p_op("ReduceMean", _X, name="center_mean"),
               name="center")
_LN_NORM = p_op(
    "Div",
    _CENTER,
    p_op(
        "Sqrt",
        p_op(
            "Add",
            p_cst(name="epsilon"),
            p_op("ReduceMean", p_op("Pow", _CENTER, p_cst(2.0)),
                 name="norm_mean"),
        ),
    ),
)
_LN_SCALED = p_op("Mul", _LN_NORM, p_cst(name="scale"))
# Matched as TWO passes (biased first), not one p_any: graph order visits
# the Mul before the Add, so a combined pattern would always take the
# scale-only alternative at the Mul root and leave the bias Add unfused.
_LAYER_NORM_BIASED_PAT = p_op("Add", _LN_SCALED, p_cst(name="bias"))
_LAYER_NORM_PAT = _LN_SCALED

_SILU_PAT = p_op("Mul", _X, p_op("Sigmoid", _X))
_SWISH_PAT = p_op("Mul", _X, p_op("Sigmoid", p_op("Mul", p_cst(name="alpha"), _X)))


def fuse_gelu(g: Graph) -> bool:
    """Decomposed Gelu -> Gelu op: exact erf form x*(1+Erf(x/sqrt2))*0.5
    (rten GeluFusion, src/optimize/fusions.rs:407) and the tanh
    approximation (ApproxGeluFusion, fusions.rs:535). Opset<20 torch
    exports decompose F.gelu this way."""

    def build_exact(g, binds, root):
        return "Gelu", [binds[("s", "x")]], {"approximate": "none"}

    def build_tanh(g, binds, root):
        return "Gelu", [binds[("s", "x")]], {"approximate": "tanh"}

    c1 = _apply_pattern_fusion(g, _GELU_PAT, build_exact, "Gelu (erf)")
    c2 = _apply_pattern_fusion(g, _APPROX_GELU_PAT, build_tanh, "Gelu (tanh)")
    return c1 or c2


def fuse_layer_norm(g: Graph) -> bool:
    """Decomposed LayerNormalization -> LayerNormalization op (rten
    LayerNormalizationFusion, src/optimize/fusions.rs:674). Opset-11/13
    torch exports decompose LayerNorm into ReduceMean/Sub/Pow/Sqrt/Div;
    beyond op count this matters because derive_tp_plan uses normalization
    ops as transformer-block boundaries — an unrecognized norm would let
    Megatron col/row pairing leak across blocks."""

    def build(g, binds, root):
        x_vid = binds[("s", "x")]
        eps_node = g.nodes.get(binds[("c", "epsilon")])
        if eps_node is None or eps_node.array.size != 1:
            return None
        for key in ("center_mean", "norm_mean"):
            nid = binds.get(("o", key))
            op = g.nodes.get(nid)
            if op is None or not _reduce_is_last_axis(g, op, x_vid):
                return None
        scale_vid = binds[("c", "scale")]
        bias_vid = binds.get(("c", "bias"))
        inputs = [x_vid, scale_vid] + ([bias_vid] if bias_vid is not None else [])
        eps = float(eps_node.array.reshape(()))
        return "LayerNormalization", inputs, {"axis": -1, "epsilon": eps}

    c1 = _apply_pattern_fusion(
        g, _LAYER_NORM_BIASED_PAT, build, "LayerNormalization (biased)"
    )
    c2 = _apply_pattern_fusion(g, _LAYER_NORM_PAT, build, "LayerNormalization")
    return c1 or c2


def fuse_silu_swish(g: Graph) -> bool:
    """x*Sigmoid(x) -> Silu; x*Sigmoid(alpha*x) -> Swish (rten SiluFusion /
    SwishFusion, src/optimize/fusions.rs:570,600)."""

    def build_silu(g, binds, root):
        return "Silu", [binds[("s", "x")]], {}

    def build_swish(g, binds, root):
        alpha_node = g.nodes.get(binds[("c", "alpha")])
        if alpha_node is None or alpha_node.array.size != 1:
            return None
        return "Swish", [binds[("s", "x")]], {
            "alpha": float(alpha_node.array.reshape(()))
        }

    c1 = _apply_pattern_fusion(g, _SILU_PAT, build_silu, "Silu")
    c2 = _apply_pattern_fusion(g, _SWISH_PAT, build_swish, "Swish")
    return c1 or c2


FUSIONS: List[Callable[[Graph], bool]] = [
    fuse_identity,
    fuse_cast_elimination,
    # LayerNorm before RMSNorm: the decomposed-LayerNorm chain CONTAINS the
    # RMSNorm pattern (normalize-variance applied to the centered value), so
    # the RMS matcher would otherwise claim the inner half first.
    fuse_layer_norm,
    fuse_rms_norm,
    fuse_gelu,
    fuse_silu_swish,
    fuse_matmul_integer_to_float,
    fuse_conv_integer_to_float,
    fuse_attention,
]


def prepack_int8_weights(g: Graph) -> bool:
    """Load-time prepack for MatMulIntegerToFloat weights (the WeightCache/
    prepack analog, rten src/weight_cache.rs + rten-gemm packing/int8.rs):

    * precompute the weight matrix's int32 column sums (needed for the
      activation-zero-point correction) as a constant — otherwise the
      kernel would re-read the full weight matrix EVERY step;
    * pad N up to a 128 multiple when needed (e.g. GPT-2 lm_head N=50257)
      so the kernel never materializes a padded copy of the weight per
      step; the lowering slices the output back via `rten_orig_n`.
    """
    changed = False
    padded: Dict[NodeId, Tuple[NodeId, NodeId]] = {}
    for nid, op in list(g.operators()):
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
        # u8 weight with a runtime zero point: the kernel shifts b to s8
        # (b' = b - 128) before the dot, so load-time colsums computed on
        # the raw u8 bytes would be off by 128*K in the a_zp correction.
        # The flip can't be folded either (zp unknown) — skip prepacking
        # and let the kernel derive colsums from its shifted operand.
        if b_node.array.dtype == np.uint8 and not zp_is_const:
            continue
        entry = padded.get(b_id)
        if entry is None:
            b = b_node.array
            b_name = b_node.name or "w"
            K, N = b.shape
            # Lane alignment is 128; very wide weights (lm_head) also pad
            # to 2048 so the decode kernel gets LARGE divisor blocks —
            # N=50257 pads to 51200 (2048*25) instead of 50304 (128*393,
            # 393=3*131: largest usable divisor block only 384 cols).
            align = 2048 if N >= 8192 else 128
            Np = -(-N // align) * align
            will_pad = Np != N
            # Padding N requires padding any per-column zero-point vector
            # alongside (the kernel reshapes it to [1, Np]); with a runtime
            # zero point that's impossible at load time — skip.
            if will_pad and not zp_is_const:
                continue
            # u8 weights: fold the per-step u8->s8 sign-flip (another full
            # weight rewrite) into the constant, shifting the zero point
            # (kernels/common.py u8_to_s8_shift algebra). zp_is_const was
            # checked above for the u8 case.
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
                # s8 weight with per-column zp: materialize it as i32 so the
                # pad below applies uniformly.
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
        _log(f"prepacked {len(padded)} int8 weight matrices")
    return changed


def fold_shape_computations(g: Graph) -> bool:
    """Materialize shape-computation results that are fully concrete even
    when some graph dims are symbolic (rten ShapeSliceToConstant /
    ComputeShapeFusion, src/optimize.rs:611-651 early fusions + symbolic
    values from rten-shape-inference lib.rs:40-62).

    Example: Shape(x:["batch",12,64]) -> Gather(idx=2) folds to Constant(64)
    although the batch dim is unknown — plain constant propagation cannot
    touch it because Shape's input isn't constant.
    """
    from .shape_inference import infer_shapes_and_values

    _, sym_vals = infer_shapes_and_values(g)
    producers = _producer_map(g)
    changed = False
    for vid, sv in sym_vals.items():
        node = g.nodes.get(vid)
        if not isinstance(node, Value):
            continue  # already a Constant (or gone)
        prod = producers.get(vid)
        if prod is None:
            continue  # graph input
        conc = sv.concrete()
        if conc is None:
            continue
        g.nodes[vid] = Constant(name=node.name, array=conc)
        changed = True
    if changed:
        # Drop operators whose outputs all became constants.
        dead = [
            nid
            for nid, op in list(g.operators())
            if op.outputs
            and all(isinstance(g.nodes.get(o), Constant) for o in op.outputs)
        ]
        g.remove_nodes(dead)
        eliminate_dead_code(g)
        _log("folded symbolic shape computations")
    return changed


def promote_captured_constants(sub: Graph, outer: Graph) -> bool:
    """Copy outer-graph Constants that a subgraph captures by name INTO the
    subgraph (reference capture promotion, src/model/onnx_loader.rs:293-296
    + src/optimize.rs:669-701): per-subgraph const-prop and the quantized
    fusions can then see the weights/scales an If/Loop body uses. Promoted
    names leave ``sub.captures``; arrays are shared, not copied."""
    changed = False
    remaining = []
    for name in sub.captures:
        oid = outer.find_node(name)
        onode = outer.nodes.get(oid) if oid is not None else None
        sid = sub.find_node(name)
        if (
            isinstance(onode, Constant)
            and sid is not None
            and isinstance(sub.nodes.get(sid), Value)
        ):
            sub.nodes[sid] = Constant(name=name, array=onode.array)
            changed = True
        else:
            remaining.append(name)
    sub.captures = remaining
    return changed


def optimize_graph(g: Graph, constant_prop: bool = True) -> Graph:
    """The full pipeline (rten optimize.rs:502-661), applied per subgraph."""
    # Step 1 (rten optimize.rs:502-560): shape inference annotates Value
    # dims and folds shape-computation chains that are concrete despite
    # symbolic dims elsewhere.
    try:
        fold_shape_computations(g)
    except Exception:
        pass  # inference is advisory; optimization must not fail a load
    if constant_prop:
        propagate_constants(g)

    # Full per-subgraph optimization (the reference
    # runs the whole optimizer per subgraph after promoting captured
    # constants, src/optimize.rs:669-701). Runs after outer const-prop so
    # exporter `Constant` ops feeding captures are already Constant nodes.
    # Remaining captures stay opaque: per-subgraph const-prop treats them
    # as missing inputs and only folds what is locally constant.
    for _, op in list(g.operators()):
        for sub in op.subgraphs():
            promote_captured_constants(sub, g)
            optimize_graph(sub, constant_prop=constant_prop)

    for _ in range(3):
        changed = False
        for fusion in FUSIONS:
            changed |= fusion(g)
        if not changed:
            break
    prepack_int8_weights(g)
    eliminate_dead_code(g)
    eliminate_dead_constants(g)
    return g
