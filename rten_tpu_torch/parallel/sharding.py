"""Sharding plans and sharded weights (the port of
``rten_tpu/parallel/sharding.py``).

The plans are the JAX package's: name-pattern rule tables and the
structural Megatron plan (``derive_tp_plan``, ``tp_weight_shardings``),
with ``P``, a small spec type of the port's own, in place of JAX's
``PartitionSpec``:

* QKV / MLP-up projections: column-parallel  [E, 3E|4E] -> P(None, 'model')
* attn-out / MLP-down:      row-parallel     [*, E]     -> P('model', None)
* LM head:                  column-parallel over vocab
* KV caches:                heads on the model axis
* token inputs / masks:     batch on the data axis

What GSPMD did from those annotations the port does explicitly:
``shard_model`` cuts the graph into this rank's graph
(``partition.partition_graph``: sliced weights, local head counts,
collectives as operators) and runs it on the rank's device.
``shard_constants`` and ``shard_constants_by_plan`` return that model's
weights as {node id: tensor} (a ``ShardedParams``, which carries the model:
``ContinuousBatchingEngine(..., params=...)`` and the Generator's
``constant_inputs`` run it). ``shard_inputs`` cuts a feed by the input
rules. Each runs once per rank.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ir.graph import Constant, Graph, is_weight_constant


class P(tuple):
    """A partition spec: for each leading dimension of a tensor, the mesh
    axis it is cut over, or None (replicated along it). ``P()`` is fully
    replicated; trailing dimensions not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def normalize(spec) -> Tuple:
    """A spec without its trailing Nones (P(None) and P() are the same)."""
    spec = tuple(spec or ())
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


# (regex on node name, P) — first match wins.
GPT2_SHARDING_RULES: List[Tuple[str, P]] = [
    (r"\.attn\.c_attn\.weight$", P(None, "model")),
    (r"\.attn\.c_attn\.bias$", P("model")),
    (r"\.attn\.c_proj\.weight$", P("model", None)),
    (r"\.mlp\.c_fc\.weight$", P(None, "model")),
    (r"\.mlp\.c_fc\.bias$", P("model")),
    (r"\.mlp\.c_proj\.weight$", P("model", None)),
    (r"^lm_head\.weight_t$", P(None, "model")),
    (r"^transformer\.wte\.weight$", P(None, None)),
    # int8-quantized variants produced by quantize_pass (same layouts).
    (r"\.attn\.c_attn\.weight\.q8$", P(None, "model")),
    (r"\.attn\.c_attn\.weight\.scales$", P("model")),
    (r"\.attn\.c_proj\.weight\.q8$", P("model", None)),
    (r"\.mlp\.c_fc\.weight\.q8$", P(None, "model")),
    (r"\.mlp\.c_fc\.weight\.scales$", P("model")),
    (r"\.mlp\.c_proj\.weight\.q8$", P("model", None)),
    (r"\.scales$", P(None)),
]

# Runtime inputs for causal-LM graphs.
GPT2_INPUT_RULES: List[Tuple[str, P]] = [
    (r"^input_ids$", P("data", None)),
    (r"^attention_mask$", P("data", None)),
    (r"^position_ids$", P("data", None)),
    (r"^past_key_values\..*\.(key|value)$", P("data", "model", None, None)),
]

# Sequence-parallel (SP) prefill: activations cut along the TOKEN axis over
# the 'model' mesh axis, weights replicated. Embeddings, norms and MLPs are
# token-pointwise; at attention the rank-local graph all-gathers K/V
# (``AllGather`` ops) while Q, the scores and the output stay token-sharded.
# The token count must divide the 'model' axis size.
SP_PREFILL_INPUT_RULES: List[Tuple[str, P]] = [
    (r"^input_ids$", P("data", "model")),
    (r"^attention_mask$", P("data", None)),
    (r"^position_ids$", P("data", "model")),
    (r"^past_key_values\..*\.(key|value)$", P("data", None, None, None)),
]

# Expert parallelism: the MoE op's stacked [n_experts, ...] weights cut on
# the leading expert axis; each rank computes its experts and the
# gate-weighted combine is summed across the ranks (ops/moe.py). Routers
# replicate.
MOE_EP_RULES: List[Tuple[str, P]] = [
    (r"\.moe\.(w_up|w_down|b_up|b_down)$", P("model")),
    (r"\.moe\.router_w$", P()),
]


def sharding_for_name(name: Optional[str], rules: List[Tuple[str, P]]) -> Optional[P]:
    if name is None:
        return None
    for pat, spec in rules:
        if re.search(pat, name):
            return spec
    return None


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` of a ``Mesh`` or a ``MeshConfig``."""
    return mesh.shape[axis]


# --- generic TP derivation --------------------------------------------------
#
# derive_tp_plan reads the STRUCTURE: Megatron pairing says a const-weight
# matmul feeding another const-weight matmul through elementwise/attention
# ops (no normalization in between — norms need the full hidden vector,
# which forces the all-reduce boundary) forms a (column-parallel,
# row-parallel) pair. The final lm_head (no downstream const matmul, feeds a
# graph output) is column-parallel over the vocab.

_MATMUL_OPS = {"MatMul", "MatMulAdd", "Gemm", "MatMulIntegerToFloat", "MatMulNBits"}
# Ops that BLOCK a Megatron pair (they consume the full hidden axis).
_TP_BLOCKERS = {
    "LayerNormalization", "RMSNormalization", "SimplifiedLayerNormalization",
    "SkipLayerNormalization", "SkipSimplifiedLayerNormalization",
    "InstanceNormalization", "BatchNormalization", "LpNormalization",
    "Gather", "ArgMax", "ArgMin",
}


def _weight_input(graph: Graph, op) -> Optional[int]:
    """Node id of the constant weight operand, if this matmul has one."""
    if not op.inputs or len(op.inputs) < 2 or op.inputs[1] is None:
        return None
    w = graph.nodes.get(op.inputs[1])
    if isinstance(w, Constant) and w.array.ndim == 2:
        return op.inputs[1]
    return None


def derive_tp_plan(graph: Graph) -> Dict[int, str]:
    """Classify const-weight matmul OPERATORS as 'col' / 'row' / 'lm_head'.

    Returns {operator_node_id: kind}. Pure graph analysis — no name
    patterns, so it works for any architecture the pairing rule fits.
    """
    consumers: Dict[int, List[Tuple[int, object]]] = {}
    for nid, op in graph.operators():
        for i in op.inputs:
            if i is not None:
                consumers.setdefault(i, []).append((nid, op))

    matmuls = [
        (nid, op) for nid, op in graph.operators()
        if op.op_type in _MATMUL_OPS and _weight_input(graph, op) is not None
    ]
    matmul_ids = {nid for nid, _ in matmuls}

    # edges[m1] = const-matmuls reachable from m1's output through
    # pass-through ops (activation inputs only).
    edges: Dict[int, set] = {nid: set() for nid in matmul_ids}
    reaches_output: Dict[int, bool] = {nid: False for nid in matmul_ids}
    output_set = set(graph.output_ids)
    for m_id, m_op in matmuls:
        seen = set()
        stack = list(m_op.outputs)
        while stack:
            vid = stack.pop()
            if vid in seen:
                continue
            seen.add(vid)
            if vid in output_set:
                reaches_output[m_id] = True
            for c_id, c_op in consumers.get(vid, ()):
                if c_id in matmul_ids:
                    if c_op.inputs and c_op.inputs[0] == vid:
                        edges[m_id].add(c_id)
                    continue
                if c_op.op_type in _TP_BLOCKERS or c_op.subgraphs():
                    # ArgMax feeds the on-device sampling head; its presence
                    # after a matmul counts as reaching the output.
                    if c_op.op_type in ("ArgMax", "ArgMin"):
                        reaches_output[m_id] = True
                    continue
                stack.extend(c_op.outputs)

    kinds: Dict[int, str] = {}
    for m_id in matmul_ids:
        for succ in edges[m_id]:
            kinds.setdefault(succ, "row")
    for m_id in matmul_ids:
        if edges[m_id] and kinds.get(m_id) != "row":
            kinds[m_id] = "col"
    for m_id in matmul_ids:
        if m_id not in kinds and reaches_output[m_id] and not edges[m_id]:
            kinds[m_id] = "lm_head"
    return kinds


def tp_weight_shardings(graph: Graph, mesh, axis: str = "model") -> Dict[int, P]:
    """{constant_node_id: P} derived from derive_tp_plan, covering f32
    weights, int8 weights + per-col scales + prepacked col sums, and biases.
    Weights whose sharded dim isn't divisible by the mesh axis stay
    replicated. (The plan is the JAX package's; what the partition makes of
    a row-parallel product's column sums is in ``partition.py``.)"""
    size = axis_size(mesh, axis)
    kinds = derive_tp_plan(graph)
    out: Dict[int, P] = {}

    def put(nid, spec, dim_ok):
        if nid is not None and dim_ok:
            out[nid] = spec

    for m_id, kind in kinds.items():
        op = graph.nodes[m_id]
        w_id = _weight_input(graph, op)
        K, N = graph.nodes[w_id].array.shape
        if kind in ("col", "lm_head"):
            ok = N % size == 0
            put(w_id, P(None, axis), ok)
            if op.op_type == "MatMulIntegerToFloat":
                put(op.inputs[3] if len(op.inputs) > 3 else None, P(axis), ok)
                put(op.inputs[7] if len(op.inputs) > 7 else None, P(None, axis), ok)
                put(op.inputs[6] if len(op.inputs) > 6 else None, P(axis), ok)
            elif op.op_type in ("MatMulAdd", "Gemm") and len(op.inputs) > 2:
                put(op.inputs[2], P(axis), ok)
        elif kind == "row":
            ok = K % size == 0
            put(w_id, P(axis, None), ok)
            if op.op_type == "MatMulIntegerToFloat":
                put(op.inputs[3] if len(op.inputs) > 3 else None, P(None), ok)
                put(op.inputs[7] if len(op.inputs) > 7 else None, P(None, None), ok)
    return out


def fsdp_weight_shardings(graph: Graph, mesh, axis: str = "data",
                          min_size: int = 16) -> Dict[int, P]:
    """ZeRO-3/FSDP parameter plan: every weight-like constant cut on its
    largest mesh-divisible dimension over ``axis`` (ties prefer the leading
    dim). The plan only: the port's FSDP training step is not ported yet
    (ROADMAP.md)."""
    size = axis_size(mesh, axis)
    out: Dict[int, P] = {}
    for nid, node in graph.nodes.items():
        if not isinstance(node, Constant) or not is_weight_constant(node, min_size):
            continue
        shape = node.array.shape
        best = None
        for d, n in enumerate(shape):
            if n % size == 0 and (best is None or n > shape[best]):
                best = d
        if best is None:
            continue
        spec = [None] * len(shape)
        spec[best] = axis
        out[nid] = P(*spec)
    return out


# --- sharded models and weights ----------------------------------------------


class ShardedParams(dict):
    """{node id: tensor on the rank's device}: the weights of a rank's
    graph. ``model`` is the rank's ``ShardedModel``, which
    ``ContinuousBatchingEngine(params=...)`` runs in place of the model it
    is given; ``by_name()`` the same weights by name, for the Generator's
    ``constant_inputs``."""

    model = None

    @property
    def graph(self) -> Graph:
        return self.model.graph

    def by_name(self) -> "ShardedParams":
        named = ShardedParams({self.model.graph.node_name(n): t for n, t in self.items()})
        named.model = self.model
        return named


def plan_from_rules(graph: Graph, rules, min_size: int = 16) -> Dict[int, P]:
    """{constant id: P} of every weight-like constant a rule names."""
    plan = {}
    for nid, node in graph.nodes.items():
        if isinstance(node, Constant) and is_weight_constant(node, min_size):
            spec = sharding_for_name(node.name, rules)
            if spec is not None:
                plan[nid] = spec
    return plan


def shard_model(model_or_graph, mesh, plan: Optional[Dict[int, P]] = None,
                rules: List[Tuple[str, P]] = GPT2_SHARDING_RULES,
                input_rules: List[Tuple[str, P]] = GPT2_INPUT_RULES,
                dtype: Optional[torch.dtype] = None, min_size: int = 16, run_config=None):
    """This rank's ``ShardedModel`` of a model (or of an optimized graph):
    the weights cut by ``plan`` ({constant id: P}), or by the name ``rules``
    where no plan is given, the inputs by ``input_rules``, the graph
    partitioned to match (``partition.partition_graph``). ``dtype`` casts
    the f32 weights (bfloat16, as the JAX package's ``dtype``)."""
    from .partition import ShardedModel

    graph = getattr(model_or_graph, "graph", model_or_graph)
    if run_config is None and hasattr(model_or_graph, "options"):
        run_config = model_or_graph.options.run_config
    if plan is None:
        plan = plan_from_rules(graph, rules, min_size)
    return ShardedModel(graph, mesh, plan, input_rules, dtype=dtype, min_size=min_size,
                        run_config=run_config)


def shard_constants(graph: Graph, mesh, rules: List[Tuple[str, P]] = GPT2_SHARDING_RULES,
                    dtype=None, min_size: int = 16,
                    input_rules: List[Tuple[str, P]] = GPT2_INPUT_RULES) -> ShardedParams:
    """Every weight-like constant on this rank's device, cut by its rule's
    spec (replicated where no rule matches): the weights of the rank's
    ``ShardedModel`` (``.model``)."""
    return shard_model(graph, mesh, rules=rules, input_rules=input_rules, dtype=dtype,
                       min_size=min_size).params


def shard_constants_by_plan(graph: Graph, mesh, plan: Dict[int, P], dtype=None,
                            min_size: int = 16,
                            input_rules: List[Tuple[str, P]] = GPT2_INPUT_RULES
                            ) -> ShardedParams:
    """``shard_constants`` with per-node specs (replicated where the plan
    has no entry): the derive_tp_plan companion."""
    return shard_model(graph, mesh, plan=plan, input_rules=input_rules, dtype=dtype,
                       min_size=min_size).params


def input_spec(name: Optional[str], ndim: int, rules) -> Tuple:
    """The input rules' spec of an input of ``ndim`` dims, normalized. A
    cat-layout cache [slots, cap, Hkv*D] (kernel_append graphs) has its
    heads on the LAST axis, so a rule's 'model' moves from dim 1 to dim 2."""
    spec = tuple(sharding_for_name(name, rules) or ())
    if ndim == 3 and name and re.search(r"^past_key_values\.", name) and len(spec) == 4:
        spec = (spec[0], None, spec[1])
    return normalize(spec[:ndim])


def cut(value: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``value`` under ``spec`` (contiguous chunks)."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], mesh.coords[axis]
        if value.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(value.shape)} does not divide "
                             f"the {axis} axis ({n})")
        step = value.shape[d] // n
        value = value.narrow(d, i * step, step)
    return value.contiguous()


def shard_inputs(graph: Graph, mesh, feed: Dict[int, "np.ndarray"],
                 rules: List[Tuple[str, P]] = GPT2_INPUT_RULES) -> Dict[int, torch.Tensor]:
    """{node id: this rank's block of the fed value, on its device}, cut by
    the input rules (sequence-parallel rules cut the token axis)."""
    from ..runtime.executor import to_tensor

    out = {}
    for nid, val in feed.items():
        t = to_tensor(val, mesh.device)
        out[nid] = cut(t, input_spec(graph.node_name(nid), t.ndim, rules), mesh)
    return out
