"""Graph executor: walk the IR plan eagerly, one PyTorch lowering per node
(the port of ``rten_tpu/runtime/executor.py``).

The JAX executor traces the whole plan into one jitted XLA computation.
PyTorch runs eagerly, so here ``trace`` *is* the execution: each op's
lowering runs (or launches its CUDA kernel) as the plan is walked, on the
executor's device. There is no compile step and no shape-keyed cache; the
plan itself is cached per (fed inputs, requested outputs).

Constants: weight-sized constants move to the device once (the
``_weight_args`` analog, the rten WeightCache); small integer constants
(shapes, axes) stay numpy arrays on the host, where ``static_value`` reads
them without a device sync.

In-place updates: where the JAX engine donated the KV-cache buffers so XLA
could update them in place, the port's ``QuantizedKVAttention`` writes the
new rows straight into the cache tensors it is given and returns them as
its ``present.*`` outputs. ``run(..., donate=ids)`` allows that for the
listed inputs; any other input an op would write in place is copied first,
so a caller's tensor is never changed behind its back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import narrow_array
from ..ir.graph import Constant, Graph, NodeId, Operator
from .. import ops  # noqa: F401  (importing the package registers the lowerings)
from ..ops.registry import REGISTRY, OpError, get_op


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another device; with no card and no request, raise."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")


def _device_resident(node: Constant) -> bool:
    """Weights, scales, colsums and any float constant live on the device;
    small integer constants (shapes, axes) stay on the host."""
    return node.array.size >= 16 or node.array.dtype.kind == "f"


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """A caller's value as a tensor on ``device`` (numpy narrowed first)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = narrow_array(np.asarray(value))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass
class RunConfig:
    """Run options (analog of rten RunOptions). The slice needs none: a
    kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
    plain version for CPU tensors, so no flag selects kernels."""


class TraceContext:
    """Per-run context handed to op lowerings: the device and the config."""

    def __init__(self, executor: "Executor", config: RunConfig):
        self.executor = executor
        self.config = config
        self.device = executor.device


class Executor:
    def __init__(self, graph: Graph, config: Optional[RunConfig] = None,
                 device=None):
        self.graph = graph
        self.config = config or RunConfig()
        self.device = resolve_device(device)
        self._weights: Optional[Dict[NodeId, torch.Tensor]] = None
        self._constants: Optional[Dict[NodeId, np.ndarray]] = None
        self._plans: Dict[Tuple, List[NodeId]] = {}
        # Graph inputs some op writes in place (KV caches).
        self._inplace_ids = set()
        for _, op in graph.operators():
            opdef = REGISTRY.get(op.op_type)
            for i in (opdef.inplace if opdef else ()):
                if i < len(op.inputs) and op.inputs[i] is not None:
                    self._inplace_ids.add(op.inputs[i])

    def _weight_args(self) -> Dict[NodeId, torch.Tensor]:
        """Device-resident constants, moved once (rten WeightCache analog),
        narrowed like every other value (numpy's int64 column sums become
        the int32 the int8 kernel takes)."""
        if self._weights is None:
            self._weights = {
                nid: to_tensor(node.array, self.device)
                for nid, node in self.graph.nodes.items()
                if isinstance(node, Constant) and _device_resident(node)
            }
        return self._weights

    def _host_constants(self) -> Dict[NodeId, np.ndarray]:
        if self._constants is None:
            self._constants = {
                nid: node.array for nid, node in self.graph.nodes.items()
                if isinstance(node, Constant)
            }
        return self._constants

    def invalidate_weights(self) -> None:
        """Drop the cached constants and their device copies (after
        constants were replaced)."""
        self._weights = None
        self._constants = None

    def _plan(self, env_ids, output_ids) -> List[NodeId]:
        key = (frozenset(env_ids), tuple(output_ids))
        plan = self._plans.get(key)
        if plan is None:
            plan = self.graph.plan(
                list(env_ids), list(output_ids), allow_missing_inputs=True
            )
            self._plans[key] = plan
        return plan

    def trace(
        self,
        env: Dict[NodeId, Any],
        output_ids: Sequence[NodeId],
        allow_missing: bool = False,
    ) -> List[Any]:
        """Walk the plan, running each op's lowering; returns output values."""
        g = self.graph
        ctx = TraceContext(self, self.config)
        consts = self._host_constants()
        fed = [nid for nid in env if nid not in consts]
        for nid, arr in consts.items():
            env.setdefault(nid, arr)
        for op_id in self._plan(fed, output_ids):
            op = g.nodes[op_id]
            assert isinstance(op, Operator)
            ins = [env.get(i) if i is not None else None for i in op.inputs]
            op_def = get_op(op.op_type)
            attrs = dict(op.attrs)
            attrs["__n_outputs__"] = len(op.outputs)
            try:
                result = op_def.lower(ctx, ins, attrs)
            except OpError as e:
                raise OpError(f"{op.op_type} '{g.node_name(op_id)}': {e}") from e
            if not isinstance(result, tuple):
                result = (result,)
            if len(result) < len(op.outputs):
                raise OpError(
                    f"{op.op_type} returned {len(result)} outputs, "
                    f"node declares {len(op.outputs)}"
                )
            for out_id, val in zip(op.outputs, result):
                env[out_id] = val
        outs = []
        for oid in output_ids:
            if oid not in env:
                if allow_missing:
                    outs.append(None)
                    continue
                raise OpError(f"output {g.node_name(oid)} was not computed")
            outs.append(env[oid])
        return outs

    def run(
        self,
        inputs: Dict[NodeId, Any],
        output_ids: Sequence[NodeId],
        donate: Sequence[NodeId] = (),
    ) -> List[torch.Tensor]:
        """Run the graph on the executor's device.

        ``inputs`` are numpy arrays or tensors; ``donate`` lists the inputs
        (KV caches) that ops may update in place — the JAX engine's buffer
        donation. Returns tensors on the device.
        """
        donated = set(donate)
        env: Dict[NodeId, Any] = dict(self._weight_args())
        for nid, val in inputs.items():
            t = to_tensor(val, self.device)
            if (nid in self._inplace_ids and nid not in donated
                    and t is val):
                t = t.clone()
            env[nid] = t
        return self.trace(env, list(output_ids))

    def partial_run(
        self, inputs: Dict[NodeId, Any], output_ids: Sequence[NodeId]
    ) -> List[Tuple[NodeId, Any]]:
        """Evaluate whatever subset of `output_ids` is reachable from the
        constants and ``inputs`` (rten partial_run, src/graph.rs:1335-1384);
        used for constant propagation at load time. Results are numpy."""
        env: Dict[NodeId, Any] = {
            nid: to_tensor(v, self.device) for nid, v in inputs.items()
        }
        outs = self.trace(env, list(output_ids), allow_missing=True)
        result = []
        for oid, v in zip(output_ids, outs):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            elif v is not None:
                v = np.asarray(v)
            result.append((oid, v))
        return result
