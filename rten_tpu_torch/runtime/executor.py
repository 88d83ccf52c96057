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

Host values: the JAX executor evaluates an op eagerly, at trace time, when
none of its inputs is traced (shape chains such as Shape -> Gather ->
Concat -> Reshape), so their results are concrete for the ops that need
static values. The port does the same: an op whose inputs are all host
values (numpy arrays: shape results and the constants the JAX package
keeps concrete, those ``is_weight_constant`` does not count as weights)
runs on the CPU and its results stay numpy arrays on the host. A reshape
target then never reads a card tensor back.

Control flow: If and Loop run their subgraphs through
``TraceContext.run_subgraph`` on the executor's device, whatever the
placement of their own inputs (an If whose only input is a host flag still
runs its branch on the card); inside a subgraph the host rule holds as
above. A subgraph resolves the values it captures by name from the scopes
of the graphs that enclose it (rten CaptureEnv, src/graph.rs:1165-1181):
``trace`` publishes every named value of a graph that holds control flow.
Sequence values (Python lists of values) pass through ``env`` as they are;
a list of host values is itself a host value.

Random ops (``ops.random.RANDOM_OPS``) run on the executor's device too,
though they may have no input at all. Each draw takes a ``torch.Generator``
on that device from ``TraceContext.next_rng``: seeded from
``RunConfig.seed``, the run's number and the draw's counter within the run
(the JAX package's ``fold_in`` of the run counter and of the draw counter,
``rten_tpu/runtime/executor.py:83-87, 276-283``). The run number advances
only in a graph holding an unseeded random op (``_find_fresh_rng``), so
such an op draws anew on every run and a graph whose random ops all carry
a ``seed`` attribute draws the same values every run.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import narrow_array
from ..ir.graph import Constant, Graph, NodeId, Operator, is_weight_constant
from .. import ops  # noqa: F401  (importing the package registers the lowerings)
from ..ops.random import RANDOM_OPS, seeded_generator
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
    if node.array.dtype.kind in "OUS":  # strings never leave the host
        return False
    return node.array.size >= 16 or node.array.dtype.kind == "f"


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """A caller's value as a tensor on ``device`` (numpy narrowed first; a
    numpy bfloat16 array, ``ml_dtypes``' type, keeps its bits)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = narrow_array(np.asarray(value))
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # which keeps a 0-d array 0-d
    bf16 = arr.dtype.name == "bfloat16"
    with warnings.catch_warnings():
        # A loaded model's constants are read-only memory maps; no lowering
        # writes to a constant.
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


@dataclasses.dataclass
class RunConfig:
    """Run options (analog of rten RunOptions). A kernel wrapper launches
    its CUDA kernel for CUDA tensors and runs its plain version for CPU
    tensors, so no flag selects kernels (the JAX package's ``use_pallas_*``
    fields have no counterpart).

    ``prefer_bf16``: f32 MatMul, Gemm, FusedMatMul, MatMulAdd, Einsum and
    Conv operands on the card go through one bf16 pass (cuBLAS and cuDNN
    accumulate in f32; the results are widened back to f32), as the JAX
    package's DEFAULT precision runs them on the TPU. bf16 rather than
    TF32: it rounds the operands as the TPU's pass does, and PyTorch
    chooses TF32 only through process-wide flags, which a run must not
    touch. Without it the products are full f32. On the CPU both are f32,
    as the JAX package computes there.

    ``seed``: the seed of the random ops' draws (those without a ``seed``
    attribute of their own)."""

    prefer_bf16: bool = False
    seed: int = 0


class RngSupply:
    """The generators of one run's random draws: the n-th draw of run r
    seeds its generator from (seed, r, n)."""

    def __init__(self, seed: int, run: int):
        self.seed, self.run, self.counter = seed, run, 0

    def next(self, device) -> torch.Generator:
        self.counter += 1
        key = np.random.SeedSequence([self.seed % 2**64, self.run, self.counter])
        return seeded_generator(int(key.generate_state(1, np.uint64)[0]), device)


class TraceContext:
    """Per-run context handed to op lowerings: the device, the config and
    the capture scopes of the graphs being walked (innermost last) and the
    run's supply of random generators."""

    def __init__(self, executor: "Executor", config: RunConfig, rng: RngSupply,
                 device=None, scopes: Optional[List[Dict[str, Any]]] = None):
        self.executor = executor
        self.config = config
        self.rng = rng
        self.device = executor.device if device is None else device
        self.scopes: List[Dict[str, Any]] = [] if scopes is None else scopes

    def next_rng(self) -> torch.Generator:
        """A generator on this context's device for the run's next draw."""
        return self.rng.next(self.device)

    def lookup_capture(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return None

    def run_subgraph(self, subgraph: Graph, inputs: Sequence[Any]) -> List[Any]:
        """Run a control-flow subgraph on the executor's device: ``inputs``
        bound to its inputs in order, its captures resolved by name from
        the enclosing scopes. Returns its output values."""
        sub = self.executor.sub_executor(subgraph)
        env: Dict[NodeId, Any] = dict(sub._weight_args())
        for nid, val in zip(subgraph.input_ids, inputs):
            env[nid] = val
        for name in subgraph.captures:
            v = self.lookup_capture(name)
            if v is None:
                raise OpError(f"unresolved capture '{name}' in subgraph")
            nid = subgraph.find_node(name)
            if nid is not None:
                env[nid] = v
        return sub.trace(env, subgraph.output_ids, scopes=self.scopes, rng=self.rng)


_CPU = torch.device("cpu")


def _to_host(value, device: torch.device):
    """A host-evaluated op's result as a numpy array (narrowed as the JAX
    package's int32/f32 values are), a sequence element by element;
    bfloat16, which numpy has no type for, moves to ``device`` as a tensor
    instead."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.to(device)
        return narrow_array(value.numpy())
    if isinstance(value, list):
        return [_to_host(v, device) for v in value]
    return value


def _on_device(value, device: torch.device):
    """A run's value as the caller gets it: a tensor on ``device``, a
    sequence as a list of them."""
    if isinstance(value, list):
        return [_on_device(v, device) for v in value]
    return to_tensor(value, device)


class Executor:
    def __init__(self, graph: Graph, config: Optional[RunConfig] = None,
                 device=None):
        self.graph = graph
        self.config = config or RunConfig()
        self.device = resolve_device(device)
        self._weights: Optional[Dict[NodeId, torch.Tensor]] = None
        self._weight_ids: set = set()
        self._derived: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._constants: Optional[Dict[NodeId, np.ndarray]] = None
        self._concrete: Optional[set] = None
        self._plans: Dict[Tuple, List[NodeId]] = {}
        self._inplace_ids = self._find_inplace_ids()
        self._control_ids = self._find_control_ids()
        self._fresh_rng = self._find_fresh_rng()
        self._subs: Dict[int, "Executor"] = {}
        self._run_counter = 0

    def _find_fresh_rng(self) -> bool:
        """True if the graph holds a random op without a ``seed``
        attribute: such an op draws anew on every run."""
        return any(op.op_type in RANDOM_OPS and op.attrs.get("seed") is None
                   for _, op in self.graph.operators())

    def _next_rng(self) -> RngSupply:
        """The random generators of a new run."""
        if self._fresh_rng:
            self._run_counter += 1
            return RngSupply(self.config.seed, self._run_counter)
        return RngSupply(self.config.seed, 0)

    def _find_control_ids(self) -> set:
        """The operators that hold subgraphs (If, Loop)."""
        return {nid for nid, op in self.graph.operators() if op.subgraphs()}

    def sub_executor(self, subgraph: Graph) -> "Executor":
        """The executor of one of this graph's control-flow subgraphs (or of
        theirs), made once: its weights move to the device once and its
        plans are kept."""
        sub = self._subs.get(id(subgraph))
        if sub is None or sub.graph is not subgraph:
            sub = Executor(subgraph, self.config, device=self.device)
            self._subs[id(subgraph)] = sub
        return sub

    def _find_inplace_ids(self) -> set:
        """The graph inputs some op writes in place (KV caches)."""
        ids = set()
        for _, op in self.graph.operators():
            opdef = REGISTRY.get(op.op_type)
            for i in (opdef.inplace if opdef else ()):
                if i < len(op.inputs) and op.inputs[i] is not None:
                    ids.add(op.inputs[i])
        return ids

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
            self._weight_ids = {id(t) for t in self._weights.values()}
        return self._weights

    def derived_weight(self, w: torch.Tensor, tag, make) -> torch.Tensor:
        """``make()``, a layout of the device weight ``w`` that an op
        derives (``tag`` names it), made once and kept until
        ``invalidate_weights``; for a tensor that is not one of the
        executor's weights, made anew on every call."""
        key = (id(w), tag)
        hit = self._derived.get(key)
        if hit is not None and hit[0] is w:
            return hit[1]
        out = make()
        if id(w) in self._weight_ids:
            self._derived[key] = (w, out)
        return out

    def _host_constants(self) -> Dict[NodeId, np.ndarray]:
        if self._constants is None:
            self._constants = {
                nid: node.array for nid, node in self.graph.nodes.items()
                if isinstance(node, Constant)
            }
        return self._constants

    def _concrete_ids(self) -> set:
        """The constants the JAX package keeps concrete under jit (every
        constant but the weights it passes as arguments)."""
        if self._concrete is None:
            self._concrete = {
                nid for nid, node in self.graph.nodes.items()
                if isinstance(node, Constant) and not is_weight_constant(node)
            }
        return self._concrete

    def invalidate_weights(self) -> None:
        """Drop the cached constants, their device copies and the plans
        (after a pass replaced constants or rewrote operators)."""
        self._weights = None
        self._weight_ids = set()
        self._derived = {}
        self._constants = None
        self._concrete = None
        self._plans = {}
        self._inplace_ids = self._find_inplace_ids()
        self._control_ids = self._find_control_ids()
        self._fresh_rng = self._find_fresh_rng()
        self._subs = {}

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
        profiler=None,
        scopes: Optional[List[Dict[str, Any]]] = None,
        rng: Optional[RngSupply] = None,
    ) -> List[Any]:
        """Walk the plan, running each op's lowering; returns output values.
        An op whose inputs are all host values runs on the CPU and gives
        host values (see the module's docstring); an op with subgraphs runs
        on the device. ``scopes``: the capture scopes of the enclosing
        graphs, for a subgraph; ``rng``: the run's random generators. With
        ``profiler`` the device is synchronized after each op and its wall
        time recorded."""
        g = self.graph
        scopes = [] if scopes is None else scopes
        rng = RngSupply(self.config.seed, 0) if rng is None else rng
        ctx = TraceContext(self, self.config, rng, scopes=scopes)
        host_ctx = TraceContext(self, self.config, rng, device=_CPU, scopes=scopes)
        consts = self._host_constants()
        concrete = self._concrete_ids()
        fed = [nid for nid in env if nid not in consts]
        for nid, arr in consts.items():
            env.setdefault(nid, arr)
        # Named values, published for the subgraphs of this graph's control
        # flow (none when it holds none).
        scope: Optional[Dict[str, Any]] = None
        if self._control_ids:
            scope = {}
            for nid, val in env.items():
                name = getattr(g.nodes.get(nid), "name", None)
                if name:
                    scope[name] = consts[nid] if nid in concrete else val
            scopes.append(scope)
        try:
            for op_id in self._plan(fed, output_ids):
                op = g.nodes[op_id]
                assert isinstance(op, Operator)
                op_def = get_op(op.op_type)
                host_ins = [None if i is None else consts[i] if i in concrete else env.get(i)
                            for i in op.inputs]
                control = op_id in self._control_ids
                on_host = not control and op.op_type not in RANDOM_OPS and all(
                    v is None or isinstance(v, np.ndarray)
                    or (isinstance(v, list) and all(isinstance(x, np.ndarray) for x in v))
                    for v in host_ins)
                ins = host_ins if on_host or control else [
                    host_ins[k] if k in op_def.static else env.get(i) if i is not None else None
                    for k, i in enumerate(op.inputs)]
                attrs = dict(op.attrs)
                attrs["__n_outputs__"] = len(op.outputs)
                t0 = time.perf_counter() if profiler is not None else 0.0
                try:
                    result = op_def.lower(host_ctx if on_host else ctx, ins, attrs)
                except OpError as e:
                    raise OpError(f"{op.op_type} '{g.node_name(op_id)}': {e}") from e
                if not isinstance(result, tuple):
                    result = (result,)
                if on_host:
                    result = tuple(_to_host(r, self.device) for r in result)
                if profiler is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    profiler.add(op.op_type, g.node_name(op_id),
                                 [tuple(v.shape) for v in ins if hasattr(v, "shape")],
                                 time.perf_counter() - t0)
                if len(result) < len(op.outputs):
                    raise OpError(
                        f"{op.op_type} returned {len(result)} outputs, "
                        f"node declares {len(op.outputs)}"
                    )
                for out_id, val in zip(op.outputs, result):
                    env[out_id] = val
                    if scope is not None:
                        name = getattr(g.nodes[out_id], "name", None)
                        if name:
                            scope[name] = val
            outs = []
            for oid in output_ids:
                if oid not in env:
                    if allow_missing:
                        outs.append(None)
                        continue
                    raise OpError(f"output {g.node_name(oid)} was not computed")
                outs.append(env[oid])
            return outs
        finally:
            if scope is not None:
                scopes.pop()

    def run(
        self,
        inputs: Dict[NodeId, Any],
        output_ids: Sequence[NodeId],
        donate: Sequence[NodeId] = (),
        static: Sequence[NodeId] = (),
    ) -> List[torch.Tensor]:
        """Run the graph on the executor's device.

        ``inputs`` are numpy arrays or tensors (a sequence input: a list of
        them); ``donate`` lists the inputs (KV caches) that ops may update
        in place — the JAX engine's buffer donation; ``static`` the inputs
        that stay numpy arrays on the host (the JAX package specializes its
        trace on them: an If's flag is then read without a device sync).
        Returns tensors on the device (a sequence output: a list)."""
        env: Dict[NodeId, Any] = dict(self._weight_args())
        env.update(self._feed(inputs, set(donate), set(static)))
        outs = self.trace(env, list(output_ids), rng=self._next_rng())
        return [_on_device(v, self.device) for v in outs]

    def _feed(self, inputs: Dict[NodeId, Any], donated: set, static: set) -> Dict[NodeId, Any]:
        """The env entries of a run's inputs: tensors on the device (a
        caller's tensor that an op would write in place, and that the
        caller did not donate, copied first), numpy for ``static``."""
        feed = {}
        for nid, val in inputs.items():
            if nid in static:
                feed[nid] = narrow_array(np.asarray(val))
            elif isinstance(val, (list, tuple)):
                feed[nid] = [to_tensor(v, self.device) for v in val]
            else:
                t = to_tensor(val, self.device)
                if nid in self._inplace_ids and nid not in donated and t is val:
                    t = t.clone()
                feed[nid] = t
        return feed

    def profile_run(
        self, inputs: Dict[NodeId, Any], output_ids: Sequence[NodeId]
    ):
        """A run that times each op, the device synchronized after it:
        (outputs, Profiler), for the CLI's ``--profile``."""
        from .profiler import Profiler

        prof = Profiler()
        env: Dict[NodeId, Any] = dict(self._weight_args())
        env.update(self._feed(inputs, set(), set()))
        outs = self.trace(env, list(output_ids), profiler=prof, rng=self._next_rng())
        return [_on_device(v, self.device) for v in outs], prof

    def partial_run(
        self, inputs: Dict[NodeId, Any], output_ids: Sequence[NodeId]
    ) -> List[Tuple[NodeId, Any]]:
        """Evaluate whatever subset of `output_ids` is reachable from the
        constants and ``inputs`` (rten partial_run, src/graph.rs:1335-1384);
        used for constant propagation at load time. Results are numpy; a
        sequence value is left out (None), as no constant holds one."""
        env: Dict[NodeId, Any] = {
            nid: to_tensor(v, self.device) for nid, v in inputs.items()
        }
        outs = self.trace(env, list(output_ids), allow_missing=True)
        result = []
        for oid, v in zip(output_ids, outs):
            if isinstance(v, list):
                v = None
            elif isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            elif v is not None:
                v = np.asarray(v)
            result.append((oid, v))
        return result
