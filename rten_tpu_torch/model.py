"""Model: the user-facing entry point (the port of ``rten_tpu/model.py``).

``Model(graph, options, device=None)`` optimizes an IR graph and runs it
by name on one device: the CUDA card unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
Loading ONNX or .rtpu files is not ported yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from .ir.graph import Graph, Value
from .runtime.executor import Executor, RunConfig


@dataclasses.dataclass
class ModelOptions:
    """Load-time options (rten ModelOptions, src/model.rs:672-757)."""

    optimize: bool = True
    run_config: RunConfig = dataclasses.field(default_factory=RunConfig)


class Model:
    """An optimized, runnable model on one device."""

    def __init__(
        self,
        graph: Graph,
        options: Optional[ModelOptions] = None,
        device=None,
    ):
        self.options = options or ModelOptions()
        if self.options.optimize:
            from .optimize import optimize_graph

            graph = optimize_graph(graph)
        self.graph = graph
        self.executor = Executor(graph, self.options.run_config, device=device)
        self.device = self.executor.device

    # -- introspection ---------------------------------------------------

    def output_names(self) -> List[str]:
        return [self.graph.node_name(i) for i in self.graph.output_ids]

    def input_info(self):
        out = []
        for nid in self.graph.input_ids:
            node = self.graph.nodes[nid]
            assert isinstance(node, Value)
            out.append((node.name, node.dtype, node.shape))
        return out

    # -- running ---------------------------------------------------------

    def run(
        self,
        inputs: Dict[str, Any],
        outputs: Optional[Sequence[str]] = None,
    ) -> List[torch.Tensor]:
        """Run with name-keyed inputs (numpy arrays or tensors); returns
        tensors on the model's device. Tensor inputs are never modified."""
        feed = {}
        for name, val in inputs.items():
            nid = self.graph.find_node(name)
            if nid is None:
                raise KeyError(f"model has no input named '{name}'")
            feed[nid] = val
        if outputs is None:
            out_ids = list(self.graph.output_ids)
        else:
            out_ids = []
            for name in outputs:
                nid = self.graph.find_node(name)
                if nid is None:
                    raise KeyError(f"model has no value named '{name}'")
                out_ids.append(nid)
        return self.executor.run(feed, out_ids)
