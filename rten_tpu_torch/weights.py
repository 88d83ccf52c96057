"""Carry weights across: replace a port model's constants by name."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .ir.graph import Constant


def load_numpy_constants(model, arrays: Dict[str, np.ndarray]) -> None:
    """Replace ``model``'s graph constants named in ``arrays`` (for example
    the JAX package's optimized s8 weights, scales, colsums and padded
    lm_head) and re-upload them to the model's device on the next run.

    Every name must be a constant of the graph, with the same shape and
    dtype; nothing is replaced unless all of them match.
    """
    g = model.graph
    plan = []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        nid = g.find_node(name)
        node = g.nodes.get(nid) if nid is not None else None
        if not isinstance(node, Constant):
            raise KeyError(f"model has no constant named '{name}'")
        if arr.shape != node.array.shape or arr.dtype != node.array.dtype:
            raise ValueError(
                f"{name}: expected {node.array.dtype}{list(node.array.shape)}, "
                f"got {arr.dtype}{list(arr.shape)}"
            )
        plan.append((nid, name, arr))
    for nid, name, arr in plan:
        g.nodes[nid] = Constant(name=name, array=np.ascontiguousarray(arr))
    model.executor.invalidate_weights()
