"""Operator registry: ONNX op name -> PyTorch lowering (the port of
``rten_tpu/ops/registry.py``).

Lowering signature::

    def lower(ctx, inputs, attrs): -> tensor | tuple of tensors

* ``inputs`` is a list whose entries are torch tensors (runtime values and
  weight constants, on ``ctx.device``), numpy arrays (small constants such
  as shapes and axes, kept on the host) or ``None`` (omitted optional
  input).
* Ops that need a static value (Reshape's ``shape``) call
  :func:`static_value`, which reads a host constant without touching the
  device.
* ``ctx`` is the executor's ``TraceContext`` (device, config).

Execution is eager: each lowering runs its PyTorch ops (or launches its
kernel) as the executor walks the plan.

``inplace`` names the input positions a lowering writes in place (the KV
caches of QuantizedKVAttention); the executor copies such an input first
unless the caller donated it, which keeps a caller's tensor unchanged as
JAX's immutable arrays would.

``static`` names the input positions a lowering reads with
``static_value`` (Resize's scales and sizes): where such an input is a
small graph constant, one the JAX package keeps concrete under jit, the
executor hands the lowering its numpy array even though a float constant
otherwise lives on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


class OpError(Exception):
    """Operator lowering failure; mirrors rten OpError (src/operator.rs:116)."""


@dataclasses.dataclass
class OpDef:
    name: str
    lower: Callable
    inplace: Tuple[int, ...] = ()
    static: Tuple[int, ...] = ()


REGISTRY: Dict[str, OpDef] = {}


def register(name: str, inplace: Tuple[int, ...] = (), static: Tuple[int, ...] = ()):
    def deco(fn):
        REGISTRY[name] = OpDef(name=name, lower=fn, inplace=tuple(inplace),
                               static=tuple(static))
        return fn

    return deco


def get_op(name: str) -> OpDef:
    """The lowering of ``name``. The port registers every operator the JAX
    package registers, so an unknown name is one neither package runs:
    ``OpError``, as the JAX package raises it. A graph holding one loads,
    and fails when it runs that op."""
    op = REGISTRY.get(name)
    if op is None:
        raise OpError(f"operator '{name}' is not registered (by this port or by the "
                      f"JAX package)")
    return op


def static_value(x, what: str = "input") -> np.ndarray:
    """Host numpy value of a constant input; fails for runtime tensors.

    Shape-carrying inputs must be graph constants: reading a device tensor
    here would synchronise with the device on every run.
    """
    if x is None:
        raise OpError(f"{what} is missing")
    if isinstance(x, torch.Tensor):
        raise OpError(
            f"{what} must be a graph constant (data-dependent shapes are "
            f"not supported)"
        )
    return np.asarray(x)


def host_value(x) -> np.ndarray:
    """``x`` as a numpy array on the host: a host value as it is, a tensor
    read back (one device-to-host copy for a card tensor). For the ops
    whose control or output shape depends on a value (If, Loop, sequence
    positions, NonMaxSuppression)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def as_tensor(ctx, x) -> torch.Tensor:
    """A tensor on the context's device (host constants are moved)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=ctx.device)


def get_input(inputs: List, i: int, name: str = "input"):
    if i >= len(inputs) or inputs[i] is None:
        raise OpError(f"missing required {name} (input {i})")
    return inputs[i]


def opt_input(inputs: List, i: int, default=None):
    if i >= len(inputs) or inputs[i] is None:
        return default
    return inputs[i]
