"""Eager op helpers (the port of ``rten_tpu/functional.py``): the
``Operators``/``FloatOperators`` extension-trait sugar (rten
src/ops/operators.rs:26,94, ``x.softmax(-1)`` style) as plain functions,
each running the SAME registry lowering the graph executor runs. Handy for
pre- and post-processing around model calls.

    from rten_tpu_torch import functional as F
    probs = F.softmax(logits, axis=-1)
    keep = F.non_max_suppression(boxes, scores, iou_threshold=0.5)

Every helper takes numpy arrays or tensors and returns tensors on one
device: the card unless the caller passes ``device="cpu"`` (or another
device). Data inputs move there; the helpers' own parameters (TopK's k,
Resize's sizes, Pad's pads) stay host constants, as the executor keeps a
graph's small integer constants. So ``arg_max`` over the last axis of an
f32 tensor of two or more dimensions on the card launches the argmax kernel
(``kernels/argmax.py``), as the executor routes the ArgMax node.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .ops.registry import get_op
from .runtime.executor import RngSupply, RunConfig, TraceContext, resolve_device, to_tensor


def _run(op_type: str, inputs, attrs=None, n_outputs: int = 1, device=None,
         host=()):
    """Lower ``op_type`` once on ``device``: inputs at the positions in
    ``host`` are handed over as host arrays, the rest as tensors there."""
    dev = resolve_device(device)
    a = dict(attrs or {})
    a["__n_outputs__"] = n_outputs
    ins = [None if x is None else np.asarray(x) if i in host else to_tensor(x, dev)
           for i, x in enumerate(inputs)]
    ctx = TraceContext(None, RunConfig(), RngSupply(0, 0), device=dev)
    out = get_op(op_type).lower(ctx, ins, a)
    if isinstance(out, (tuple, list)):
        return tuple(to_tensor(o, dev) for o in out)
    return to_tensor(out, dev)


def softmax(x, axis: int = -1, device=None):
    return _run("Softmax", [x], {"axis": axis}, device=device)


def log_softmax(x, axis: int = -1, device=None):
    return _run("LogSoftmax", [x], {"axis": axis}, device=device)


def gelu(x, approximate: str = "none", device=None):
    return _run("Gelu", [x], {"approximate": approximate}, device=device)


def silu(x, device=None):
    return _run("Silu", [x], device=device)


def erf(x, device=None):
    return _run("Erf", [x], device=device)


def sigmoid(x, device=None):
    return _run("Sigmoid", [x], device=device)


def layer_norm(x, weight, bias=None, axis: int = -1, epsilon: float = 1e-5, device=None):
    return _run("LayerNormalization", [x, weight, bias], {"axis": axis, "epsilon": epsilon},
                device=device)


def rms_norm(x, weight, axis: int = -1, epsilon: float = 1e-5, device=None):
    return _run("RMSNormalization", [x, weight], {"axis": axis, "epsilon": epsilon},
                device=device)


def matmul(a, b, device=None):
    return _run("MatMul", [a, b], device=device)


def conv2d(x, w, bias=None, strides=(1, 1), pads=(0, 0, 0, 0),
           dilations=(1, 1), group: int = 1, device=None):
    return _run(
        "Conv", [x, w, bias],
        {"strides": list(strides), "pads": list(pads),
         "dilations": list(dilations), "group": group}, device=device,
    )


def resize(x, sizes: Sequence[int], mode: str = "nearest", device=None):
    return _run("Resize", [x, None, None, np.asarray(sizes, np.int32)], {"mode": mode},
                device=device, host=(3,))


def top_k(x, k: int, axis: int = -1, largest: bool = True, device=None):
    return _run("TopK", [x, np.asarray([k], np.int32)],
                {"axis": axis, "largest": int(largest)}, n_outputs=2, device=device,
                host=(1,))


def arg_max(x, axis: int = -1, keepdims: bool = False, device=None):
    return _run("ArgMax", [x], {"axis": axis, "keepdims": int(keepdims)}, device=device)


def non_max_suppression(boxes, scores, max_output_boxes: int = 300,
                        iou_threshold: float = 0.5, score_threshold: float = 0.0,
                        device=None):
    """boxes [B,N,4] (y1,x1,y2,x2), scores [B,C,N] -> [M,3] (b, c, idx)."""
    return _run(
        "NonMaxSuppression",
        [boxes, scores, np.asarray([max_output_boxes], np.int64),
         np.asarray([iou_threshold], np.float32),
         np.asarray([score_threshold], np.float32)], device=device, host=(2, 3, 4),
    )


def pad(x, pads: Sequence[int], mode: str = "constant", value: float = 0.0, device=None):
    return _run("Pad", [x, np.asarray(pads, np.int32), np.asarray(value, np.float32)],
                {"mode": mode}, device=device, host=(1,))


def quantize_linear(x, scale, zero_point=None, axis: int = 1, device=None):
    return _run("QuantizeLinear", [x, scale, zero_point], {"axis": axis}, device=device)


def dequantize_linear(x, scale, zero_point=None, axis: int = 1, device=None):
    return _run("DequantizeLinear", [x, scale, zero_point], {"axis": axis}, device=device)

