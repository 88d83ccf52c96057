"""ArgMax over the last axis (the port of ``rten_tpu/ops/reduce.py:66-92``),
routed to the argmax kernel (``rten_tpu_torch/kernels/argmax.py``)."""

from __future__ import annotations

from ..kernels.argmax import argmax_lastdim
from .registry import as_tensor, get_input, register


@register("ArgMax")
def _argmax(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = attrs.get("axis", 0)
    keepdims = bool(attrs.get("keepdims", 1))
    if attrs.get("select_last_index", 0) or axis not in (-1, x.ndim - 1) or x.ndim < 2:
        raise NotImplementedError(
            "ArgMax other than first-occurrence over the last axis of a "
            ">= 2-D tensor: ROADMAP.md queue 1 item 12"
        )
    lead = x.shape[:-1]
    idx = argmax_lastdim(x.reshape(-1, x.shape[-1])).reshape(lead)
    if keepdims:
        idx = idx.unsqueeze(-1)
    return idx
