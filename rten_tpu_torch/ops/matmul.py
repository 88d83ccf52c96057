"""MatMulIntegerToFloat (the port of ``rten_tpu/ops/matmul.py:132-178``).

Inputs (a, b, a_scale, b_scale, a_zero_point, b_zero_point, bias,
b_colsums): routed to the int8 kernel
(``rten_tpu_torch/kernels/int8_matmul.py``), sliced back to the logical
width ``rten_orig_n`` when the prepack padded N, then the bias is added.
"""

from __future__ import annotations

from ..kernels.int8_matmul import int8_matmul_dequant
from .registry import as_tensor, get_input, opt_input, register


@register("MatMulIntegerToFloat")
def _matmul_integer_to_float(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    a_scale = as_tensor(ctx, get_input(inputs, 2, "a_scale"))
    b_scale = as_tensor(ctx, get_input(inputs, 3, "b_scale"))
    a_zp = opt_input(inputs, 4)
    b_zp = opt_input(inputs, 5)
    bias = opt_input(inputs, 6)
    b_colsums = opt_input(inputs, 7)
    orig_n = attrs.get("rten_orig_n")
    if b.ndim != 2:
        raise NotImplementedError(
            "batched MatMulIntegerToFloat weights: ROADMAP.md queue 1 item 12"
        )
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    out = int8_matmul_dequant(
        a2, b, a_scale, b_scale,
        None if a_zp is None else as_tensor(ctx, a_zp),
        None if b_zp is None else as_tensor(ctx, b_zp),
        None if b_colsums is None else as_tensor(ctx, b_colsums),
    ).reshape(*lead, b.shape[-1])
    if orig_n is not None and out.shape[-1] != orig_n:
        out = out[..., :orig_n]
    if bias is not None:
        out = out + as_tensor(ctx, bias)
    return out
