"""Mixture-of-experts block (the port of ``rten_tpu/ops/moe.py``): one op on
stacked expert weights, the contrib op the builder in ``models/moe.py``
emits.

inputs:
  x        [B, T, E]
  router_w [E, X]              (X = n_experts)
  w_up     [X, E, F]           (gate and up merged when act='swiglu': F = 2*ff)
  w_down   [X, F', E]
  b_up     [X, F]   optional
  b_down   [X, E]   optional
attrs: top_k (default 2), activation ('gelu' | 'silu' | 'swiglu'),
       normalize_gates (default 1: softmax over the selected k, else a
       sigmoid of each), dispatch ('dense' | 'capacity'), capacity_factor
       (default 1.25)

* ``dispatch="dense"``: every expert runs on every token and the top-k gate
  mask weights the combine (the JAX lowering's dense-mask formulation; a
  per-expert down bias rides inside the combine).
* ``dispatch="capacity"``: GShard capacity dispatch. Each expert takes at
  most C = max(8, round_up_8(ceil(N * k * capacity_factor / X))) token
  slots; slots go to (token, choice) assignments in token-major order and
  an assignment past its expert's capacity is dropped (contributes zero).

Expert parallelism (``rten_tpu_torch/parallel/partition.py``): a rank's
op holds the experts ``rten_expert_offset`` .. + X_local of the X the
router scores; routing, the gates and (capacity
dispatch) C and the token-major drop order are the global ones, the rank
runs its own experts only, and the partial combine is summed over the ranks
by the ``AllReduce`` the partition puts after the op.

The router and the expert products run in f32 whatever the process-wide
TF32 flags say (``contract`` in f64 on the card); no lowering reads or sets
those flags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .elementwise import gelu
from .matmul import contract
from .registry import OpError, as_tensor, get_input, opt_input, register


def _einsum(ctx, eq, *args):
    return contract(ctx, lambda *ops: torch.einsum(eq, *ops), *args, honour_bf16=False)


def _activation(act: str):
    if act == "swiglu":
        def swiglu(h):
            ff = h.shape[-1] // 2
            return F.silu(h[..., :ff]) * h[..., ff:]
        return swiglu
    if act == "silu":
        return F.silu
    if act == "gelu":
        return lambda h: gelu(h, approximate=False)
    raise OpError(f"MoE: unknown activation '{act}'")


@register("MoE")
def _moe(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    router_w, w_up, w_down = (as_tensor(ctx, get_input(inputs, i, n)).to(torch.float32)
                              for i, n in ((1, "router_w"), (2, "w_up"), (3, "w_down")))
    b_up, b_down = (opt_input(inputs, i) for i in (4, 5))
    b_up = None if b_up is None else as_tensor(ctx, b_up).to(torch.float32)
    b_down = None if b_down is None else as_tensor(ctx, b_down).to(torch.float32)
    top_k = int(attrs.get("top_k", 2))
    act = _activation(attrs.get("activation", "gelu"))
    X = router_w.shape[1]
    lo = int(attrs.get("rten_expert_offset", 0))
    mine = slice(lo, lo + w_up.shape[0])  # the experts this op holds
    if top_k > X:
        raise OpError(f"top_k {top_k} exceeds n_experts {X}")

    xf = x.to(torch.float32)
    logits = _einsum(ctx, "bte,ex->btx", xf, router_w)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)  # [B, T, k]
    if bool(attrs.get("normalize_gates", 1)):
        gate_vals = torch.softmax(top_vals, dim=-1)
    else:
        gate_vals = torch.sigmoid(top_vals)

    if attrs.get("dispatch", "dense") == "capacity":
        B, T, E = x.shape
        N, k = B * T, top_k
        cf = float(attrs.get("capacity_factor", 1.25))
        C = max(8, int(-(-N * k * cf // X)) + 7 & ~7)
        oh_e = F.one_hot(top_idx.reshape(N * k), X).to(torch.float32)  # [N*k, X]
        # Each assignment's slot in its expert, token-major.
        pos = torch.cumsum(oh_e, dim=0) * oh_e - 1.0
        keep = (pos >= 0) & (pos < C)
        oh_c = F.one_hot(pos.clamp(0, C - 1).to(torch.int64), C).to(torch.float32)
        oh_c = (oh_c * keep[..., None]).reshape(N, k, X, C)[:, :, mine]
        disp = oh_c.sum(dim=1)                                          # [N, X, C]
        comb = (gate_vals.reshape(N, k)[:, :, None, None] * oh_c).sum(dim=1)
        xd = _einsum(ctx, "nxc,nd->xcd", disp, xf.reshape(N, E))        # [X, C, E]
        h = _einsum(ctx, "xcd,xdf->xcf", xd, w_up)
        if b_up is not None:
            h = h + b_up[:, None, :]
        y = _einsum(ctx, "xcf,xfe->xce", act(h), w_down)
        if b_down is not None:
            y = y + b_down[:, None, :]
        return _einsum(ctx, "nxc,xce->ne", comb, y).reshape(B, T, E).to(x.dtype)

    gates = (gate_vals[..., None] * F.one_hot(top_idx, X).to(torch.float32)).sum(dim=2)
    gates = gates[..., mine]
    h = _einsum(ctx, "bte,xef->xbtf", xf, w_up)
    if b_up is not None:
        h = h + b_up[:, None, None, :]
    y = _einsum(ctx, "xbtf,xfe->xbte", act(h), w_down)
    if b_down is not None:
        y = y + b_down[:, None, None, :]
    return _einsum(ctx, "btx,xbte->bte", gates, y).to(x.dtype)
