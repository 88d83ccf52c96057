"""Recurrent ops: LSTM, GRU (the port of ``rten_tpu/ops/rnn.py``; rten
src/ops/rnn.rs :388 LSTM, :110 GRU; forward, reverse, bidirectional).

The JAX package runs the time loop as a ``lax.scan`` with no kernel; here
it is a plain loop over time steps. The input projections of every step
are one product taken before the loop ([T*B, I] x [I, G*H]); only the
recurrent [B, H] x [H, G*H] product runs per step. Products are full f32
(the reference's HIGHEST precision), whatever ``prefer_bf16`` says.

ONNX semantics: X [T,B,I] (layout 0), W [dirs,G*H,I], R [dirs,G*H,H],
B [dirs,2*G*H]; LSTM gate order iofc, GRU gate order zrh. Steps at or past
a batch entry's ``sequence_lens`` keep its state and output 0. Initial
states are indexed by direction first under either layout, as the JAX
package reads them.
"""

from __future__ import annotations

import torch

from .matmul import contract
from .registry import OpError, as_tensor, get_input, opt_input, register


def _mm(ctx, a, b):
    return contract(ctx, torch.matmul, a, b, full=torch.float32, honour_bf16=False)


def _prep(x, layout):
    return x.transpose(0, 1) if layout == 1 else x  # [B,T,I] -> [T,B,I]


def _direction(attrs):
    d = attrs.get("direction", "forward")
    if isinstance(d, bytes):
        d = d.decode()
    if d not in ("forward", "reverse", "bidirectional"):
        raise OpError(f"bad RNN direction {d}")
    return d


def _seq_mask(ctx, seq_lens, T):
    if seq_lens is None:
        return None
    lens = as_tensor(ctx, seq_lens)
    return torch.arange(T, device=lens.device)[:, None] < lens[None, :]  # [T,B]


def _steps(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def _inputs(ctx, inputs, attrs, n_state):
    x = as_tensor(ctx, get_input(inputs, 0))
    w = as_tensor(ctx, get_input(inputs, 1, "W"))
    r = as_tensor(ctx, get_input(inputs, 2, "R"))
    b, seq_lens, *states = (opt_input(inputs, i) for i in range(3, 5 + n_state))
    b = None if b is None else as_tensor(ctx, b)
    states = [None if s is None else as_tensor(ctx, s) for s in states]
    layout = attrs.get("layout", 0)
    x = _prep(x, layout)
    H = attrs.get("hidden_size", r.shape[-1])
    return x, w, r, b, _seq_mask(ctx, seq_lens, x.shape[0]), states, layout, H


def _finish(ys, finals, layout, attrs):
    """Y [T, dirs, B, H] and the final states [dirs, B, H] (layout 1: Y
    [B, T, dirs, H], the states [B, dirs, H]), as many as the node takes."""
    Y = torch.stack(ys, dim=1)
    states = [torch.stack(f, dim=0) for f in finals]
    if layout == 1:
        Y = Y.permute(2, 0, 1, 3)
        states = [s.transpose(0, 1) for s in states]
    n_out = attrs.get("__n_outputs__", 1)
    outs = (Y, *states)
    return outs[:n_out] if n_out > 1 else Y


@register("LSTM")
def _lstm(ctx, inputs, attrs):
    if opt_input(inputs, 7) is not None:
        raise OpError("LSTM peepholes are not supported")
    x, w, r, b, mask, (h0, c0), layout, H = _inputs(ctx, inputs, attrs, 2)
    T, B, _ = x.shape
    direction = _direction(attrs)
    ys, hs, cs = [], [], []
    for d in range(w.shape[0]):
        reverse = direction == "reverse" or (direction == "bidirectional" and d == 1)
        xw = _mm(ctx, x, w[d].t())  # [T, B, 4H]
        if b is not None:
            gh = w.shape[1]
            xw = xw + b[d][:gh] + b[d][gh:]
        rT = r[d].t()
        h = h0[d] if h0 is not None else torch.zeros((B, H), dtype=x.dtype, device=x.device)
        c = c0[d] if c0 is not None else torch.zeros((B, H), dtype=x.dtype, device=x.device)
        y = [None] * T
        for t in _steps(T, reverse):
            g = xw[t] + _mm(ctx, h, rT)
            i, o, f, cc = g.chunk(4, dim=-1)  # iofc
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if mask is not None:
                keep = mask[t][:, None]
                h_new = torch.where(keep, h_new, h)
                c_new = torch.where(keep, c_new, c)
                y[t] = torch.where(keep, h_new, 0.0)
            else:
                y[t] = h_new
            h, c = h_new, c_new
        ys.append(torch.stack(y, dim=0))
        hs.append(h)
        cs.append(c)
    return _finish(ys, (hs, cs), layout, attrs)


@register("GRU")
def _gru(ctx, inputs, attrs):
    x, w, r, b, mask, (h0,), layout, H = _inputs(ctx, inputs, attrs, 1)
    T, B, _ = x.shape
    linear_before_reset = bool(attrs.get("linear_before_reset", 0))
    direction = _direction(attrs)
    ys, hs = [], []
    for d in range(w.shape[0]):
        reverse = direction == "reverse" or (direction == "bidirectional" and d == 1)
        rT = r[d].t()  # [H, 3H]
        # The recurrent bias stays apart: the h gate adds it inside the
        # reset product.
        wb, rb = (b[d][:3 * H], b[d][3 * H:]) if b is not None else (None, None)
        xw = _mm(ctx, x, w[d].t())
        if wb is not None:
            xw = xw + wb
        h = h0[d] if h0 is not None else torch.zeros((B, H), dtype=x.dtype, device=x.device)
        y = [None] * T
        for t in _steps(T, reverse):
            hr = _mm(ctx, h, rT)
            if rb is not None:
                hr = hr + rb
            xz, xr, xh = xw[t].chunk(3, dim=-1)  # zrh
            hz, hr_, hh = hr.chunk(3, dim=-1)
            z = torch.sigmoid(xz + hz)
            rgate = torch.sigmoid(xr + hr_)
            if linear_before_reset:
                hcand = torch.tanh(xh + rgate * hh)
            else:
                hh2 = _mm(ctx, rgate * h, rT[:, 2 * H:])
                if rb is not None:
                    hh2 = hh2 + rb[2 * H:]
                hcand = torch.tanh(xh + hh2)
            h_new = (1 - z) * hcand + z * h
            if mask is not None:
                keep = mask[t][:, None]
                h_new = torch.where(keep, h_new, h)
                y[t] = torch.where(keep, h_new, 0.0)
            else:
                y[t] = h_new
            h = h_new
        ys.append(torch.stack(y, dim=0))
        hs.append(h)
    return _finish(ys, (hs,), layout, attrs)
