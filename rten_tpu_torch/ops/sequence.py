"""Sequence ops (the port of ``rten_tpu/ops/sequence.py``; rten
src/ops/sequence.rs, ValueType::Sequence).

A sequence is a Python list of values, as in the JAX package (the
reference keeps a Vec<Value>); the executor passes it through as it is. A
list of host values is a host value, so a sequence of shapes stays on the
host. Positions and split sizes are read on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, host_value, opt_input, register


def _as_seq(v, what="sequence"):
    if not isinstance(v, list):
        raise OpError(f"{what} input must be a sequence")
    return v


def _pos(p, n, what="position"):
    i = int(host_value(p).reshape(()))
    if i < 0:
        i += n
    if not 0 <= i < n:
        raise OpError(f"{what} {i} out of range for sequence of {n}")
    return i


@register("SequenceEmpty")
def _sequence_empty(ctx, inputs, attrs):
    return []


@register("SequenceConstruct")
def _sequence_construct(ctx, inputs, attrs):
    return list(inputs)


@register("SequenceLength")
def _sequence_length(ctx, inputs, attrs):
    return np.asarray(len(_as_seq(get_input(inputs, 0))), np.int32)


@register("SequenceAt")
def _sequence_at(ctx, inputs, attrs):
    seq = _as_seq(get_input(inputs, 0))
    return seq[_pos(get_input(inputs, 1, "position"), len(seq))]


@register("SequenceInsert")
def _sequence_insert(ctx, inputs, attrs):
    seq = list(_as_seq(get_input(inputs, 0)))
    val = get_input(inputs, 1)
    pos = opt_input(inputs, 2)
    if pos is None:
        seq.append(val)
    else:
        i = int(host_value(pos).reshape(()))
        if i < 0:
            i += len(seq) + 1
        seq.insert(i, val)
    return seq


@register("SequenceErase")
def _sequence_erase(ctx, inputs, attrs):
    seq = list(_as_seq(get_input(inputs, 0)))
    pos = opt_input(inputs, 1)
    i = _pos(pos, len(seq)) if pos is not None else len(seq) - 1
    del seq[i]
    return seq


@register("ConcatFromSequence")
def _concat_from_sequence(ctx, inputs, attrs):
    seq = [as_tensor(ctx, x) for x in _as_seq(get_input(inputs, 0))]
    axis = attrs.get("axis")
    if axis is None:
        raise OpError("ConcatFromSequence requires axis")
    if attrs.get("new_axis", 0):
        return torch.stack(seq, dim=axis)
    return torch.cat(seq, dim=axis)


@register("SplitToSequence")
def _split_to_sequence(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    split = opt_input(inputs, 1)
    axis = attrs.get("axis", 0)
    keepdims = attrs.get("keepdims", 1)
    n = x.shape[axis]
    if split is None:
        parts = list(torch.split(x, 1, dim=axis))
        if not keepdims:
            parts = [p.squeeze(axis) for p in parts]
        return parts
    sp = host_value(split)
    if sp.ndim == 0:
        size = int(sp)
        indices = list(range(size, n, size))
    else:
        indices = [int(c) for c in np.cumsum([int(s) for s in sp])[:-1]]
    return list(torch.tensor_split(x, indices, dim=axis))
