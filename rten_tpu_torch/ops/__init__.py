"""Operator lowerings. Importing this package populates the registry."""

from . import registry  # noqa: F401
from .registry import OpError, REGISTRY, get_op, register  # noqa: F401

# Import op modules for their registration side effects.
from . import (  # noqa: F401
    attention,
    collective,
    contrib,
    control_flow,
    conv,
    einsum,
    elementwise,
    fft,
    gather,
    grid_sample,
    layout,
    matmul,
    moe,
    nms,
    norm,
    pool,
    quantize,
    random,
    reduce,
    resize,
    rnn,
    sequence,
)
