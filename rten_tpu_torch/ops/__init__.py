"""Operator lowerings. Importing this package populates the registry."""

from . import registry  # noqa: F401
from .registry import OpError, REGISTRY, get_op, register  # noqa: F401

# Import op modules for their registration side effects.
from . import (  # noqa: F401
    attention,
    elementwise,
    gather,
    layout,
    matmul,
    norm,
    quantize,
    reduce,
)
