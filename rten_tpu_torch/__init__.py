"""rten_tpu_torch: the PyTorch and CUDA port of rten_tpu.

The same IR graphs as the JAX package, run eagerly by PyTorch on an NVIDIA
H100; every Pallas kernel of the ported path is a hand-written CUDA kernel
(``rten_tpu_torch/csrc``). Entry points run on the CUDA card unless the
caller passes ``device="cpu"``. Imports nothing of JAX or ``rten_tpu``.
"""

__version__ = "0.1.0"

from .dtypes import DataType  # noqa: F401
from .ir import Graph, GraphBuilder  # noqa: F401
from .model import Model, ModelOptions  # noqa: F401
from .runtime import Executor, RunConfig  # noqa: F401
