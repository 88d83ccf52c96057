"""MNIST MLP and CNN (the port of ``rten_tpu/models/mnist.py``): the
operator-coverage family of BASELINE config 2 (the reference's
tools/train-mnist.py trains and exports the same shapes).

Graphs are built in IR with the weights as graph constants. The CNN runs
Conv, Relu, MaxPool, Flatten and MatMulAdd; ``quantize="int8"`` rewrites
both models' MatMulAdds into MatMulIntegerToFloat (the int8 kernel; the
classifier's N of 10 is widened to 12 there) and leaves the convs f32
unless ``RTEN_QUANT_CONV`` asks otherwise. Training (the JAX package's
``tools/train_mnist.py``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph
from ..model import Model, ModelOptions
from ..quantize_pass import quantize_dynamic


def build_mlp(weights: Dict[str, np.ndarray]) -> Graph:
    b = GraphBuilder()
    x = b.input("image", DataType.Float, ("batch", 784))
    h = b.op("MatMulAdd", [x, b.constant("l1.w", weights["l1.w"]),
                           b.constant("l1.b", weights["l1.b"])])
    h = b.op("Relu", [h])
    h = b.op("MatMulAdd", [h, b.constant("l2.w", weights["l2.w"]),
                           b.constant("l2.b", weights["l2.b"])])
    b.output(b.op("Identity", [h], output_names=["logits"]))
    return b.finish()


def build_cnn(weights: Dict[str, np.ndarray]) -> Graph:
    b = GraphBuilder()
    x = b.input("image", DataType.Float, ("batch", 1, 28, 28))
    h = b.op("Conv", [x, b.constant("c1.w", weights["c1.w"]),
                      b.constant("c1.b", weights["c1.b"])], {"pads": [1, 1, 1, 1]})
    h = b.op("Relu", [h])
    h = b.op("MaxPool", [h], {"kernel_shape": [2, 2], "strides": [2, 2]})
    h = b.op("Conv", [h, b.constant("c2.w", weights["c2.w"]),
                      b.constant("c2.b", weights["c2.b"])], {"pads": [1, 1, 1, 1]})
    h = b.op("Relu", [h])
    h = b.op("MaxPool", [h], {"kernel_shape": [2, 2], "strides": [2, 2]})
    h = b.op("Flatten", [h])
    h = b.op("MatMulAdd", [h, b.constant("fc.w", weights["fc.w"]),
                           b.constant("fc.b", weights["fc.b"])])
    b.output(b.op("Identity", [h], output_names=["logits"]))
    return b.finish()


def random_mlp_weights(seed=0, hidden=128) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "l1.w": (rng.standard_normal((784, hidden)) * 0.05).astype(np.float32),
        "l1.b": np.zeros(hidden, np.float32),
        "l2.w": (rng.standard_normal((hidden, 10)) * 0.05).astype(np.float32),
        "l2.b": np.zeros(10, np.float32),
    }


def random_cnn_weights(seed=0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "c1.w": (rng.standard_normal((8, 1, 3, 3)) * 0.2).astype(np.float32),
        "c1.b": np.zeros(8, np.float32),
        "c2.w": (rng.standard_normal((16, 8, 3, 3)) * 0.1).astype(np.float32),
        "c2.b": np.zeros(16, np.float32),
        "fc.w": (rng.standard_normal((16 * 7 * 7, 10)) * 0.05).astype(np.float32),
        "fc.b": np.zeros(10, np.float32),
    }


def load(arch: str = "cnn", weights=None, quantize: Optional[str] = None,
         options: Optional[ModelOptions] = None, device=None) -> Model:
    """A runnable MNIST ``Model``: ``arch`` 'mlp' or 'cnn', ``weights`` or
    random ones from seed 0, ``quantize`` None or 'int8' (dynamic). Runs on
    the card unless ``device`` says otherwise."""
    if arch == "mlp":
        graph = build_mlp(weights or random_mlp_weights())
    elif arch == "cnn":
        graph = build_cnn(weights or random_cnn_weights())
    else:
        raise ValueError(arch)
    if quantize == "int8":
        quantize_dynamic(graph)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize}")
    return Model(graph, options or ModelOptions(), device=device)
