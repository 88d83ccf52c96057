"""Model file formats: ONNX protobuf parsing and external tensor data (a
copy of ``rten_tpu/formats``, numpy only).

The reference implements its own streaming protobuf parser rather than
depending on protoc-generated code (rten-onnx/src/onnx.rs); this package
does the same in Python (the `onnx` pip package is not a dependency).
"""

from .onnx import ModelProto, parse_model, tensor_to_numpy  # noqa: F401
