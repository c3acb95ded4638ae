"""The ONNX frontend of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/onnx``)."""

from flexflow_tpu_torch.onnx.model import ONNXModel
from flexflow_tpu_torch.onnx.proto import OnnxGraph, load_model

__all__ = ["ONNXModel", "OnnxGraph", "load_model"]
