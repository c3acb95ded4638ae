"""The torch.fx frontend of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/torch``). As an attribute of ``flexflow_tpu_torch`` this
name is the subpackage, not PyTorch."""

from flexflow_tpu_torch.torch.model import (IRNode, PyTorchModel, file_to_ff,
                                            ir_to_ff)

__all__ = ["IRNode", "PyTorchModel", "file_to_ff", "ir_to_ff"]
