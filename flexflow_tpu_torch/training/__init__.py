"""Training of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/training``): losses, metrics, optimizers and the data
loader that ``FFModel.compile(optimizer=, loss_type=, metrics=)`` and its
train verbs use, and the checkpoints that save and resume a run
(``checkpoint.py``)."""
