"""Graph-building core of the PyTorch/CUDA port: tensors, layers,
initializers and the inference half of ``FFModel``."""
