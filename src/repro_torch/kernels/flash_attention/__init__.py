"""Flash attention (forward): the hand-written CUDA kernels, their wrapper,
the plain PyTorch version they are held to and the op in the model's
layout."""
