"""Flash attention (forward): the hand-written CUDA kernel, its wrapper,
its plain PyTorch version and the op in the model's layout."""
