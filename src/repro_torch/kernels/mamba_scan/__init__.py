"""Mamba-1 selective scan (forward): the hand-written CUDA kernel, its
wrapper, its plain PyTorch version and the op the model calls."""
