"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel ships: ``csrc/<name>.cu`` (CUDA C++ for sm_90a with a plain C
entry point), ``<name>.py`` (the ctypes wrapper: checks, launch, launch
counter), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the public
op: a CUDA tensor launches the kernel, a CPU tensor takes the plain
version).  ``build.py`` compiles the sources with ``nvcc`` at first use.
"""
