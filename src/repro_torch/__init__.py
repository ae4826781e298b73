"""PyTorch port of the data-diffusion system, for an NVIDIA H100.

A package beside the JAX reference ``repro`` (which it never imports): the
dispatcher, caches and threaded runtime with executor caches on the card
(``core``), workload generators and metrics (``workloads``), the experiment
API (``experiments``), the multi-process fleet (``fleet``: executors in
host processes that share the card, peer caches over sockets), the SDSS
stacking application (``apps.astro``) and its hand-written CUDA stacking
kernel (``kernels.stacking``).  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""
