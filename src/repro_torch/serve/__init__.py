"""Prefix-KV serving on the diffusion stack (counterpart of
``repro.serve``): content-addressed prefix pages (``kvcache``), the
prefix-aware router over the port's caches and policies (``router``) and
the batched engine over the dense decoder (``engine``).

Left out: the Engine-protocol adapter ``serve/diffusion`` and the session
workloads it drives (the sessions slice, ``ROADMAP.md``).
"""
from .engine import Request, ServeEngine, WaveRecord
from .kvcache import kv_bytes_per_token, prefix_chain, prefix_oid
from .router import PrefixAwareRouter, RouteResult

__all__ = ["PrefixAwareRouter", "Request", "RouteResult", "ServeEngine",
           "WaveRecord", "kv_bytes_per_token", "prefix_chain", "prefix_oid"]
