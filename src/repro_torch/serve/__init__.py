"""Prefix-KV serving on the diffusion stack (counterpart of
``repro.serve``): content-addressed prefix pages (``kvcache``), the
prefix-aware router over the port's caches and policies (``router``), the
batched engine over the dense decoder (``engine``) and serving as an
experiment engine over the diffusion runtime (``diffusion``).

Layering note: ``kvcache`` and ``router`` hold no model and import
eagerly -- the workload layer's session generator builds prefix-chain oids
through them.  ``ServeEngine`` / ``Request`` / ``WaveRecord`` pull in the
model substrate, so they resolve lazily on first attribute access; the
``diffusion`` subpackage likewise loads only when imported, because it
imports ``repro_torch.experiments``, which imports
``repro_torch.workloads``, which imports this package's ``kvcache``.
"""
from .kvcache import kv_bytes_per_token, prefix_chain, prefix_oid
from .router import PrefixAwareRouter, RouteResult

__all__ = ["PrefixAwareRouter", "Request", "RouteResult", "ServeEngine",
           "WaveRecord", "kv_bytes_per_token", "prefix_chain", "prefix_oid"]

#: lazily resolved attribute -> defining submodule
_LAZY = {"Request": "engine", "ServeEngine": "engine", "WaveRecord": "engine"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value   # cache: __getattr__ runs once per name
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
