"""Serving driven through the real scheduling stack (counterpart of
``repro.serve.diffusion``; DESIGN.md §12).

The third experiment engine: ``ExperimentSpec`` run with ``engine="serve"``
takes a multi-turn session workload (``WorkloadSpec.sessions``) end to end
through the UNCHANGED Dispatcher + DRP + obs machinery -- replica ==
executor, request == task, cached-prefix-KV bytes == the overlap score --
and emits the same RunReport as sim/runtime.  On the card each replica's
cache holds its KV pages as device tensors, so a store read is a real
host-to-device copy of a page and an eviction frees device memory.

  binding     replica==executor mapping table + serve-legality checks +
              the `session_spec` convenience constructor
  engine      ServeDiffusionEngine (RuntimeEngine subclass, name="serve")
  kvmetrics   RunReport -> KV-reuse economics (reused vs recomputed bytes,
              pool trajectory formatting)
  reference   regression lock: a Dispatcher twin predicts what the
              PrefixAwareRouter must choose

Import note: this package is resolved lazily by the experiment layer
(``LAZY_ENGINES``) because `engine` imports `repro_torch.experiments`,
which imports `repro_torch.workloads`, which imports
`repro_torch.serve.kvcache` -- eager registration would be a cycle.
"""
from .binding import SERVE_MAPPING, check_serve_spec, session_spec
from .engine import ServeDiffusionEngine
from .kvmetrics import format_pool, kv_summary, pool_trajectory
from .reference import dispatcher_prediction, verify_route

__all__ = [
    "SERVE_MAPPING",
    "ServeDiffusionEngine",
    "check_serve_spec",
    "dispatcher_prediction",
    "format_pool",
    "kv_summary",
    "pool_trajectory",
    "session_spec",
    "verify_route",
]
