"""ServeDiffusionEngine: serving as a third Engine-protocol adapter.

A deliberate near-alias of RuntimeEngine: the WHOLE claim of DESIGN.md §12
is that serving needs no new scheduling machinery -- replica == executor,
request == task, KV page == cached object -- so the adapter contributes
exactly (a) the serve-legality checks and (b) the name.  Everything else
(`_dispatch_mcu` scoring over prefix pages, ShardedIndex/LocationIndex
coherence, peer KV fetch accounting, DRP replica autoscaling, obs
lifecycle events, the 35-field report) is the inherited runtime path,
executing a `WorkloadSpec.sessions` workload.  ``build_report`` tags the
result with ``self.name``, so reports come out ``engine="serve"`` and
``RunReport.diff`` against sim/runtime reports works field-by-field.

Per-input accounting IS the KV ledger: a local hit = the replica already
holds the prefix page, a peer hit = KV fetched from another replica
(bytes_c2c), a store read = prefill recompute (bytes_store).  kvmetrics
turns one report into the serving headline numbers.

Counterpart of ``repro.serve.diffusion.engine``.  Like `RuntimeEngine` it
takes ``device`` (default ``"cuda"``): with a ``payload_factory`` that
makes page tensors, each replica's cache holds its pages on that device.
On one card a page another replica caches is the same tensor (the runtime
keeps a tensor already on the device by reference), so a peer fetch
counts ``bytes_c2c`` in the ledger but copies nothing.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.experiments.engines import RuntimeEngine
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.workloads import Workload

from .binding import check_serve_spec


class ServeDiffusionEngine(RuntimeEngine):
    """`make_engine("serve")` -- registered via LAZY_ENGINES."""

    name = "serve"

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None
                ) -> "ServeDiffusionEngine":
        check_serve_spec(spec)
        super().prepare(spec, workload)
        return self

    def _engine_gauges(self) -> None:
        """Telemetry hook (DESIGN.md §13): the KV-reuse byte split.  Reused
        KV = prefix pages served from cache (local or peer); prefill =
        bytes recomputed from the store.  Same ledger the report's
        kvmetrics read, sampled live."""
        m = self.runtime.metrics
        if m is None:
            return
        led = self.runtime.ledger
        with led.lock:
            reused = led.bytes_local + led.bytes_c2c
            prefill = led.bytes_store
        m.gauge_set("serve.kv_reused_bytes", reused)
        m.gauge_set("serve.kv_prefill_bytes", prefill)
