"""Replica==executor mapping + which spec knobs are serve-legal.

``SERVE_MAPPING`` is the DESIGN.md §12 table in data form (a test renders
it, so docs and code cannot drift): every serving concept and the existing
diffusion mechanism that implements it VERBATIM -- the point of the
subsystem is that nothing in `repro_torch.core` changed to make serving work.

``check_serve_spec`` is the dead-knob rule applied to the serve engine: a
knob the engine would silently ignore hard-errors instead.

A copy of the reference's ``repro.serve.diffusion.binding``.  This
package's spec has no fleet fields, so there is no ``hosts`` to refuse.
"""
from __future__ import annotations

from repro_torch.experiments.spec import (CacheSpec, ClusterSpec,
                                          ExperimentSpec, ObserveSpec,
                                          ProvisionerSpec, WorkloadSpec)

#: (serving concept, diffusion mechanism, where it lives in this package)
#: -- the reference's table (DESIGN.md §12) with its module paths in
#: ``repro_torch``; locked by tests/test_torch_serve_diffusion.py
SERVE_MAPPING: tuple[tuple[str, str, str], ...] = (
    ("model replica",
     "executor (1-slot worker thread)",
     "repro_torch.core.runtime.DiffusionRuntime"),
    ("inference request (one turn)",
     "Task with k prefix-page inputs (a correlated join)",
     "repro_torch.workloads.sessions.SessionModel"),
    ("prefix-KV page (block tokens)",
     "immutable content-addressed DataObject of block*kv_bpt bytes",
     "repro_torch.serve.kvcache.prefix_chain"),
    ("prefix-aware load balancing",
     "max-compute-util dispatch: cached-prefix bytes == overlap score",
     "repro_torch.core.scheduler._dispatch_mcu"),
    ("KV transfer from a peer replica",
     "peer cache fetch (bytes_c2c / peer_hits in the ledger)",
     "repro_torch.core.runtime peer fetch accounting"),
    ("prefill recompute (cache miss)",
     "store read (bytes_store / store_reads in the ledger)",
     "repro_torch.core.runtime.ObjectStore"),
    ("replica autoscaling under demand",
     "DynamicResourceProvisioner grow/shrink on queue + idle signals",
     "repro_torch.core.provisioner via engines._ProvisionerDriver"),
    ("cluster-wide KV page directory",
     "LocationIndex (loose coherence via index_update_batch)",
     "repro_torch.core.index"),
    ("request lifecycle telemetry",
     "obs lifecycle events -> Chrome trace / sim divergence diff",
     "repro_torch.obs (DESIGN.md §10)"),
)


def check_serve_spec(spec: ExperimentSpec) -> None:
    """Serve-legality: the serve engine is the threaded runtime with
    serving semantics, so it inherits every runtime reject (cpus_per_node,
    write_outputs_to, ...) from RuntimeEngine.prepare and adds its own."""
    if spec.workload.dag is not None:
        raise ValueError(
            "serve engine: workload.dag is not serve-legal -- serving "
            "requests are dep-free joins over prefix pages (bind "
            "workload.sessions, a trace, or a flat generator instead)")


def session_spec(name: str = "serve",
                 sessions: dict | None = None,
                 *,
                 n_replicas: int = 4,
                 policy: str = "max-compute-util",
                 replica_cache_bytes: int = 1 << 30,
                 provisioner: ProvisionerSpec | None = None,
                 observe: ObserveSpec | None = None,
                 seed: int = 0,
                 **spec_kw) -> ExperimentSpec:
    """An ExperimentSpec shaped for the serve engine: a sessions binding
    on an n_replicas single-slot pool.  One construction path shared by
    the example, the benches and the tests."""
    return ExperimentSpec(
        name=name,
        workload=WorkloadSpec(
            name=name,
            sessions=dict(sessions) if sessions else {"kind": "chat"}),
        cluster=ClusterSpec(n_nodes=n_replicas),
        cache=CacheSpec(capacity_bytes=replica_cache_bytes),
        policy=policy,
        provisioner=provisioner,
        observe=observe if observe is not None else ObserveSpec(),
        seed=seed,
        **spec_kw)
