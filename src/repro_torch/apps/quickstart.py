"""Quickstart: data diffusion in 60 seconds, through the port's experiment API.

Counterpart of ``examples/quickstart.py``'s first three stanzas, printing
the same lines: each run is one declarative :class:`ExperimentSpec`
executed by the discrete-event engine (``engine="sim"``), three times:

  1. data-UNAWARE (first-available): every byte comes from persistent storage;
  2. data-AWARE (max-compute-util): bytes diffuse into executor caches and
     tasks follow them;
  3. ELASTIC: the same diffusion engine under an open-loop sine-wave demand
     curve, with the DynamicResourceProvisioner growing and shrinking the
     pool as arrivals rise and fall (the paper's §3.1 elasticity story).

The simulator runs on the host (it moves byte counts, not tensors), so
this needs no card.  Everything is seeded, so the printed numbers are
identical run-to-run and equal to the reference's.  The reference's fourth
stanza (lifecycle recording and its Chrome trace) is not part of this
package.

  PYTHONPATH=src python -m repro_torch.apps.quickstart
"""
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ProvisionerSpec, WorkloadSpec,
                                     build_workload, run_experiment)

MB = 10**6
N_NODES = 16
LOCALITY = 10          # each file accessed 10x (Table 2's knob)
SEED = 0

#: closed-loop batch: 80 files x locality 10 = 800 tasks, all arriving at t=0
BATCH_WORKLOAD = WorkloadSpec(
    name="quickstart",
    arrivals={"kind": "BatchArrivals", "at_s": 0.0},
    popularity={"kind": "UniformScan", "stride": 1, "k": 1},
    n_tasks=80 * LOCALITY, n_objects=80, object_bytes=20 * MB,
    object_prefix="f", compute_seconds=0.05, seed=SEED)


def batch_spec(policy: str, caching: bool) -> ExperimentSpec:
    return ExperimentSpec(
        name="quickstart",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=N_NODES),
        cache=CacheSpec(capacity_bytes=50 * 10**9, enabled=caching),
        policy=policy,
        workload=BATCH_WORKLOAD,
        seed=SEED)


#: open-loop sine-wave demand over the same 80-file catalog
ELASTIC = ExperimentSpec(
    name="quickstart-elastic",
    cluster=ClusterSpec(testbed="anl_uc", n_nodes=1),
    cache=CacheSpec(capacity_bytes=50 * 10**9),
    policy="max-compute-util",
    provisioner=ProvisionerSpec(
        policy="exponential", min_executors=1, max_executors=N_NODES,
        queue_threshold=2, idle_timeout_s=4.0, trigger_cooldown_s=1.0),
    workload=WorkloadSpec(
        name="sine",
        arrivals={"kind": "SineWaveArrivals", "mean_rate": 8.0,
                  "amplitude": 7.5, "period_s": 60.0, "phase": 0.0},
        popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1,
                    "corr": 1.0},
        n_tasks=600, n_objects=80, object_bytes=20 * MB, object_prefix="f",
        compute_seconds=0.5, seed=SEED),
    seed=SEED)


def main() -> int:
    print(f"workload: 80 x 20MB files, locality {LOCALITY}, "
          f"{N_NODES} nodes (ANL/UC testbed model)\n")
    batch = build_workload(BATCH_WORKLOAD)   # generated once, run twice
    for name, policy, caching in (
            ("first-available (data-unaware, no caches)",
             "first-available", False),
            ("max-compute-util (data diffusion)",
             "max-compute-util", True)):
        r = run_experiment(batch_spec(policy, caching), engine="sim",
                           workload=batch)
        gb = {k: v / 1e9 for k, v in r.bytes_by_kind.items()}
        print(f"== {name}")
        print(f"   makespan            {r.t_last_complete:9.1f} s")
        print(f"   read throughput     {r.read_bandwidth_bps * 8 / 1e9:9.2f} Gb/s")
        print(f"   cache hit ratio     {r.cache_hit_ratio:9.2%}"
              f"   (ideal {1 - 1 / LOCALITY:.0%})")
        print(f"   bytes from store    {gb.get('store_read', 0):9.2f} GB")
        print(f"   bytes cache-to-cache{gb.get('c2c', 0):9.2f} GB")
        print(f"   bytes local         {gb.get('local', 0):9.2f} GB\n")
    print("the diffusion run reads the store once per file and serves the "
          "other 9 accesses from executor caches -- the paper's Figure 11/13 "
          "economics in miniature.\n")

    m = run_experiment(ELASTIC, engine="sim")
    print("== elastic (sine-wave arrivals + dynamic resource provisioner)")
    print(f"   tasks completed     {m.n_completed:9d}")
    print(f"   pool               {m.low_executors:4d} -> {m.peak_executors:d} "
          f"executors (allocated {m.n_allocated}, "
          f"released {m.n_released})")
    print(f"   cache hit ratio     {m.cache_hit_ratio:9.2%}")
    print(f"   avg slowdown        {m.avg_slowdown:9.2f}x")
    print(f"   performance index   {m.performance_index:9.3f}   "
          f"(ideal core-s / allocated core-s)")
    print("\nas demand rises the provisioner acquires executors; when the "
          "sine trough drains the queue, idle executors are released -- "
          "the elasticity the paper claims, measured end-to-end.\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
