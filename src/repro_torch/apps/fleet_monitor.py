"""Live fleet telemetry end to end: attach, overload, reconcile.

The port of ``examples/fleet_monitor.py``: the same walk, flags and
printed lines, plus ``--device`` (default ``cuda``; ``cpu`` only when
asked).  Each host's executor caches hold every input as a ``uint8``
tensor of the object's bytes on ``--device``.  The walk (DESIGN.md §13)
on a real 4-host fleet:

  1. start a fleet run with the metrics plane ON and a `TelemetryServer`
     bound to a local port -- the same endpoint ``tools/monitor.py
     --attach`` uses -- and print the attach command so you can watch the
     full dashboard in a second terminal;
  2. drive it with a deliberately overloaded Poisson arrival stream --
     tasks run ``io_dwell_task`` (service time = input bytes at the
     simulated per-node disk rate), and arrivals come in at ~5x the
     pool's aggregate service capacity -- polling the endpoint while the
     run is live and printing per-host queue depth / cache bytes /
     aggregate bandwidth as they move;
  3. the backlog builds monotonically, so the `HealthMonitor`'s
     ``backlog_growth`` rule MUST fire -- the script exits nonzero if it
     does not;
  4. after the drain, reconcile ``RunReport.telemetry`` against the run
     ledger: summed per-host ``bw.*`` gauges == ``bytes_by_kind`` exactly,
     central completion counter == ``n_completed``, summed per-host
     ``host.tasks_done`` == ``n_completed``.

  PYTHONPATH=src python -m repro_torch.apps.fleet_monitor
  PYTHONPATH=src python -m repro_torch.apps.fleet_monitor --device cpu
  PYTHONPATH=src python -m repro_torch.apps.fleet_monitor --hosts 2 --tasks 150

Spawned hosts re-import this module as ``__mp_main__``: its top level
only defines things.
"""
from __future__ import annotations

import argparse
import sys
import threading

import torch

from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ObserveSpec, RuntimeEngine,
                                     WorkloadSpec)
from repro_torch.fleet.runtime import BENCH_DISK_BW
from repro_torch.obs import fetch_telemetry

OBJECT_BYTES = 400_000
INPUTS_PER_TASK = 2


def build_spec(hosts: int, tasks: int, rate: float) -> ExperimentSpec:
    return ExperimentSpec(
        name="fleet-monitor-demo",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=hosts),
        cache=CacheSpec(capacity_bytes=10**12),
        policy="max-compute-util",
        workload=WorkloadSpec(
            name="overload",
            arrivals={"kind": "PoissonArrivals", "rate_per_s": rate},
            popularity={"kind": "ZipfPopularity", "alpha": 1.1,
                        "k": INPUTS_PER_TASK, "corr": 0.8},
            n_tasks=tasks, n_objects=48, object_bytes=OBJECT_BYTES,
            seed=11),
        observe=ObserveSpec(metrics=True, metrics_interval_s=0.05,
                            metrics_port=0),       # 0 = any free port
        seed=3, hosts=hosts, threads_per_host=1)


def live_line(port: int) -> str:
    """One compact monitor line from the status endpoint (the full-screen
    version of this is ``tools/monitor.py --attach``)."""
    rec = fetch_telemetry("127.0.0.1", port)
    sample = rec.get("sample") or {}
    central = sample.get("metrics", {})
    g = central.get("gauges", {})
    hosts = sample.get("hosts", {})
    cache = {h: int(d["metrics"].get("gauges", {}).get("cache.bytes", 0))
             for h, d in sorted(hosts.items())}
    bw = sum(d["metrics"].get("gauges", {}).get(k, 0)
             for d in hosts.values()
             for k in ("bw.bytes_local", "bw.bytes_c2c", "bw.bytes_store"))
    per_host = " ".join(f"{h}:{b // 1000}kB" for h, b in cache.items())
    return (f"t={sample.get('t', 0):6.2f}s  "
            f"queue={int(g.get('sched.queue_depth', 0)):4d}  "
            f"pool={int(g.get('pool.size', 0))}  "
            f"cache[{per_host}]  bw={bw / 1e6:.1f}MB  "
            f"health={len(rec.get('health', []))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--tasks", type=int, default=300)
    ap.add_argument("--rate", type=float, default=400.0,
                    help="Poisson arrival rate (tasks/s); default ~5x the "
                         "pool's service capacity, so the backlog grows")
    ap.add_argument("--poll-s", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="where every host's executor caches live (cuda, "
                         "or cpu)")
    args = ap.parse_args(argv)

    spec = build_spec(args.hosts, args.tasks, args.rate)
    eng = RuntimeEngine(
        task_fn_name="repro_torch.fleet.runtime:io_dwell_task",
        device=args.device)
    eng.prepare(spec)
    port = eng.tel_server.port
    service_s = INPUTS_PER_TASK * OBJECT_BYTES / BENCH_DISK_BW
    print(f"== fleet monitor demo: {args.hosts} hosts x 1 thread, "
          f"{args.tasks} tasks at {args.rate:.0f}/s "
          f"(capacity ~{args.hosts / service_s:.0f}/s) ==")
    print(f"attach the dashboard:  PYTHONPATH=src python tools/monitor.py "
          f"--attach 127.0.0.1:{port}\n")

    stop = threading.Event()

    def poll() -> None:
        while not stop.wait(args.poll_s):
            try:
                print("  " + live_line(port))
            except OSError:
                return

    watcher = threading.Thread(target=poll, daemon=True, name="demo-poller")
    watcher.start()
    try:
        rep = eng.run(time_scale=1.0, timeout=300.0,
                      payload_factory=lambda ob: torch.full(
                          (ob.size_bytes,), ord("x"), dtype=torch.uint8))
    finally:
        stop.set()
        watcher.join(timeout=5.0)
        eng.shutdown()

    tel = rep.telemetry
    events = tel.get("health_events", [])
    fired = sorted({e["rule"] for e in events})
    print(f"\ncompleted {rep.n_completed}/{args.tasks} in "
          f"{rep.makespan_s:.2f}s; {tel.get('n_samples', 0)} samples; "
          f"health events: {fired or 'none'}")

    # -- reconcile the telemetry plane against the run ledger -------------
    merged = tel.get("merged", {})
    g, c = merged.get("gauges", {}), merged.get("counters", {})
    checks = [
        ("backlog_growth health event fired", "backlog_growth" in fired),
        ("bw.bytes_local == ledger local",
         g.get("bw.bytes_local", -1) == rep.bytes_by_kind.get("local", 0)),
        ("bw.bytes_c2c == ledger c2c",
         g.get("bw.bytes_c2c", -1) == rep.bytes_by_kind.get("c2c", 0)),
        ("bw.bytes_store == ledger store_read",
         g.get("bw.bytes_store", -1)
         == rep.bytes_by_kind.get("store_read", 0)),
        ("central sched.tasks_completed == n_completed",
         c.get("sched.tasks_completed", -1) == rep.n_completed),
        ("sum per-host host.tasks_done == n_completed",
         sum(h.get("metrics", {}).get("gauges", {}).get("host.tasks_done", 0)
             for h in tel.get("hosts", {}).values()) == rep.n_completed),
        (f"all {args.hosts} hosts reported stats frames",
         len(tel.get("hosts", {})) == args.hosts),
    ]
    ok = True
    for label, passed in checks:
        print(f"  [{'ok' if passed else 'FAIL'}] {label}")
        ok = ok and passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
