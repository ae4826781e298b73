"""KV-cache diffusion on a 4-replica serving pool (DESIGN.md §12).

The port of ``examples/serve_sessions.py``: the same two runs, flags and
printed lines, plus ``--device`` (default ``cuda``; ``cpu`` only when
asked).  Both runs go over the same multi-turn chat population, each
through the REAL scheduling stack (the port's dispatcher, LocationIndex,
provisioner):

  serve   the serve engine -- replicas are live worker threads whose caches
          hold each KV page as a ``uint8`` tensor of the page's bytes on
          ``--device`` -- under batch-synchronous replay, so placement (and
          every number printed) is bit-deterministic run-to-run: later turns
          re-read their session's prefix pages and Zipf-shared system
          prompts from replica caches instead of recomputing prefill;
  sim     the SAME session model under diurnal demand on an elastic
          1..8 replica pool: the DynamicResourceProvisioner grows the
          pool at the daily peak and releases it in the trough -- the
          pool trajectory is the autoscaling story in one line.

Everything printed is scheduling-determined (byte counters, request
counts, sim-time pool samples), never wall clock, so the output is
identical on every run, on either device, and equal to the reference's.

  PYTHONPATH=src python -m repro_torch.apps.serve_sessions
  PYTHONPATH=src python -m repro_torch.apps.serve_sessions --device cpu
  PYTHONPATH=src python -m repro_torch.apps.serve_sessions --sessions 120 --days 3
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.core.objects import DataObject
from repro_torch.experiments import run_experiment
from repro_torch.experiments.spec import ProvisionerSpec
from repro_torch.serve.diffusion import (ServeDiffusionEngine, format_pool,
                                         kv_summary, session_spec)

SEED = 0
REPLICAS = 4


def kv_page(ob: DataObject) -> torch.Tensor:
    """A KV page's payload in the store: ``size_bytes`` of host memory (the
    serve engine copies it to a replica's device on a store read)."""
    return torch.zeros(ob.size_bytes, dtype=torch.uint8)


def serve_demo(n_sessions: int, turns: int, device: str) -> int:
    binding = {"kind": "chat", "n_sessions": n_sessions,
               "turns_per_session": turns, "n_system_prompts": 8,
               "kv_bytes_per_token": 1024, "block": 32,
               "think_time_s": 0.0, "turn_seconds": 0.0,
               "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}}
    eng = ServeDiffusionEngine(device=device)
    try:
        eng.prepare(session_spec("serve-demo", binding, n_replicas=REPLICAS,
                                 seed=SEED))
        rep = eng.run(payload_factory=kv_page, barrier_every=1, timeout=300)
    finally:
        eng.shutdown()
    s = kv_summary(rep)
    print(f"serve: {REPLICAS} replicas, {n_sessions} sessions x "
          f"{turns} turns = {rep.n_completed} requests "
          f"({rep.n_failed} failed)")
    print(f"  reused token fraction  {s['reused_token_fraction']:.3f} "
          f"({s['reused_kv_bytes'] / 1e6:.1f} MB reused, "
          f"{s['recomputed_kv_bytes'] / 1e6:.1f} MB recomputed prefill)")
    print(f"  reuse locality         {s['local_kv_bytes'] / 1e6:.1f} MB "
          f"local, {s['peer_kv_bytes'] / 1e6:.1f} MB fetched from peers")
    print(f"  requests by reuse      {s['full_reuse_requests']} full / "
          f"{s['partial_reuse_requests']} partial / "
          f"{s['cold_requests']} cold")
    return 0 if rep.n_failed == 0 else 1


def diurnal_demo(n_sessions: int, days: int) -> int:
    day_s = 60.0
    binding = {"kind": "chat", "n_sessions": n_sessions,
               "turns_per_session": 2, "kv_bytes_per_token": 1024,
               "block": 32, "think_time_s": 5.0, "turn_seconds": 1.0,
               "arrivals": {"kind": "DiurnalArrivals", "peak_rate": 8.0,
                            "trough_rate": 0.5, "day_s": day_s}}
    spec = session_spec(
        "serve-diurnal", binding, n_replicas=1, seed=SEED,
        provisioner=ProvisionerSpec(
            policy="exponential", min_executors=1, max_executors=8,
            queue_threshold=2, idle_timeout_s=5.0, trigger_cooldown_s=1.0))
    rep = run_experiment(spec, engine="sim")
    s = kv_summary(rep)
    print(f"sim:   diurnal demand over ~{days} compressed days "
          f"({rep.n_completed} requests, elastic 1..8 replicas)")
    print(f"  replicas allocated     +{rep.n_allocated} grown, "
          f"-{rep.n_released} released (peak {rep.peak_executors}, "
          f"trough {rep.low_executors})")
    print(f"  reused token fraction  {s['reused_token_fraction']:.3f}")
    print(f"  pool trajectory        {format_pool(rep, max_points=12)}")
    return 0 if rep.n_completed == rep.n_tasks else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sessions", type=int, default=80,
                    help="chat sessions per run")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session (serve run)")
    ap.add_argument("--days", type=int, default=2,
                    help="compressed diurnal days (sim run)")
    ap.add_argument("--device", default="cuda",
                    help="where the replicas' caches live: cuda (default) "
                         "or cpu")
    args = ap.parse_args(argv)
    rc = serve_demo(args.sessions, args.turns, args.device)
    # session count sized so the workload spans the requested day count at
    # the diurnal curve's mean rate ((peak + trough) / 2 ~ 4.25/s)
    rc = max(rc, diurnal_demo(int(args.days * 60.0 * 4.25), args.days))
    return rc


if __name__ == "__main__":
    sys.exit(main())
