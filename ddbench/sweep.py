"""Find the highest constant rate a fixed pool sustains (the knee), once.

    python3 ddbench/sweep.py --config sdss_elastic --traffic l30.sine \
        --rates 600,640,680,720,760,800 --seconds 10 --seed 1

Runs the configuration with its provisioner off and the pool fixed at the
provisioner's largest size, under open-loop arrivals at each constant rate,
with the traffic mix's locality and warm-up, all in one process.  For each
rate it prints one JSON line: the requests offered, completed, their
latency quantiles from the due time, the median latency of the last tenth
of them (a growing backlog shows there), and how long the pool took to
drain past the last arrival.  A rate is sustained where the last tenth's
median latency stays under ``SUSTAINED_S``; the knee is the highest rate
sustained with every lower rate swept.  A last line gives the knee and the
sine that follows from it: peak = min(770/s, 4/5 of the knee), amplitude =
0.949 x mean (phase 11 of chip_smoke.py).  The chosen numbers go into the
traffic file by hand; the benchmark's runs never sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_PROC0 = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
#: a rate is sustained where the last tenth of its requests waits a median
#: under this (s): the service time, 42 ms and the coadd, with room
SUSTAINED_S = 0.1
PEAK_CAP, PEAK_SHARE, AMPLITUDE_RATIO = 770.0, 0.8, 0.949


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from ddbench import arith, harness, registry

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark(held=True)
    cfg = registry.config(bench, args.config)
    pool = cfg["provisioner"]["max_executors"]
    cfg = dict(cfg, provisioner=None, executors=pool, pool_min=pool,
               pool_max=pool)
    base = registry.traffic(args.traffic)
    ref = registry.reference(cfg["reference"])
    sustained = []
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(base, arrivals={"kind": "constant", "rate_per_s": rate},
                   duration_s=args.seconds)
        run = harness.run_cell(f"sweep.{rate:g}", cfg, mix, ref, args.seed,
                               args.seconds, False, T_PROC0)
        lat = arith.latencies_from_due(run.due, run.done_at)
        order = sorted(run.due, key=run.due.get)
        tail = [run.done_at[t] - run.due[t] for t in order[-len(order) // 10:]
                if t in run.done_at]
        done = sum(1 for t in run.due if t in run.done_at)
        last_ms = arith.quantile(tail, 0.5) * 1e3
        if done == len(run.due) and last_ms < SUSTAINED_S * 1e3:
            sustained.append(rate)
        print(json.dumps({
            "rate_per_s": rate, "offered": len(run.due), "completed": done,
            "p50_ms": arith.quantile(lat, 0.5) * 1e3,
            "p95_ms": arith.quantile(lat, 0.95) * 1e3,
            "last_tenth_p50_ms": last_ms,
            "drain_past_last_arrival_s": run.drain_s - max(
                run.due[t] for t in order) + run.t_open,
            "card": harness.card_name(harness.resolve("cuda"))}),
            flush=True)
    # the knee: the highest rate that, with every lower rate swept, was
    # sustained (one lucky run above a failed one does not count)
    rates = sorted(float(r) for r in args.rates.split(","))
    ok = [r for i, r in enumerate(rates)
          if set(rates[:i + 1]) <= set(sustained)]
    if ok:
        knee = max(ok)
        peak = min(PEAK_CAP, PEAK_SHARE * knee)
        mean = peak / (1.0 + AMPLITUDE_RATIO)
        print(json.dumps({"knee_per_s": knee, "peak_per_s": peak,
                          "mean_per_s": mean,
                          "amplitude_per_s": AMPLITUDE_RATIO * mean}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
