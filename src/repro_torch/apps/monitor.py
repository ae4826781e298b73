"""Terminal fleet monitor: live view of a run's telemetry plane.

The port of ``tools/monitor.py``: the same flags and frames, reading the
port's telemetry (``repro_torch.obs.metrics``), whose wire and sink
formats are the reference's.

Two attachment modes (DESIGN.md §13):

  --attach HOST:PORT   poll a running engine's `TelemetryServer` (one JSON
                       line per poll; read-only, cannot perturb the run
                       beyond a registry snapshot)
  --tail PATH          follow a `Telemetry` JSONL sink (works live -- the
                       sink flushes per sample -- or post-mortem)

Either way the dashboard shows the central dispatcher view (queue depth,
pool size, pump/dispatch counters), a per-host table (age of the last
stats frame, cache bytes, delivered cache bandwidth derived from
successive cumulative byte gauges, tasks done), the cluster-wide
aggregate, and the health-event tail.

Examples:
  PYTHONPATH=src python -m repro_torch.apps.monitor --attach 127.0.0.1:7771
  PYTHONPATH=src python -m repro_torch.apps.monitor --tail run.metrics.jsonl
  PYTHONPATH=src python -m repro_torch.apps.monitor --tail run.metrics.jsonl \
      --once
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.obs.metrics import (METRICS_SCHEMA_VERSION,
                                     fetch_telemetry, merge_snapshots)

_CLEAR = "\x1b[2J\x1b[H"


def _mb(n: float) -> str:
    return f"{n / 1e6:10.1f}"


def _rate(prev: dict | None, cur: dict, dt: float, *names: str) -> float:
    """Delivered bytes/s between two samples of cumulative byte gauges."""
    if prev is None or dt <= 0:
        return 0.0
    pg, cg = prev.get("gauges", {}), cur.get("gauges", {})
    d = sum(cg.get(n, 0) - pg.get(n, 0) for n in names)
    return max(d, 0) / dt


def render(sample: dict, health: list[dict],
           prev: dict | None = None) -> str:
    """One dashboard frame from a telemetry sample (and the previous one,
    for bandwidth rates).  Pure string-building, so tests can pin it."""
    out: list[str] = []
    t = sample.get("t", 0.0)
    central = sample.get("metrics", {})
    c, g = central.get("counters", {}), central.get("gauges", {})
    hosts = sample.get("hosts", {})
    out.append(f"== data-diffusion monitor ==  t={t:.2f}s  "
               f"hosts={len(hosts)}")
    out.append(f"  queue={g.get('sched.queue_depth', 0):>6}  "
               f"pool={g.get('pool.size', 0):>4}  "
               f"submitted={c.get('sched.tasks_submitted', 0):>7}  "
               f"completed={c.get('sched.tasks_completed', 0):>7}  "
               f"failed={c.get('sched.tasks_failed', 0)}")
    out.append(f"  pumps={c.get('sched.pump_calls', 0):>7}  "
               f"dispatches={c.get('sched.dispatches', 0):>7}  "
               f"leases={c.get('wire.leases', 0)}  "
               f"claims={c.get('wire.claims', 0)}  "
               f"conflicts={c.get('wire.claim_conflicts', 0)}")
    if hosts:
        prev_hosts = (prev or {}).get("hosts", {})
        dt = t - (prev or {}).get("t", t)
        out.append("")
        out.append("  host     age_s   cache_MB    tasks   bw_MB/s "
                   "(local+c2c+store)")
        agg = {"counters": {}, "gauges": {}, "histograms": {}}
        agg_bw = 0.0
        for h in sorted(hosts):
            snap = hosts[h].get("metrics", {})
            hg = snap.get("gauges", {})
            pv = prev_hosts.get(h, {}).get("metrics")
            bw = _rate(pv, snap, dt, "bw.bytes_local", "bw.bytes_c2c",
                       "bw.bytes_store")
            agg_bw += bw
            agg = merge_snapshots(agg, snap)
            out.append(f"  {h:<7}{hosts[h].get('age_s', 0.0):>7.2f} "
                       f"{_mb(hg.get('cache.bytes', 0))} "
                       f"{int(hg.get('host.tasks_done', 0)):>8} "
                       f"{bw / 1e6:>9.1f}")
        ag = agg.get("gauges", {})
        out.append(f"  TOTAL          {_mb(ag.get('cache.bytes', 0))} "
                   f"{int(ag.get('host.tasks_done', 0)):>8} "
                   f"{agg_bw / 1e6:>9.1f}")
    else:
        # single-process runs: central gauges carry the cache/bw totals
        bw = _rate((prev or {}).get("metrics"), central,
                   t - (prev or {}).get("t", t),
                   "bw.bytes_local", "bw.bytes_c2c", "bw.bytes_store")
        out.append(f"  cache_MB={g.get('cache.bytes', 0) / 1e6:.1f}  "
                   f"hits={g.get('cache.hits', 0)}  "
                   f"misses={g.get('cache.misses', 0)}  "
                   f"bw_MB/s={bw / 1e6:.1f}")
    if health:
        out.append("")
        out.append("  health (last {}):".format(min(len(health), 5)))
        for ev in health[-5:]:
            out.append(f"    [{ev.get('severity', '?'):>7}] "
                       f"t={ev.get('t', 0.0):.2f} {ev.get('rule', '?')} "
                       f"host={ev.get('host') or '-'} "
                       f"{ev.get('detail', '')}")
    return "\n".join(out)


def _attach_loop(addr: str, interval: float, once: bool) -> int:
    host, _, port = addr.rpartition(":")
    prev = None
    while True:
        try:
            rec = fetch_telemetry(host or "127.0.0.1", int(port))
        except OSError as e:
            print(f"monitor: cannot reach {addr}: {e}", file=sys.stderr)
            return 1
        sample = rec.get("sample")
        if sample is None:
            frame = "== data-diffusion monitor ==  (no samples yet)"
        else:
            frame = render(sample, rec.get("health", []), prev)
            prev = sample
        if once:
            print(frame)
            return 0
        print(_CLEAR + frame, flush=True)
        time.sleep(interval)


def _tail_loop(path: str, interval: float, once: bool) -> int:
    """Follow a metrics sink.  Tolerates a file that is still being
    written: incomplete trailing lines are retried on the next poll."""
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("kind") != "metrics_header" \
                or header.get("schema_version") != METRICS_SCHEMA_VERSION:
            print(f"monitor: {path} is not a v{METRICS_SCHEMA_VERSION} "
                  f"metrics sink", file=sys.stderr)
            return 1
        prev = sample = None
        health: list[dict] = []
        buf = ""
        while True:
            buf += f.read()
            *lines, buf = buf.split("\n")
            for line in lines:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "metrics":
                    prev, sample = sample, rec
                elif rec.get("kind") == "health":
                    health.append(rec)
            if sample is not None:
                frame = render(sample, health, prev)
            else:
                frame = "== data-diffusion monitor ==  (no samples yet)"
            if once:
                print(frame)
                return 0
            print(_CLEAR + frame, flush=True)
            time.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--attach", metavar="HOST:PORT",
                     help="poll a running engine's TelemetryServer")
    src.add_argument("--tail", metavar="PATH",
                     help="follow a Telemetry JSONL sink")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="redraw interval in seconds (default 0.5)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    args = ap.parse_args(argv)
    try:
        if args.attach:
            return _attach_loop(args.attach, args.interval, args.once)
        return _tail_loop(args.tail, args.interval, args.once)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
