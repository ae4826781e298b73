"""Where the flat stacking run's time goes on the card.

    PYTHONPATH=src python -m repro_torch.apps.flat_breakdown [--tasks N]
        [--json PATH]

Runs the flat StackingTrace path of ``chip_smoke.py`` (locality 10, 1 GiB
caches on the card, ``time_scale=0``) several ways through RuntimeEngine,
with the catalog put in the store before each run, and prints one line for
each:

  shape-only   no task function and no payloads: the dispatcher and the
               executor threads alone
  copy-only    payloads on the card and a task function that launches
               nothing: adds the store reads (one host-to-device copy each)
               and the caches' device tensors
  full         ``stack_object``, as chip_smoke.py's phase 3 runs it
  full/8       ``stack_object`` on 8 executors instead of 64
  full/0.5ms   ``stack_object`` with the interpreter's thread switch
               interval at 0.5 ms instead of 5 ms
  profiled     ``stack_object`` under ``torch.profiler``: the card's busy
               share of the run's wall time, and its time by kernel

and then ``task alone``: ``stack_object`` called back to back on one thread
with inputs already on the card -- the host's time per task, and (under the
profiler) the card's.  Needs a CUDA card.  With ``--json PATH`` it also
writes every number to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from repro_torch.apps import astro
from repro_torch.experiments import RuntimeEngine, build_workload

LOCALITY = 10
HOSTS = 64


def _first_input(inputs):
    """A task function that launches nothing: returns its first input."""
    return next(iter(inputs.values()))


def _device_time(prof) -> tuple[float, dict[str, list[float]]]:
    """Seconds the card was busy in a profile (the union of its kernel and
    copy intervals), and (count, seconds) by device event name."""
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name][0] += 1
        by_name[e.name][1] += (end - start) * 1e-6
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy * 1e-6, dict(by_name)


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def run_once(label: str, n_tasks: int, hosts: int, catalog: dict, task_fn,
             profile: bool = False) -> dict:
    spec = astro.flat_spec(n_tasks, LOCALITY, hosts)
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        if task_fn is not None:
            for ob in eng.workload.objects:
                eng.runtime.put_object(ob, catalog[ob.oid])
        torch.cuda.synchronize()
        if profile:
            with _profiler() as prof:
                rep = eng.run(task_fn=task_fn, time_scale=0.0, timeout=900.0)
                torch.cuda.synchronize()
        else:
            rep = eng.run(task_fn=task_fn, time_scale=0.0, timeout=900.0)
            torch.cuda.synchronize()
    finally:
        eng.shutdown()
    if rep.n_completed != n_tasks or rep.n_failed:
        raise RuntimeError(f"{label}: completed {rep.n_completed}/{n_tasks}")
    row = {"run": label, "executors": hosts, "tasks": n_tasks,
           "wall_s": rep.wall_s, "busy_span_s": rep.busy_span_s,
           "tasks_per_second": rep.tasks_per_second,
           "cache_hit_ratio": rep.cache_hit_ratio,
           "lock_hold_s": rep.dispatch_stats["lock_hold_s"],
           "pump_calls": rep.dispatch_stats["pump_calls"]}
    text = (f"[{label}] {hosts} executors, {n_tasks} tasks: "
            f"{rep.tasks_per_second:.1f} tasks/s over {rep.busy_span_s:.2f}s "
            f"| hit ratio {rep.cache_hit_ratio:.4f} | runtime lock held "
            f"{rep.dispatch_stats['lock_hold_s']:.2f}s over "
            f"{rep.dispatch_stats['pump_calls']} pumps")
    if profile:
        busy, by_name = _device_time(prof)
        row["device_busy_s"] = busy
        row["device_busy_share"] = busy / rep.wall_s
        row["device_by_name"] = by_name
        text += (f" | card busy {busy:.3f}s = {busy / rep.wall_s:.2%} of "
                 f"the wall time")
    print(text, flush=True)
    return row


def task_alone(catalog: dict, n_calls: int = 2000) -> dict:
    """``stack_object`` back to back on one thread, inputs on the card."""
    oids = sorted(catalog)[:200]
    dev = torch.device("cuda", torch.cuda.current_device())
    tiles = {oid: torch.from_numpy(catalog[oid]).to(dev) for oid in oids}
    calls = [{oid: tiles[oid]} for oid in oids]
    for c in calls[:50]:
        astro.stack_object(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_calls):
        astro.stack_object(calls[i % len(calls)])
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / n_calls
    with _profiler() as prof:
        for i in range(n_calls):
            astro.stack_object(calls[i % len(calls)])
        torch.cuda.synchronize()
    busy, by_name = _device_time(prof)
    row = {"run": "task alone", "calls": n_calls, "host_s_per_task": host_s,
           "device_s_per_task": busy / n_calls, "device_by_name": by_name}
    print(f"[task alone] {n_calls} calls on one thread: host "
          f"{host_s * 1e6:.1f} us per task, card busy "
          f"{busy / n_calls * 1e6:.2f} us per task", flush=True)
    for name, (count, secs) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1]):
        print(f"[task alone]   {count / n_calls:.0f} x {name[:70]}: "
              f"{secs / count * 1e6:.2f} us each", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=11_620,
                    help="flat tasks per run (locality 10, so tasks / 10 "
                         "files); chip_smoke.py runs 46,480")
    ap.add_argument("--json", default=None,
                    help="also write every number to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flat_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[env] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | switch interval {sys.getswitchinterval() * 1e3:.1f} ms",
          flush=True)
    n = args.tasks
    wl = build_workload(astro.flat_spec(n, LOCALITY, HOSTS).workload)
    catalog = {ob.oid: astro.make_tiles(ob) for ob in wl.objects}
    rows = [
        run_once("shape-only", n, HOSTS, catalog, None),
        run_once("copy-only", n, HOSTS, catalog, _first_input),
        run_once("full", n, HOSTS, catalog, astro.stack_object),
        run_once("full/8", n, 8, catalog, astro.stack_object),
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        rows.append(run_once("full/0.5ms", n, HOSTS, catalog,
                             astro.stack_object))
    finally:
        sys.setswitchinterval(interval)
    rows.append(run_once("profiled", n, HOSTS, catalog, astro.stack_object,
                         profile=True))
    rows.append(task_alone(catalog))
    if args.json is not None:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
