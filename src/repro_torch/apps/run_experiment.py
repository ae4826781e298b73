"""Experiment CLI: describe / run / diff / sweep a declarative
ExperimentSpec JSON on any engine.

The port of ``tools/run_experiment.py``: the same subcommands, flags,
defaults, stdout JSON and stderr notes, plus ``--device`` for ``run`` and
``sweep`` (default ``cuda``; ``cpu`` only when asked), where the runtime
and serve engines keep their executor caches.  For those engines one
stderr line names the device the run resolved.  The simulator runs on the
host and takes no device.

Validate a spec and summarise what it would run:

    PYTHONPATH=src python -m repro_torch.apps.run_experiment describe spec.json

Execute it (the SAME spec file runs on every engine):

    PYTHONPATH=src python -m repro_torch.apps.run_experiment run spec.json \
        --engine sim
    PYTHONPATH=src python -m repro_torch.apps.run_experiment run spec.json \
        --engine runtime --time-scale 0 [--device cpu]

Sweep a cartesian grid over spec fields (seed-paired; writes
manifest.json + results.jsonl to --out-dir):

    PYTHONPATH=src python -m repro_torch.apps.run_experiment sweep spec.json \
        --set provisioner.policy=one-at-a-time,additive,exponential \
        --set 'cache.capacity_bytes=[0,50000000000]' \
        --seeds 0,1 --out-dir results/sweep

``--set path=v1,v2,...`` values are JSON-parsed individually (falling back
to strings); a value starting with ``[`` is parsed as one JSON list of cell
values, so whole dicts (e.g. arrival bindings) can be swept too.

An example spec document lives in the `repro_torch.experiments` module
docstring; ``describe`` round-trips the file through the strict parser, so
typos in field names hard-error instead of silently falling back to
defaults.  Without a ``payload_factory`` (the CLI passes none) every
object's payload is shape-only, so a runtime run moves byte counts, not
tensors, and launches no kernel.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.device import describe, resolve_device
from repro_torch.experiments import (ExperimentSpec, RunReport, Sweep,
                                     build_workload)

RUNTIME_ENGINES = ("runtime", "serve")


def _load_spec(path: str) -> ExperimentSpec:
    try:
        return ExperimentSpec.load(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"run_experiment: bad spec {path!r}: {e}")


def _device(args):
    """The device a runtime or serve run builds on, resolved and named on
    stderr (a card with its power limit).  Raises where CUDA is asked for
    and there is none.  The simulator takes no device: ``--device`` passes
    through unread."""
    if args.engine not in RUNTIME_ENGINES:
        return args.device
    dev = resolve_device(args.device)
    print(f"# device: {describe(dev)}", file=sys.stderr)
    return dev


def _warn_drops(rep: RunReport) -> None:
    """Surface recorder ring overflow: a lossy trace silently weakens every
    downstream consumer (diff replay, chrome export), so say so loudly."""
    dropped = rep.telemetry.get("recorder_dropped", 0)
    if dropped:
        print(f"# WARNING: recorder dropped {dropped} event(s) (ring full) "
              f"-- trace/divergence output is incomplete; raise "
              f"observe.ring_capacity", file=sys.stderr)


def _report_out(rep: RunReport, out: str | None, *, quiet_pool: bool = True):
    d = rep.as_dict()
    if out:
        Path(out).write_text(json.dumps(d, indent=2, sort_keys=True) + "\n")
        print(f"# wrote {out}", file=sys.stderr)
    if quiet_pool and len(d["pool_log"]) > 8:
        # keep stdout readable; the full membership log lives in --out
        d["pool_log"] = (d["pool_log"][:4]
                         + [f"... {len(rep.pool_log) - 4} more samples"])
    json.dump(d, sys.stdout, indent=2, sort_keys=True)
    print()


def cmd_describe(args) -> int:
    spec = _load_spec(args.spec)
    wl = build_workload(spec.workload)
    print(json.dumps({
        "spec": spec.to_dict(),
        "fingerprint": spec.fingerprint(),
        "workload": {
            "n_tasks": len(wl),
            "n_objects": len(wl.objects),
            "arrival_span_s": wl.duration,
            "offered_load_tps": wl.offered_load(),
            "mean_inputs_per_task": wl.mean_inputs_per_task(),
            "total_input_bytes": sum(ob.size_bytes for ob in wl.objects),
        },
    }, indent=2, sort_keys=True))
    return 0


def cmd_run(args) -> int:
    from repro_torch.experiments import RuntimeEngine, make_engine

    spec = _load_spec(args.spec)
    dev = _device(args)
    run_kw = {}
    if args.engine in RUNTIME_ENGINES:
        run_kw = {"time_scale": args.time_scale, "timeout": args.timeout,
                  "barrier_every": args.barrier_every}
    if args.engine == "runtime" and args.task_fn is not None:
        # fleet runs name their callable; hosts resolve module:attr
        eng = RuntimeEngine(task_fn_name=args.task_fn, device=dev)
    else:
        eng = make_engine(args.engine, device=dev)
    try:
        eng.prepare(spec)
        rep = eng.run(**run_kw)
        if args.trace_out:
            # arrivals + measured per-task outcomes, one file (trace v3):
            # the input to the `diff` subcommand's sim-twin replay
            from repro_torch.workloads import record_v3

            record_v3(eng.workload, args.trace_out, eng.last_outcomes)
            print(f"# wrote {args.trace_out} "
                  f"({len(eng.last_outcomes)} outcomes)", file=sys.stderr)
    finally:
        eng.shutdown()
    _warn_drops(rep)
    _report_out(rep, args.out)
    return 0


def cmd_diff(args) -> int:
    """sim<->real divergence: replay a v3 trace's arrival half through the
    sim twin of the spec, join predicted vs measured outcomes by task id."""
    import dataclasses

    from repro_torch.obs import (diff_outcomes, format_divergence,
                                 sim_replay_outcomes)
    from repro_torch.workloads import read_outcomes

    spec = _load_spec(args.spec)
    try:
        measured = read_outcomes(args.trace)
    except (OSError, ValueError) as e:
        raise SystemExit(f"run_experiment: bad trace {args.trace!r}: {e}")
    predicted = sim_replay_outcomes(spec, trace_path=args.trace)
    div = diff_outcomes(measured, predicted)
    if args.out:
        Path(args.out).write_text(json.dumps(div, indent=2, sort_keys=True)
                                  + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)
    if args.report:
        # attach the divergence to an existing report file in place
        # (RunReport.task_divergence is the programmatic surface)
        rep = RunReport.from_dict(json.loads(Path(args.report).read_text()))
        _warn_drops(rep)  # a lossy recording skews the divergence join too
        rep = dataclasses.replace(rep, task_divergence=div)
        Path(args.report).write_text(
            json.dumps(rep.as_dict(), indent=2, sort_keys=True) + "\n")
        print(f"# updated {args.report} (task_divergence)", file=sys.stderr)
    print(format_divergence(div))
    return 0


def _parse_set(items: list[str]) -> dict[str, list]:
    grid: dict[str, list] = {}
    for item in items:
        if "=" not in item:
            raise SystemExit(f"run_experiment: bad --set {item!r} "
                             f"(want path=v1,v2,...)")
        path, _, raw = item.partition("=")
        if raw.lstrip().startswith("["):
            try:
                values = json.loads(raw)
            except json.JSONDecodeError as e:
                raise SystemExit(f"run_experiment: bad --set JSON list "
                                 f"for {path!r}: {e}")
        else:
            values = []
            for tok in raw.split(","):
                try:
                    values.append(json.loads(tok))
                except json.JSONDecodeError:
                    values.append(tok)
        grid[path] = values
    return grid


def cmd_sweep(args) -> int:
    spec = _load_spec(args.spec)
    grid = _parse_set(args.set or [])
    if not grid:
        raise SystemExit("run_experiment: sweep needs at least one --set")
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else None
    dev = _device(args)
    run_kw = {}
    if args.engine in RUNTIME_ENGINES:
        run_kw = {"time_scale": args.time_scale, "timeout": args.timeout}

    def progress(cell, rep):
        print(f"# cell {cell.index}: {cell.overrides} -> "
              f"completed {rep.n_completed}, hit {rep.cache_hit_ratio:.3f}, "
              f"slowdown {rep.avg_slowdown:.2f}x, "
              f"alloc +{rep.n_allocated}/-{rep.n_released}", file=sys.stderr)

    sw = Sweep(spec, grid, seeds=seeds, engine=args.engine, device=dev)
    results = sw.run(out_dir=args.out_dir, run_kw=run_kw, progress=progress)
    print(json.dumps({
        "sweep": sw.name,
        "n_cells": len(results),
        "out_dir": args.out_dir,
        "cells": [{"index": c.index, "overrides": c.overrides,
                   "n_completed": r.n_completed,
                   "cache_hit_ratio": r.cache_hit_ratio,
                   "avg_slowdown": r.avg_slowdown,
                   "performance_index": r.performance_index}
                  for c, r in results],
    }, indent=2, sort_keys=True))
    return 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="runtime/serve engines: where the executors' "
                        "caches live, cuda (default) or cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("describe", help="validate a spec + summarise it")
    d.add_argument("spec")
    d.set_defaults(fn=cmd_describe)

    r = sub.add_parser("run", help="execute a spec on one engine")
    r.add_argument("spec")
    r.add_argument("--engine", default="sim",
                   choices=["sim", "runtime", "serve"])
    r.add_argument("--time-scale", type=float, default=0.0,
                   help="runtime engine: wall s per workload s (0 = ASAP)")
    r.add_argument("--timeout", type=float, default=600.0)
    r.add_argument("--barrier-every", type=int, default=None,
                   help="runtime engine: batch-synchronous replay in "
                        "chunks of N (deterministic; the fleet-parity "
                        "submission mode) instead of arrival pacing")
    r.add_argument("--task-fn", default=None, metavar="MODULE:ATTR",
                   help="runtime engine, fleet specs (hosts>0): named task "
                        "callable each host resolves locally")
    r.add_argument("--out", default=None, help="also write the report JSON")
    r.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a v3 trace (arrivals + measured per-task "
                        "outcomes) for the diff subcommand")
    _add_device(r)
    r.set_defaults(fn=cmd_run)

    f = sub.add_parser("diff", help="sim<->real per-task divergence: replay "
                                    "a recorded v3 trace through the sim "
                                    "twin and join outcomes by task id")
    f.add_argument("spec", help="the spec the trace was recorded under")
    f.add_argument("trace", help="v3 trace written by run --trace-out")
    f.add_argument("--out", default=None,
                   help="also write the divergence dict as JSON")
    f.add_argument("--report", default=None,
                   help="report JSON file (from run --out) to update in "
                        "place with task_divergence")
    f.set_defaults(fn=cmd_diff)

    s = sub.add_parser("sweep", help="cartesian grid over spec fields")
    s.add_argument("spec")
    s.add_argument("--engine", default="sim",
                   choices=["sim", "runtime", "serve"])
    s.add_argument("--set", action="append", metavar="PATH=V1,V2",
                   help="grid axis (repeatable)")
    s.add_argument("--seeds", default=None,
                   help="comma-separated seed-paired replications")
    s.add_argument("--time-scale", type=float, default=0.0)
    s.add_argument("--timeout", type=float, default=600.0)
    s.add_argument("--out-dir", default=None,
                   help="write manifest.json + results.jsonl here")
    _add_device(s)
    s.set_defaults(fn=cmd_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
