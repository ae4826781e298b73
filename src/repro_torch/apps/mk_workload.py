"""Workload CLI: generate seeded traces, replay them through an engine.

The port of ``tools/mk_workload.py``: the same subcommands, generation
flags, defaults and output; ``generate`` writes the same trace, byte for
byte, as the reference for the same flags.  ``run`` adds ``--device``
(default ``cuda``; ``cpu`` only when asked), where the runtime and serve
engines keep their executor caches, and names the device it resolved on
stderr for those engines.  ``--testbed`` offers the port's testbeds: the
paper's ``anl_uc`` only (the reference's ``tpu_v5e`` rates are a TPU
host's, with no counterpart on one card).

Generate a trace (versioned JSONL, bit-reproducible from the seed):

    PYTHONPATH=src python -m repro_torch.apps.mk_workload generate \
        --arrivals sine --rate 16 --amplitude 15 --period 120 \
        --popularity zipf --alpha 1.1 \
        --tasks 5000 --objects 250 --object-mb 10 --compute-s 0.5 \
        --seed 0 --out sine.jsonl

Replay it through an engine (optionally elastic) and print the run's
unified RunReport as JSON -- ``run`` is a thin wrapper that builds an
``repro_torch.experiments.ExperimentSpec`` from the flags and executes it
(see ``repro_torch.apps.run_experiment`` for the full spec-file CLI):

    PYTHONPATH=src python -m repro_torch.apps.mk_workload run sine.jsonl \
        --nodes 64 --policy max-compute-util --provision

``run`` accepts either a trace file or ``-`` plus the same generation flags
(generate-and-run without touching disk).

Multi-input (join) workloads -- each task stacks K correlated objects, the
§4.3 shape -- via ``--inputs-per-task K --input-corr C`` on both paths:

    PYTHONPATH=src python -m repro_torch.apps.mk_workload run - \
        --popularity zipf --inputs-per-task 3 --input-corr 0.8 \
        --tasks 2000 --objects 200 --nodes 64 --policy max-cache-hit

Structured DAG pipelines (tasks depend on other tasks' produced outputs;
recorded as trace v4, held/released by the dispatcher's ready-set) replace
the arrival/popularity recipe via ``--dag`` on both paths:

    PYTHONPATH=src python -m repro_torch.apps.mk_workload run - \
        --dag all_pairs --dag-n 16 --nodes 16 --policy max-compute-util

Multi-turn serving sessions (each turn a k-input join over block-aligned
prefix-KV pages; Zipf-shared system prompts; see
repro_torch.workloads.sessions) via ``--sessions N`` on both paths,
typically driven through the serve engine:

    PYTHONPATH=src python -m repro_torch.apps.mk_workload run - \
        --sessions 200 --turns 3 --zipf-s 1.2 --block 64 \
        --arrivals diurnal --nodes 4 --engine serve
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import workloads as W
from repro_torch.core.provisioner import AllocationPolicy
from repro_torch.core.testbeds import TESTBEDS
from repro_torch.device import describe, resolve_device
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ProvisionerSpec, WorkloadSpec,
                                     make_engine, run_experiment)

MB = 10**6


def _build_arrivals(args) -> W.ArrivalProcess:
    if args.arrivals == "batch":
        return W.BatchArrivals()
    if args.arrivals == "poisson":
        return W.PoissonArrivals(args.rate)
    if args.arrivals == "sine":
        amp = args.amplitude if args.amplitude is not None else 0.9 * args.rate
        return W.SineWaveArrivals(mean_rate=args.rate, amplitude=amp,
                                  period_s=args.period)
    if args.arrivals == "bursty":
        burst = args.burst_rate if args.burst_rate is not None \
            else 10 * args.rate
        return W.BurstyArrivals(base_rate=args.rate, burst_rate=burst,
                                burst_every_s=args.period,
                                burst_len_s=args.burst_len)
    if args.arrivals == "diurnal":
        peak = args.burst_rate if args.burst_rate is not None \
            else 10 * args.rate
        return W.DiurnalArrivals(peak_rate=peak, trough_rate=args.rate,
                                 day_s=args.period)
    raise SystemExit(f"unknown arrivals {args.arrivals!r}")


def _build_popularity(args) -> W.PopularityModel:
    k, corr = args.inputs_per_task, args.input_corr
    if args.popularity == "scan":
        return W.UniformScan(k=k)
    if args.popularity == "zipf":
        return W.ZipfPopularity(alpha=args.alpha, k=k, corr=corr)
    if args.popularity == "shifting":
        return W.ShiftingWorkingSet(working_set=args.working_set,
                                    shift_every=args.shift_every,
                                    k=k, corr=corr)
    if args.popularity == "stacking":
        return W.StackingTrace(locality=args.locality,
                               shuffle_seed=args.seed, k=k, corr=corr)
    raise SystemExit(f"unknown popularity {args.popularity!r}")


def _dag_binding(args) -> dict:
    """The ``{"kind": ..., ...kwargs}`` DAG binding the flags describe --
    the same dict WorkloadSpec.dag takes, so generate and run agree."""
    base = {"object_bytes": int(args.object_mb * MB), "dt": args.dag_dt,
            "seed": args.seed}
    if args.dag == "all_pairs":
        return {"kind": "all_pairs", "n_objects": args.dag_n, **base}
    if args.dag == "reduce_tree":
        return {"kind": "reduce_tree", "n_leaves": args.dag_n,
                "fanin": args.fanin, **base}
    if args.dag == "stacking_pyramid":
        return {"kind": "stacking_pyramid", "n_groups": args.dag_n,
                "group_size": args.group_size, **base}
    raise SystemExit(f"unknown dag {args.dag!r}")


def _sessions_binding(args) -> dict:
    """The ``{"kind": "chat", ...}`` session binding the flags describe --
    the same dict WorkloadSpec.sessions takes, so generate and run agree."""
    return {"kind": "chat", "n_sessions": args.sessions,
            "turns_per_session": args.turns,
            "n_system_prompts": args.system_prompts,
            "zipf_s": args.zipf_s,
            "system_prompt_blocks": args.sys_blocks,
            "turn_blocks": args.turn_blocks,
            "block": args.block,
            "model": args.model,
            "kv_bytes_per_token": args.kv_bpt,
            "think_time_s": args.think_s,
            "turn_seconds": args.turn_s,
            "arrivals": _build_arrivals(args).spec(),
            "seed": args.seed}


def _generate(args) -> W.Workload:
    if args.sessions is not None and args.dag is not None:
        raise SystemExit("--sessions and --dag are mutually exclusive")
    if args.sessions is not None:
        return W.build_sessions(_sessions_binding(args), name=args.name)
    if args.dag is not None:
        return W.build_dag(_dag_binding(args), name=args.name)
    return W.generate(
        args.name, _build_arrivals(args), _build_popularity(args),
        n_tasks=args.tasks, n_objects=args.objects,
        object_bytes=int(args.object_mb * MB),
        compute_seconds=args.compute_s,
        store_metadata_ops=args.meta_ops, seed=args.seed)


def _add_gen_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--name", default="wl")
    p.add_argument("--arrivals", default="poisson",
                   choices=["batch", "poisson", "sine", "bursty", "diurnal"])
    p.add_argument("--rate", type=float, default=8.0,
                   help="mean (poisson/sine) / base (bursty) / trough "
                        "(diurnal) arrival rate, tasks/s")
    p.add_argument("--amplitude", type=float, default=None,
                   help="sine amplitude (default 0.9*rate)")
    p.add_argument("--period", type=float, default=120.0,
                   help="sine/diurnal period or bursty inter-burst gap, s")
    p.add_argument("--burst-rate", type=float, default=None,
                   help="bursty burst rate / diurnal peak rate, tasks/s")
    p.add_argument("--burst-len", type=float, default=10.0)
    p.add_argument("--popularity", default="zipf",
                   choices=["scan", "zipf", "shifting", "stacking"])
    p.add_argument("--alpha", type=float, default=1.1)
    p.add_argument("--working-set", type=int, default=32)
    p.add_argument("--shift-every", type=int, default=500)
    p.add_argument("--locality", type=int, default=10)
    p.add_argument("--inputs-per-task", type=int, default=1, metavar="K",
                   help="join width: objects read per task (k-input tasks; "
                        "the §4.3 stacked reads)")
    p.add_argument("--input-corr", type=float, default=1.0, metavar="C",
                   help="probability an extra input comes from the primary "
                        "draw's neighborhood / stack group instead of an "
                        "independent draw (0..1; ignored by --popularity "
                        "scan)")
    p.add_argument("--dag", default=None,
                   choices=["all_pairs", "reduce_tree", "stacking_pyramid"],
                   help="emit a structured DAG pipeline instead of the "
                        "arrival/popularity recipe (tasks carry deps on "
                        "their producers; trace records as v4)")
    p.add_argument("--dag-n", type=int, default=8, metavar="N",
                   help="DAG size: n_objects (all_pairs) / n_leaves "
                        "(reduce_tree) / n_groups (stacking_pyramid)")
    p.add_argument("--fanin", type=int, default=2,
                   help="reduce_tree children per reduce task")
    p.add_argument("--group-size", type=int, default=4,
                   help="stacking_pyramid images per stack")
    p.add_argument("--dag-dt", type=float, default=0.0,
                   help="seconds between DAG task arrivals (0 = all at t=0; "
                        "the ready-set alone sequences the stages)")
    p.add_argument("--sessions", type=int, default=None, metavar="N",
                   help="emit N multi-turn serving sessions instead of the "
                        "arrival/popularity recipe (inputs are prefix-KV "
                        "page chains; --arrivals flags pace the session "
                        "starts)")
    p.add_argument("--turns", type=int, default=3,
                   help="turns per session (each extends the prefix chain)")
    p.add_argument("--system-prompts", type=int, default=8,
                   help="distinct system prompts shared Zipf-style")
    p.add_argument("--zipf-s", type=float, default=1.1,
                   help="Zipf skew over system prompts")
    p.add_argument("--block", type=int, default=64,
                   help="tokens per KV page (prefix-chain alignment)")
    p.add_argument("--sys-blocks", type=int, default=4,
                   help="blocks per system prompt")
    p.add_argument("--turn-blocks", type=int, default=2,
                   help="new blocks appended per turn")
    p.add_argument("--think-s", type=float, default=4.0,
                   help="seconds between a session's turns")
    p.add_argument("--turn-s", type=float, default=0.05,
                   help="compute seconds per turn (decode proxy)")
    p.add_argument("--model", default=None,
                   help="arch id (repro_torch.configs) to derive KV "
                        "bytes/token")
    p.add_argument("--kv-bpt", type=int, default=4096,
                   help="KV bytes per token when --model is not given")
    p.add_argument("--tasks", type=int, default=5_000)
    p.add_argument("--objects", type=int, default=250)
    p.add_argument("--object-mb", type=float, default=10.0)
    p.add_argument("--compute-s", type=float, default=0.5)
    p.add_argument("--meta-ops", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)


def cmd_generate(args) -> int:
    wl = _generate(args)
    n = W.record(wl, args.out)
    print(f"# wrote {n} tasks / {len(wl.objects)} objects to {args.out} "
          f"(arrival span {wl.duration:.1f}s, "
          f"offered {wl.offered_load():.2f} tasks/s)", file=sys.stderr)
    return 0


def _experiment_spec(args) -> ExperimentSpec:
    """The declarative equivalent of the flags: ``run`` is a thin wrapper
    over repro_torch.experiments."""
    if args.trace == "-" and args.sessions is not None:
        wspec = WorkloadSpec(name=args.name, sessions=_sessions_binding(args))
    elif args.trace == "-" and args.dag is not None:
        wspec = WorkloadSpec(name=args.name, dag=_dag_binding(args))
    elif args.trace == "-":
        wspec = WorkloadSpec(
            name=args.name,
            arrivals=_build_arrivals(args).spec(),
            popularity=_build_popularity(args).spec(),
            n_tasks=args.tasks, n_objects=args.objects,
            object_bytes=int(args.object_mb * MB),
            compute_seconds=args.compute_s,
            store_metadata_ops=args.meta_ops, seed=args.seed)
    else:
        wspec = WorkloadSpec(trace_path=args.trace)
    prov = None
    if args.provision:
        prov = ProvisionerSpec(
            policy=args.alloc_policy, min_executors=1,
            max_executors=args.nodes, queue_threshold=2,
            idle_timeout_s=args.idle_timeout, trigger_cooldown_s=1.0)
    return ExperimentSpec(
        name=args.name,
        cluster=ClusterSpec(testbed=args.testbed,
                            n_nodes=1 if prov else args.nodes),
        cache=CacheSpec(capacity_bytes=int(args.cache_gb * 1e9)),
        policy=args.policy,
        provisioner=prov,
        workload=wspec,
        seed=args.sim_seed)


def cmd_run(args) -> int:
    spec = _experiment_spec(args)
    if args.engine == "sim":
        rep = run_experiment(spec, engine="sim")
    else:
        dev = resolve_device(args.device)
        print(f"# device: {describe(dev)}", file=sys.stderr)
        eng = make_engine(args.engine, device=dev)
        try:
            rep = run_experiment(spec, engine=eng)
        finally:
            eng.shutdown()
    out = rep.as_dict()
    out.pop("pool_log")   # membership log can be long; spec+engine rerun it
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate a JSONL trace")
    _add_gen_flags(g)
    g.add_argument("--out", default="workload.jsonl")
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="run a trace (or '-' to generate inline) "
                                   "through an engine (a thin wrapper over "
                                   "the run_experiment CLI's spec API)")
    r.add_argument("trace")
    _add_gen_flags(r)
    r.add_argument("--nodes", type=int, default=16)
    r.add_argument("--policy", default="max-compute-util")
    r.add_argument("--engine", default="sim",
                   choices=["sim", "runtime", "serve"])
    r.add_argument("--testbed", default="anl_uc", choices=sorted(TESTBEDS),
                   help="testbed model (the reference's tpu_v5e is not "
                        "ported: its rates are a TPU host's)")
    r.add_argument("--cache-gb", type=float, default=100.0)
    r.add_argument("--provision", action="store_true",
                   help="start from 1 node and let the DRP grow/shrink")
    r.add_argument("--alloc-policy", default="exponential",
                   choices=[p.value for p in AllocationPolicy])
    r.add_argument("--idle-timeout", type=float, default=5.0)
    r.add_argument("--sim-seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="runtime/serve engines: where the executors' "
                        "caches live, cuda (default) or cpu")
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
