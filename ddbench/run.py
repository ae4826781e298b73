"""Run one cell of the benchmark once and print its result line.

    python3 ddbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository, on a machine with the cards
the cell asks for.  ``BENCHMARK.json`` names the cell's configuration,
traffic mix and metrics; ``ddbench/registry.py`` finds their files.  The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with the plain
reference, beside its limit.  The checks are also the last lines of
standard error.  Without a CUDA card the command fails and prints no result.
"""
from __future__ import annotations

import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def _setup_paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every build and kernel cache stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Forbidden top-level names among the loaded modules, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _number(v):
    return v if math.isfinite(v) else sys.float_info.max


def measure(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", task_fn=None, bench: dict | None = None,
            t_proc0: float = T_PROC0) -> dict:
    """One run of ``cell_name``: the result line as a dict.  ``task_fn``
    replaces the configuration's task function (the control and the fault
    tests put theirs in the program's place)."""
    import torch

    from ddbench import harness, registry

    bench = bench if bench is not None else registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    ref = registry.reference(cfg["reference"])
    run = harness.run_cell(cell_name, cfg, mix, ref, seed, seconds, trace,
                           t_proc0, device=device, task_fn=task_fn)
    dev = harness.resolve(device)
    metrics = {}
    for m in registry.metrics(bench, cell_name, trace):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": _number(float(value)),
                                  "unit": m["unit"]}
    checks = harness.checks(run, ref, dev)
    for c in checks.values():
        c["value"] = _number(c["value"])
    completed = sum(1 for tid in run.due if tid in run.done_at)
    on_card = dev.type == "cuda"
    result = {
        "correct": harness.passed(checks),
        "attempted": len(run.due),
        "failed": len(run.due) - completed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if on_card
                     else "cpu"),
            "count": cell["chips"],
            "memory_peak_bytes": run.memory_peak_bytes,
            "card": harness.card_name(dev) if on_card else "cpu",
        },
    }
    if run.device is not None:
        result["device"]["busy_s"] = run.device.busy_s
        result["device"]["window_s"] = run.device.window_s
        result["breakdown"] = {"device_ops": run.device.top_ops(),
                               "idle_gaps": run.device.idle_gaps()}
    from ddbench import arith

    per_5s = arith.per_bucket(run.done_at.values(), run.t_open, 5.0,
                              math.ceil(run.seconds / 5.0))
    print(f"# {cell_name} seed {seed}: {completed} of {len(run.due)} "
          f"requests due in the window completed; completions per 5 s "
          f"{per_5s}; set-up {run.setup_s:.3f} s; {run.extra}",
          file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()
    import torch

    from ddbench import registry

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ddbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"ddbench: the reporting process loaded {bad}; the port and "
              f"the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
