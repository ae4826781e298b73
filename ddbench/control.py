"""The control's readings, that the upper ends of the limits of ``correct``
are set from, many seeds in one process.

    python3 ddbench/control.py --workload <cell> --seeds 1,2,3 --seconds 51

For each seed it runs the cell as ``run.py`` does, with the plain reference
computed in bfloat16 in the program's place (the precision below the
configuration's fp32), and prints one JSON line: the seed, whether the run
came out correct, and every number compared with its limit.  The control
has to come out not correct on every seed; the benchmark's own runs never
run it.  The program's readings come from ``run.py``, one process a seed,
as the benchmark runs it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_PROC0 = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from ddbench import registry, run

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark(held=True)
    cfg = registry.config(bench, registry.cell(bench, args.workload)["config"])
    fn = registry.reference(cfg["reference"]).control_task(cfg)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.measure(args.workload, seed, args.seconds, False,
                          task_fn=fn, bench=bench)
        print(json.dumps({"seed": seed, "side": "control",
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
