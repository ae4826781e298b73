"""Where the window's time goes when nothing completes: one run of a cell
with a sampler beside it.

    python3 ddbench/stalls.py --workload <cell> --seed <n> --seconds 51 \
        --out chiprun_out/stalls_<n>.json

Runs the cell as ``run.py`` does (untraced) while a sampler thread records,
every ``SAMPLE_S``: the process's CPU seconds, the machine's stolen CPU
time (``/proc/stat``), Python's collector counts, and where every thread
stands (its innermost frame and its innermost frame in the program).  The
interpreter's collections are timed through ``gc.callbacks``.  After the
run, the window is cut into ``BUCKET_S`` buckets of completions (the
program's ``Task.end_time``); for each bucket with none, the file gets what
the sampler saw in it, the collections that overlapped it and the sampler's
own gaps (a gap means something held the interpreter lock).  Prints one
summary line; the JSON file holds the rest.  A diagnostic, not a cell.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import threading
import time
from pathlib import Path

T_PROC0 = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
SAMPLE_S = 0.05
BUCKET_S = 0.5


def _steal_s() -> float:
    """Stolen CPU seconds of the whole machine so far (0 where unknown)."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return int(parts[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _where(frame) -> str:
    inner = f"{Path(frame.f_code.co_filename).name}:{frame.f_lineno}:" \
            f"{frame.f_code.co_name}"
    f = frame
    while f is not None and "repro_torch" not in f.f_code.co_filename:
        f = f.f_back
    if f is None or f is frame:
        return inner
    return f"{inner} <- {Path(f.f_code.co_filename).name}:{f.f_lineno}:" \
           f"{f.f_code.co_name}"


class Sampler(threading.Thread):
    def __init__(self) -> None:
        super().__init__(daemon=True, name="stall-sampler")
        self.samples: list[dict] = []
        self.gcs: list[tuple[float, float, int]] = []
        self._gc_t0 = 0.0
        self.stop_evt = threading.Event()

    def on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.monotonic()
        else:
            self.gcs.append((self._gc_t0, time.monotonic(),
                             info["generation"]))

    def run(self) -> None:
        me = threading.get_ident()
        while not self.stop_evt.wait(SAMPLE_S):
            cpu = os.times()
            where = collections.Counter(
                _where(f) for tid, f in sys._current_frames().items()
                if tid != me)
            self.samples.append({"t": time.monotonic(),
                                 "cpu_s": cpu.user + cpu.system,
                                 "steal_s": _steal_s(),
                                 "gc_count": gc.get_count(),
                                 "where": where})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from ddbench import harness, registry

    if not torch.cuda.is_available():
        print("stalls: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark(held=True)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    ref = registry.reference(cfg["reference"])
    sampler = Sampler()
    gc.callbacks.append(sampler.on_gc)
    sampler.start()
    try:
        run = harness.run_cell(args.workload, cfg, mix, ref, args.seed,
                               args.seconds, False, T_PROC0)
    finally:
        sampler.stop_evt.set()
        sampler.join()
        gc.callbacks.remove(sampler.on_gc)
    n_buckets = int(args.seconds / BUCKET_S)
    counts = [0] * n_buckets
    for t in run.done_at.values():
        k = int((t - run.t_open) / BUCKET_S)
        if 0 <= k < n_buckets:
            counts[k] += 1
    samples = sampler.samples
    gaps = [(a["t"] - run.t_open, b["t"] - a["t"])
            for a, b in zip(samples, samples[1:])
            if b["t"] - a["t"] > 4 * SAMPLE_S]
    stalls = []
    for k, n in enumerate(counts):
        if n:
            continue
        lo, hi = run.t_open + k * BUCKET_S, run.t_open + (k + 1) * BUCKET_S
        inside = [s for s in samples if lo <= s["t"] < hi]
        where = collections.Counter()
        for s in inside:
            where.update(s["where"])
        span = [s for s in samples if lo - SAMPLE_S <= s["t"] < hi + SAMPLE_S]
        stalls.append({
            "bucket_s": k * BUCKET_S,
            "samples": len(inside),
            "cpu_s_per_s": ((span[-1]["cpu_s"] - span[0]["cpu_s"])
                            / (span[-1]["t"] - span[0]["t"])
                            if len(span) > 1 else None),
            "steal_s_per_s": ((span[-1]["steal_s"] - span[0]["steal_s"])
                              / (span[-1]["t"] - span[0]["t"])
                              if len(span) > 1 else None),
            "gc": [(a - run.t_open, b - a, g) for a, b, g in sampler.gcs
                   if a < hi and b > lo],
            "where": where.most_common(12)})
    win = [s for s in samples if run.t_open <= s["t"] <= run.t_close]
    summary = {
        "seed": args.seed, "setup_s": run.setup_s,
        "completed_in_window": sum(counts),
        "tasks_per_s": sum(counts) / args.seconds,
        "per_bucket": counts,
        "empty_buckets": len(stalls),
        "sampler_gaps_over_0.2s": gaps,
        "gc_over_50ms": [(a - run.t_open, b - a, g) for a, b, g in sampler.gcs
                         if b - a > 0.05],
        "cpu_s_per_s": ((win[-1]["cpu_s"] - win[0]["cpu_s"])
                        / (win[-1]["t"] - win[0]["t"]) if len(win) > 1
                        else None),
        "steal_s_per_s": ((win[-1]["steal_s"] - win[0]["steal_s"])
                          / (win[-1]["t"] - win[0]["t"]) if len(win) > 1
                          else None),
        "memory_peak_bytes": run.memory_peak_bytes,
        "extra": run.extra}
    where = collections.Counter()
    for s in win:
        where.update(s["where"])
    summary["where_in_window"] = where.most_common(12)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({**summary, "stalls": stalls},
                                         indent=1))
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("where_in_window",)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
