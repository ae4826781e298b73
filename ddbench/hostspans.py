"""The program's request spans over a run's measured window: five readings
for the metrics a later ``benchmark`` change will make of them, and a
diagnostic that takes them on the card.

    python3 ddbench/hostspans.py --workload <cell> --seed <n> \
        --seconds 51 --mode off|rec|trace [--out <file.jsonl>] \
        [--dump <file.npz>]

``off`` runs the cell as ``run.py --trace 0`` does; ``rec`` with the
program's recorder on and no profiler, not even the profiler's warm-up
session (what recording costs); ``trace`` as ``run.py --trace 1`` does, and
reads besides:

  store_copy_ms_mean     mean ``dur`` of the ``store_copy`` spans begun in
                         the window (a store read's host-to-device copy)
  lock_wait_ms_per_task  ``DispatchStats.lock_wait_s`` gained in the window
                         per request completed in it
  fn_cpu_ms_mean         mean thread CPU of the window's ``fn`` spans
  coadd_queue_ms_mean    mean from a ``launch`` span's start to its
                         ``stack_rois`` kernel's start on the card: the k-th
                         kernel on the one stream paired with the k-th
                         launch, both on the realtime clock
  idle_gc_share          share of the card's idle time in the profiled span
                         inside ``gc`` spans (%)

Each reader returns None where the run holds nothing to read, so a program
without the spans (no ``Recorder.spans``, ``anchor`` or ``to_epoch_ns``, or
no ``DispatchStats.lock_wait_s``) gives None, not an error.  ``harness.py``
knows nothing of this: :func:`run_recorded` runs ``harness.run_cell`` with
two stand-ins, an engine that keeps its recorder and a profiled span that
also takes the lock counters and a realtime anchor at the window's ends.
Prints one JSON line a run; ``--out`` appends it to a file.  One process a
run, as ``run.py`` is.
"""
from __future__ import annotations

import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the kernel whose launches are paired
KERNEL = "stack_rois"


@dataclass
class Recorded:
    """What the recorder held after a run, and the counters of the window."""

    #: ``time.monotonic()`` at the recorder's zero
    base: float
    spans: list
    spans_dropped: int
    #: ``[(recorder time, time.time_ns())]``
    anchors: list
    to_epoch_ns: Callable[[float], int]
    #: lock counters gained in the window (``DispatchStats.as_dict`` keys)
    locks: Optional[dict] = None
    #: process CPU seconds over the window's wall seconds
    cpu_share: Optional[float] = None


def has_spans(rec) -> bool:
    """Whether the recorder keeps spans and realtime anchors."""
    return rec is not None and all(
        hasattr(rec, a) for a in ("spans", "anchor", "to_epoch_ns", "base"))


def lock_counters(stats) -> Optional[dict]:
    """The lock counters of a ``DispatchStats``, or None where it has no
    ``lock_wait_s``."""
    if not hasattr(stats, "lock_wait_s"):
        return None
    return {k: v for k, v in stats.as_dict().items()
            if k.startswith("lock_")}


def gained(before: Optional[dict], after: Optional[dict]) -> Optional[dict]:
    if before is None or after is None:
        return None
    return {k: after[k] - before[k] for k in after}


# -- the readers --------------------------------------------------------------

def _began_in_window(run, rec: Recorded, kind: str) -> list:
    lo, hi = run.t_open - rec.base, run.t_close - rec.base
    return [s for s in rec.spans if s["kind"] == kind and lo <= s["t"] <= hi]


def store_copy_ms_mean(run, rec: Optional[Recorded]):
    if rec is None:
        return None
    spans = _began_in_window(run, rec, "store_copy")
    if not spans:
        return None
    return statistics.fmean(s["dur"] for s in spans) * 1e3


def lock_wait_ms_per_task(run, rec: Optional[Recorded]):
    if rec is None or rec.locks is None:
        return None
    n = len(run.window)
    return rec.locks["lock_wait_s"] / n * 1e3 if n else None


def fn_cpu_ms_mean(run, rec: Optional[Recorded]):
    if rec is None:
        return None
    window = set(run.window)
    cpu = [s["cpu"] for s in rec.spans
           if s["kind"] == "fn" and s.get("tid") in window]
    return statistics.fmean(cpu) * 1e3 if cpu else None


def _profiled_ns(run, rec: Recorded) -> tuple[int, int]:
    dev = run.device
    return (rec.to_epoch_ns(dev.t0 - rec.base),
            rec.to_epoch_ns(dev.t1 - rec.base))


def _launches_and_kernels(run, rec: Recorded):
    """Realtime starts (ns) of the ``stack_rois`` launches begun in the
    profiled span and of the kernels on the card, each sorted."""
    p0, p1 = _profiled_ns(run, rec)
    launches = sorted(ns for ns in (rec.to_epoch_ns(s["t"]) for s in rec.spans
                                    if s["kind"] == "launch"
                                    and s.get("kernel") == KERNEL)
                      if p0 <= ns <= p1)
    kernels = sorted(round(s * 1e9) for s, _, name in run.device.ops
                     if KERNEL in name)
    return launches, kernels


def pair_launches(launches: list[int], kernels: list[int]) -> list[int]:
    """Delays (ns) from the k-th launch to the k-th kernel, both in start
    order.  Launches whose order on the host differs from their kernels'
    on the one stream are paired with each other's kernels, +d and -d, so
    the mean holds where single delays do not."""
    n = min(len(launches), len(kernels))
    return [kernels[k] - launches[k] for k in range(n)]


def coadd_queue_ms_mean(run, rec: Optional[Recorded]):
    if rec is None or run.device is None:
        return None
    delays = pair_launches(*_launches_and_kernels(run, rec))
    return statistics.fmean(delays) * 1e-6 if delays else None


def join_slip_ms(run, rec: Optional[Recorded]):
    """How far the card's clock fell behind the host's in the profiled
    span, as far as the launches show it: the k-th kernel cannot start
    before the k-th launch began (each of the first k kernels follows a
    launch of its own), so the most negative k-th-kernel-less-k-th-launch
    is a lower bound of the slip (0 where none shows)."""
    if rec is None or run.device is None:
        return None
    delays = pair_launches(*_launches_and_kernels(run, rec))
    return max(0.0, -min(delays) * 1e-6) if delays else None


def _idle_ns(ops_ns: list, t0: int, t1: int) -> list[tuple[int, int]]:
    """Gaps with no operation in ``[t0, t1]`` (``obs.timeline.idle_gaps``
    does this in the program; the benchmark keeps its own, so that it runs
    against a program without it)."""
    gaps, reach = [], t0
    for start, end in sorted(ops_ns):
        if end <= t0:
            continue
        if start >= t1:
            break
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if reach < t1:
        gaps.append((reach, t1))
    return gaps


def idle_gc_share(run, rec: Optional[Recorded]):
    if rec is None or run.device is None:
        return None
    p0, p1 = _profiled_ns(run, rec)
    ops = [(round(s * 1e9), round(e * 1e9)) for s, e, _ in run.device.ops]
    gaps = _idle_ns(ops, p0, p1)
    idle = sum(b - a for a, b in gaps)
    if not idle:
        return None
    pauses = sorted((rec.to_epoch_ns(s["t"]), rec.to_epoch_ns(s["t"] + s["dur"]))
                    for s in rec.spans if s["kind"] == "gc")
    inside, j = 0, 0
    for a, b in gaps:
        while j < len(pauses) and pauses[j][1] <= a:
            j += 1
        k = j
        while k < len(pauses) and pauses[k][0] < b:
            inside += max(0, min(b, pauses[k][1]) - max(a, pauses[k][0]))
            k += 1
    return 100.0 * inside / idle


READERS = {
    "store_copy_ms_mean.saturate": store_copy_ms_mean,
    "lock_wait_ms_per_task.saturate": lock_wait_ms_per_task,
    "fn_cpu_ms_mean.saturate": fn_cpu_ms_mean,
    "coadd_queue_ms_mean.saturate": coadd_queue_ms_mean,
    "idle_gc_share.saturate": idle_gc_share,
}


def anchor_drift_us(run, rec: Optional[Recorded]):
    """How far the realtime clock moved against the monotonic one over the
    window: the change of (epoch − recorder time) from the last anchor at or
    before the open to the first at or after the close (µs), and the
    anchors in between."""
    if rec is None or len(rec.anchors) < 2:
        return None
    lo, hi = run.t_open - rec.base, run.t_close - rec.base
    ts = [t for t, _ in rec.anchors]
    i = max(bisect.bisect_right(ts, lo) - 1, 0)
    j = min(bisect.bisect_left(ts, hi), len(ts) - 1)
    (ta, na), (tb, nb) = rec.anchors[i], rec.anchors[j]
    return {"drift_us": ((nb - na) - round((tb - ta) * 1e9)) * 1e-3,
            "over_s": tb - ta, "anchors": j - i + 1}


# -- the run ------------------------------------------------------------------

class _Holder:
    engine = None
    recorder = None
    locks0 = locks1 = None
    cpu0 = cpu1 = None
    wall0 = wall1 = None


def _window_class(span_cls, holder: _Holder, profile: bool):
    """``devtrace.Span`` that also takes the lock counters, the process's
    CPU time and a realtime anchor at the window's ends; it profiles the
    card only with ``profile``."""

    class Window(span_cls):
        def _mark(self) -> tuple:
            eng = holder.engine
            rec = eng.recorder if eng is not None else None
            if rec is not None and hasattr(rec, "anchor"):
                rec.anchor()
            locks = (lock_counters(eng.runtime.stats) if eng is not None
                     else None)
            return locks, time.process_time(), time.monotonic()

        def __enter__(self):
            if profile:
                super().__enter__()
            holder.locks0, holder.cpu0, holder.wall0 = self._mark()
            return self

        def __exit__(self, *exc):
            holder.locks1, holder.cpu1, holder.wall1 = self._mark()
            if profile:
                super().__exit__(*exc)
            else:
                import torch

                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.trace = None
            holder.engine = None

    return Window


def run_recorded(cell: str, cfg: dict, mix: dict, ref, seed: int,
                 seconds: float, t_proc0: float, device: str = "cuda",
                 profile: bool = True, task_fn=None):
    """``harness.run_cell`` of a traced run: ``(run, recorded)``, where
    ``recorded`` is None for a program without the spans."""
    from ddbench import devtrace, harness

    holder = _Holder()

    class Engine(harness.RuntimeEngine):
        def prepare(self, *a, **k):
            out = super().prepare(*a, **k)
            holder.engine, holder.recorder = self, self.recorder
            return out

    saved = harness.RuntimeEngine, devtrace.Span, devtrace.warm_up
    harness.RuntimeEngine = Engine
    devtrace.Span = _window_class(saved[1], holder, profile)
    if not profile:
        devtrace.warm_up = lambda device: None
    try:
        run = harness.run_cell(cell, cfg, mix, ref, seed, seconds, True,
                               t_proc0, device=device, task_fn=task_fn)
    finally:
        harness.RuntimeEngine, devtrace.Span, devtrace.warm_up = saved
        holder.engine = None
    rec = holder.recorder
    if not has_spans(rec):
        return run, None
    cpu = None
    if holder.wall1 is not None and holder.wall1 > holder.wall0:
        cpu = (holder.cpu1 - holder.cpu0) / (holder.wall1 - holder.wall0)
    return run, Recorded(
        base=rec.base, spans=rec.spans(), spans_dropped=rec.spans_dropped,
        anchors=rec.anchors, to_epoch_ns=rec.to_epoch_ns,
        locks=gained(holder.locks0, holder.locks1), cpu_share=cpu)


def dump(path: str, run, rec: Recorded) -> None:
    """The run's spans and card operations as arrays (``numpy.savez``), for
    a look at what the readers summarise."""
    import numpy as np

    arrays = {"anchor_t": np.array([t for t, _ in rec.anchors]),
              "anchor_ns": np.array([n for _, n in rec.anchors],
                                    dtype=np.int64),
              "base": rec.base, "t_open": run.t_open,
              "t_close": run.t_close}
    for kind in ("launch", "fn", "store_copy", "gc"):
        rows = [s for s in rec.spans if s["kind"] == kind]
        arrays[f"{kind}_t"] = np.array([s["t"] for s in rows])
        arrays[f"{kind}_dur"] = np.array([s["dur"] for s in rows])
        arrays[f"{kind}_ns"] = np.array(
            [rec.to_epoch_ns(s["t"]) for s in rows], dtype=np.int64)
        if kind == "fn":
            arrays["fn_cpu"] = np.array([s["cpu"] for s in rows])
    if run.device is not None:
        ops = run.device.ops
        names = sorted({n for _, _, n in ops})
        code = {n: i for i, n in enumerate(names)}
        arrays.update(
            ops_start_ns=np.array([round(s * 1e9) for s, _, _ in ops],
                                  dtype=np.int64),
            ops_end_ns=np.array([round(e * 1e9) for _, e, _ in ops],
                                dtype=np.int64),
            ops_name=np.array([code[n] for _, _, n in ops]),
            op_names=np.array(names), dev_t0=run.device.t0,
            dev_t1=run.device.t1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def measure(cell_name: str, seed: int, seconds: float, mode: str,
            device: str = "cuda", bench: dict | None = None,
            t_proc0: float = T_PROC0, dump_to: str | None = None) -> dict:
    """One run in ``mode``: a dict of its readings; ``dump_to`` also saves
    the spans and card operations there (:func:`dump`)."""
    from ddbench import harness, registry

    bench = bench if bench is not None else registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    ref = registry.reference(cfg["reference"])
    recd = None
    if mode == "off":
        run = harness.run_cell(cell_name, cfg, mix, ref, seed, seconds,
                               False, t_proc0, device=device)
    else:
        run, recd = run_recorded(cell_name, cfg, mix, ref, seed, seconds,
                                 t_proc0, device=device,
                                 profile=mode == "trace")
    out = {"cell": cell_name, "seed": seed, "mode": mode, "metrics": {}}
    for m in bench["end_to_end"] + (bench["per_layer"] if mode == "trace"
                                    else []):
        if cell_name in m.get("workloads", [cell_name]):
            v = registry.reader(m["name"])(run)
            if v is not None:
                out["metrics"][m["name"]] = float(v)
    if recd is not None:
        for name, read in READERS.items():
            v = read(run, recd)
            if v is not None:
                out["metrics"][name] = float(v)
        out["spans_in_window"] = {
            k: len(_began_in_window(run, recd, k))
            for k in ("store_copy", "fn", "launch", "gc")}
        out["spans_dropped"] = recd.spans_dropped
        out["anchor_drift"] = anchor_drift_us(run, recd)
        out["cpu_share"] = recd.cpu_share
        out["join_slip_ms"] = join_slip_ms(run, recd)
        out["locks"] = recd.locks
        gcs = _began_in_window(run, recd, "gc")
        if dump_to is not None:
            dump(dump_to, run, recd)
        out["gc"] = {"n": len(gcs),
                     "s": sum(s["dur"] for s in gcs),
                     "longest_s": max((s["dur"] for s in gcs), default=0.0),
                     "gen2": sum(1 for s in gcs if s.get("generation") == 2)}
    if run.device is not None:
        out["busy_s"] = run.device.busy_s
        out["window_s"] = run.device.window_s
    dev = harness.resolve(device)
    out["correct"] = harness.passed(harness.checks(run, ref, dev))
    out["memory_peak_bytes"] = run.memory_peak_bytes
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("off", "rec", "trace"), required=True)
    ap.add_argument("--out")
    ap.add_argument("--dump", help="save the spans and card operations "
                    "(numpy .npz) here")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("hostspans: no CUDA card", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.seconds, args.mode,
                  dump_to=args.dump)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
