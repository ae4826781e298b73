#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--json PATH]

Phases, each reported on its own lines:

  1. environment: the card's name and power limit, torch and CUDA versions,
     and the build of every CUDA kernel from the checkout's sources (nvcc,
     all sources at once, into build/kernels/);
  2. every kernel against its plain PyTorch version on the card, at the test
     shapes and at the shapes the main path gives it, with its time, the
     plain version's time and the bound the card sets;
  3. the flat stacking path at Table 2's locality-10 size: 46,480 tasks over
     4,648 files on 64 executors (the ANL/UC testbed) with 1 GiB caches on
     the card, through RuntimeEngine; the kernel must launch once per task,
     and the first 64 results are recomputed with the plain version;
  4. the stack-then-mosaic pipeline at the example's defaults (8 groups x 4
     files on 4 executors); the kernel must launch groups + 1 times and the
     stacks and the mosaic must match the plain version.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failure raises, so the script exits non-zero and prints no
result.  It needs CUDA and the rest of the checkout, and fails without them.
With ``--json PATH`` it also writes everything it measured to PATH.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FLAT_TASKS, FLAT_LOCALITY, FLAT_HOSTS = 46_480, 10, 64   # Table 2, ANL/UC
CHECKED_TASKS = 64
PIPE_GROUPS, PIPE_GROUP_SIZE, PIPE_HOSTS = 8, 4, 4       # example defaults

STACKING_TPU_KERNEL = "src/repro/kernels/stacking/stacking.py:26"
STACKING_SOURCE = "src/repro_torch/kernels/stacking/csrc/stack_rois.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(label: str, got: torch.Tensor, want: torch.Tensor,
                exact: bool = False) -> tuple[float, float]:
    """Hold ``got`` to ``want``: rtol 1e-5 and atol 1e-5 * max|want| (the
    reference's own stacking tolerance), or bit equality with ``exact``.
    Returns (max abs error, max rel error); raises on a mismatch."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    if exact:
        ok = max_abs == 0.0
    else:
        atol = 1e-5 * float(want.abs().max())
        ok = bool((err <= atol + 1e-5 * want.abs()).all())
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version (max abs {max_abs}, max rel {max_rel})")
    return max_abs, max_rel


def host_ms(fn, reps: int = 30, inner: int = 50) -> float:
    """Per-call time of ``inner`` eager back-to-back calls (CUDA events,
    median over ``reps``, after a warm-up).  Where the host takes longer to
    issue a call than the card to run it, this is the host's time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 30, inner: int = 50) -> float:
    """Per-call device time: ``inner`` calls captured in one CUDA graph and
    replayed ``reps`` times (CUDA events, median), so the host's cost of
    issuing each call is out of the measurement.  Inputs stay in L2 between
    calls, as they do on the main path, where a task's tiles were just
    written."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stacking_bound(n: int, h: int, w: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one stacking call, and what
    sets it: each input read once (ROIs and the four per-ROI scalars) and
    the output written once, over HBM bandwidth; against 10 fp32 operations
    per ROI pixel (calibrate 2, bilinear blend 7, accumulate 1) plus the
    division for the mean, over the fp32 peak outside the tensor cores."""
    bytes_moved = 4 * n * h * w + 4 * 4 * n + 4 * h * w
    ops = 10 * n * h * w + h * w
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 1: environment and build
# --------------------------------------------------------------------------

def phase_environment() -> dict:
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    took = build.build_all()
    total = time.monotonic() - t0
    for name, secs in took.items():
        log(f"[build] {name}: nvcc {secs:.2f}s -> "
            f"{build.library_path(name).relative_to(ROOT)}")
        ptxas = build.library_path(name).with_suffix(".log")
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {total:.2f}s (wall)")
    return {"nvidia_smi": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": took,
            "build_wall_s": total}


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# --------------------------------------------------------------------------

def _stacking_inputs(n: int, h: int, w: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(500, 100, (n, h, w)), rng.normal(0, 10, n),
            rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, n),
            rng.uniform(0, 1, n))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def phase_kernels() -> dict:
    from repro_torch.kernels.stacking.ref import stack_rois_ref
    from repro_torch.kernels.stacking.stacking import stack_rois_fwd

    dev = torch.device("cuda", 0)

    def plain(rois, sky, cal, dy, dx, mean):
        out = stack_rois_ref(rois, sky, cal, dy, dx)
        return out / rois.shape[0] if mean else out

    cases = []
    # the reference's test shapes (tests/test_kernels.py), sum only
    for i, (n, h, w) in enumerate([(8, 16, 16), (37, 24, 40),
                                   (100, 100, 100), (3, 8, 8)]):
        cases.append((f"test N={n} {h}x{w}", _stacking_inputs(n, h, w, i, dev),
                      False, False))
    # dy = dx = 0 must be the exact calibrated sum
    rois = torch.arange(2 * 4 * 4, dtype=torch.float32, device=dev) \
        .reshape(2, 4, 4)
    z, o = torch.zeros(2, device=dev), torch.ones(2, device=dev)
    cases.append(("exact-sum N=2 4x4 dy=dx=0", [rois, z, o, z, z], False, True))
    # the main path's shapes: flat task, pipeline stack task, mosaic task
    main_shapes = {"flat": (8, 100, 100), "stack": (32, 100, 100),
                   "mosaic": (PIPE_GROUPS, 100, 100)}
    for j, (label, (n, h, w)) in enumerate(main_shapes.items()):
        args = _stacking_inputs(n, h, w, 100 + j, dev)
        if label == "mosaic":
            zn, on = torch.zeros(n, device=dev), torch.ones(n, device=dev)
            args = [args[0], zn, on, zn, zn]
        cases.append((f"main/{label} N={n} {h}x{w}", args, True, False))

    rows = []
    for label, args, mean, exact in cases:
        got = stack_rois_fwd(*args, mean=mean)
        want = plain(*args, mean)
        torch.cuda.synchronize()
        max_abs, max_rel = check_close(label, got, want, exact=exact)
        if exact:
            check_close(label + " vs sum", got, args[0].sum(0), exact=True)
        n, h, w = args[0].shape
        kernel = lambda: stack_rois_fwd(*args, mean=mean)  # noqa: E731
        plain_fn = lambda: plain(*args, mean)  # noqa: E731
        k_ms, p_ms = device_ms(kernel), device_ms(plain_fn)
        k_host, p_host = host_ms(kernel), host_ms(plain_fn)
        bound_ms, bound_by = stacking_bound(n, h, w)
        row = {"case": label, "shape": [n, h, w], "mean": mean,
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "ms": k_ms, "plain_ms": p_ms, "host_ms": k_host,
               "plain_host_ms": p_host, "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        log(f"[kernel] stack_rois {label}: max abs err {max_abs:.3g} "
            f"max rel err {max_rel:.3g} | device: kernel "
            f"{k_ms * 1e3:.3f} us, plain {p_ms * 1e3:.3f} us, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}) | eager per call: kernel "
            f"{k_host * 1e3:.2f} us, plain {p_host * 1e3:.2f} us")
    log("[kernel] stack_rois: no single PyTorch call computes this function "
        "(calibrate + bilinear shift + coadd), so there is no library "
        "yardstick (library_ms null)")
    return {"stack_rois": rows}


# --------------------------------------------------------------------------
# phases 3 and 4: the main path through RuntimeEngine
# --------------------------------------------------------------------------

def _recompute(eng, task, seed_ids) -> torch.Tensor:
    """The plain version's coadd of ``task``'s inputs, read afresh from the
    store and copied to the card."""
    from repro_torch.apps import astro
    from repro_torch.kernels.stacking.ref import stack_rois_ref

    store = eng.runtime.store
    tiles = torch.cat([store.get(oid)[1].to(eng.runtime.device)
                       for oid in task.inputs], dim=0)
    out = stack_rois_ref(tiles, *astro.coadd_params(tiles, seed_ids))
    return out / tiles.shape[0]


def phase_flat() -> dict:
    from repro_torch.apps import astro
    from repro_torch.configs.astro_stacking import workload
    from repro_torch.experiments import RuntimeEngine
    from repro_torch.kernels.stacking.stacking import launches

    spec = astro.flat_spec(FLAT_TASKS, FLAT_LOCALITY, FLAT_HOSTS)
    n_files = spec.workload.n_objects
    log(f"[flat] {FLAT_TASKS} tasks over {n_files} files (locality "
        f"{FLAT_LOCALITY}; Table 2 lists 4650 files) on {FLAT_HOSTS} "
        f"executors with 1 GiB caches on the card; no cut")
    t0 = time.monotonic()
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        for ob in eng.workload.objects:
            eng.runtime.put_object(ob, astro.make_tiles(ob))
        setup_s = time.monotonic() - t0
        log(f"[flat] set-up (catalog made on the host, "
            f"{n_files * astro.FILE_BYTES / 1e9:.3f} GB): {setup_s:.2f}s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        rep = eng.run(task_fn=astro.stack_object, time_scale=0.0,
                      timeout=900.0)
        torch.cuda.synchronize()
        n_launch = launches.value
        peak = torch.cuda.max_memory_allocated()
        ideal = workload(FLAT_LOCALITY).ideal_cache_hit_ratio
        b = rep.bytes_by_kind
        log(f"[flat] completed {rep.n_completed}/{rep.n_tasks} failed "
            f"{rep.n_failed} | wall {rep.wall_s:.2f}s | "
            f"{rep.tasks_per_second:.1f} tasks/s over the busy span "
            f"({rep.busy_span_s:.2f}s)")
        log(f"[flat] cache hit ratio {rep.cache_hit_ratio:.4f} (ideal 1-1/L "
            f"= {ideal:.4f}; local {rep.local_hits}, peer {rep.peer_hits}, "
            f"store {rep.store_reads})")
        log(f"[flat] bytes: store {b['store_read'] / 1e9:.4f} GB, local "
            f"{b['local'] / 1e9:.4f} GB, cache-to-cache {b['c2c'] / 1e9:.4f} "
            f"GB | peak device memory {peak / 2**30:.3f} GiB")
        log(f"[flat] stack_rois launches {n_launch} (completed tasks "
            f"{rep.n_completed})")
        if rep.n_completed != FLAT_TASKS or rep.n_failed:
            raise AssertionError("flat run did not complete every task")
        if n_launch != rep.n_completed:
            raise AssertionError(f"flat: {n_launch} kernel launches for "
                                 f"{rep.n_completed} tasks")
        if rep.cache_hit_ratio < 0.9 * ideal:
            raise AssertionError(f"flat: hit ratio {rep.cache_hit_ratio} is "
                                 f"below 90% of the ideal {ideal}")
        done = eng.runtime.dispatcher.completed
        worst = 0.0
        for t in done[:CHECKED_TASKS]:
            want = _recompute(eng, t, [int(oid[3:]) for oid in t.inputs])
            if t.result.device.type != "cuda":
                raise AssertionError(f"{t.tid}: result not on the card")
            worst = max(worst, check_close(t.tid, t.result, want)[0])
        log(f"[flat] first {CHECKED_TASKS} completed tasks against the plain "
            f"version on the card: max abs err {worst:.3g}")
        return {"tasks": FLAT_TASKS, "files": n_files,
                "executors": FLAT_HOSTS, "setup_s": setup_s,
                "wall_s": rep.wall_s, "busy_span_s": rep.busy_span_s,
                "tasks_per_second": rep.tasks_per_second,
                "cache_hit_ratio": rep.cache_hit_ratio, "ideal": ideal,
                "local_hits": rep.local_hits, "peer_hits": rep.peer_hits,
                "store_reads": rep.store_reads, "bytes_by_kind": b,
                "peak_memory_bytes": peak, "launches": n_launch,
                "checked_max_abs_err": worst}
    finally:
        eng.shutdown()


def phase_pipeline() -> dict:
    from repro_torch.apps import astro
    from repro_torch.experiments import RuntimeEngine
    from repro_torch.kernels.stacking.ref import stack_rois_ref
    from repro_torch.kernels.stacking.stacking import launches

    spec = astro.pipeline_spec(PIPE_GROUPS, PIPE_GROUP_SIZE, PIPE_HOSTS)
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        launches.reset()
        rep = eng.run(task_fn=astro.stack_or_mosaic,
                      payload_factory=astro.make_tiles, time_scale=0.0,
                      timeout=300.0)
        torch.cuda.synchronize()
        n_launch = launches.value
        done = {t.tid: t for t in eng.runtime.dispatcher.completed}
        stacks = []
        worst = 0.0
        for g in range(PIPE_GROUPS):
            t = done[f"astro-stack{g}"]
            want = _recompute(eng, t, [int(o.split(".")[2][1:])
                                       for o in t.inputs])
            worst = max(worst, check_close(t.tid, t.result, want)[0])
            stacks.append(t.result)
        tiles = torch.stack(stacks)
        z = torch.zeros(PIPE_GROUPS, device=tiles.device)
        o = torch.ones(PIPE_GROUPS, device=tiles.device)
        want = stack_rois_ref(tiles, z, o, z, z) / PIPE_GROUPS
        mosaic = done["astro-mosaic"].result
        worst = max(worst, check_close("mosaic", mosaic, want)[0])
        b = rep.bytes_by_kind
        log(f"[pipeline] stacked {PIPE_GROUPS} groups x {PIPE_GROUP_SIZE} "
            f"files, then mosaicked, on {PIPE_HOSTS} executors: completed "
            f"{rep.n_completed}/{rep.n_tasks}, wall {rep.wall_s:.3f}s")
        log(f"[pipeline] cache hit ratio {rep.cache_hit_ratio:.4f} | bytes: "
            f"store {b['store_read'] / 1e6:.1f} MB, cache-served "
            f"{(b['c2c'] + b['local']) / 1e6:.1f} MB | mosaic pixel mean "
            f"{float(mosaic.mean()):.2f}")
        log(f"[pipeline] stack_rois launches {n_launch} (groups + 1 = "
            f"{PIPE_GROUPS + 1}); stacks and mosaic against the plain "
            f"version: max abs err {worst:.3g}")
        if rep.n_completed != PIPE_GROUPS + 1 or rep.n_failed:
            raise AssertionError("pipeline run did not complete every task")
        if n_launch != PIPE_GROUPS + 1:
            raise AssertionError(f"pipeline: {n_launch} kernel launches, "
                                 f"expected {PIPE_GROUPS + 1}")
        return {"wall_s": rep.wall_s, "cache_hit_ratio": rep.cache_hit_ratio,
                "bytes_by_kind": b, "launches": n_launch,
                "max_abs_err": worst}
    finally:
        eng.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    env = phase_environment()
    kernels = phase_kernels()
    flat = phase_flat()
    pipe = phase_pipeline()

    main_row = next(r for r in kernels["stack_rois"]
                    if r["case"].startswith("main/flat"))
    main_err = max(r["max_abs_err"] for r in kernels["stack_rois"]
                   if r["case"].startswith("main/"))
    line = {"kernels": [{
        "name": "stack_rois",
        "route": "cuda",
        "source": STACKING_SOURCE,
        "replaces": STACKING_TPU_KERNEL,
        "launches": flat["launches"] + pipe["launches"],
        "launches_flat": flat["launches"],
        "launches_pipeline": pipe["launches"],
        "shape": main_row["shape"],
        "max_abs_err": main_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "host_ms": main_row["host_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"env": env, "kernels": kernels, "flat": flat, "pipeline": pipe,
             "kernels_line": line, "seconds": time.monotonic() - t_start},
            indent=2, default=str) + "\n")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
