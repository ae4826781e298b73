"""The paper's application (§5) on the card: SDSS image stacking over data
diffusion, with the coadd computed by the hand-written CUDA stacking kernel.

Counterpart of ``examples/astronomy_stacking.py``, with the same flags and
the same stdout lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernel's plain version).

Default mode is the stack-then-mosaic PIPELINE: a ``stacking_pyramid`` DAG
of ``--groups`` stack tasks (each coadding ``--group-size`` image files into
one produced stack) feeding ONE mosaic task that reads every produced stack.
One task callable, :func:`stack_or_mosaic`, serves both stages, dispatching
on the input oid shape: catalog images (``astro.g{g}.o{k}``) ->
calibrate/shift/accumulate; produced stacks (``astro.stack{g}``) -> a pure
coadd through the same kernel with zero shift/sky.

``--flat`` runs a seeded §4.3 StackingTrace (every file accessed
``locality`` times, order shuffled) of independent one-stage tasks
(:func:`stack_object`).

Task functions receive their inputs as tensors on the runtime's device (the
executors' caches live there) and compute on that device.  All randomness
comes from fixed seeds (file content from the file's id, shift offsets from
the task's input ids, both drawn with numpy exactly as the reference draws
them), so the pixels -- and the printed summary -- do not depend on thread
timing and agree with the reference's.

  PYTHONPATH=src python -m repro_torch.apps.astro
  PYTHONPATH=src python -m repro_torch.apps.astro --groups 12 --hosts 6
  PYTHONPATH=src python -m repro_torch.apps.astro --flat --locality 10
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.astro_stacking import (GZ_DECOMPRESS_S, RADEC2XY_S,
                                                ROI_SHAPE, workload)
from repro_torch.core import DataObject
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ProvisionerSpec, RuntimeEngine,
                                     WorkloadSpec)
from repro_torch.kernels.stacking import ops as st_ops
from repro_torch.kernels.stacking import stacking as st_kernel

SEED = 0
H, W = ROI_SHAPE
TILES_PER_FILE = 8
FILE_BYTES = TILES_PER_FILE * H * W * 4
#: the host time of one stacking request on the paper's executors (§5.2):
#: radec2xy and decompressing a 2 MB GZ file.  The store here keeps the
#: tiles decoded, and the coadd runs on the card.
HOST_DECODE_S = RADEC2XY_S + GZ_DECOMPRESS_S


def make_tiles(ob: DataObject) -> np.ndarray:
    """Catalog file content derived from the file's id, identical every run:
    a pipeline image ``{name}.g{g}.o{k}`` or a flat-trace file ``img{i}``."""
    if ob.oid.startswith("img"):
        key = [SEED, int(ob.oid[3:])]
    else:
        g, k = ob.oid.split(".")[1:]
        key = [SEED, int(g[1:]), int(k[1:])]
    file_rng = np.random.default_rng(key)
    return file_rng.normal(500, 100, size=(TILES_PER_FILE, H, W)) \
        .astype(np.float32)


#: the catalog's sky model: each tile's sky is this fraction of its mean
#: (``coadd_params`` on the CPU; on a card the prep kernel of
#: ``stacking.coadd_fwd`` takes it as an argument)
SKY_FRACTION = 0.1


def draw_shifts(seed_ids, n: int) -> np.ndarray:
    """The (2, n) float32 sub-pixel shifts of a request over the files
    ``seed_ids``: n dy draws, then n dx draws, of the request's own seeded
    stream (never a shared one, so the pixels do not depend on thread
    scheduling).  One call draws both rows: the same bits as two calls of
    n each."""
    task_rng = np.random.default_rng([SEED + 1, *seed_ids])
    return task_rng.random(2 * n).astype(np.float32).reshape(2, n)


def coadd_params(tiles: torch.Tensor, seed_ids) -> tuple[torch.Tensor, ...]:
    """(sky, cal, dy, dx) for coadding ``tiles`` (N, H, W), on its device:
    sky :data:`SKY_FRACTION` of each tile's mean, cal 1, and
    :func:`draw_shifts`."""
    n = tiles.shape[0]
    sky = tiles.mean(dim=(1, 2)) * SKY_FRACTION
    cal = torch.ones(n, dtype=torch.float32, device=tiles.device)
    # one host-to-device copy for both shift vectors
    dydx = torch.from_numpy(draw_shifts(seed_ids, n)).to(tiles.device)
    dy, dx = dydx.unbind(0)
    return sky, cal, dy, dx


def _coadd(tiles: torch.Tensor, seed_ids) -> torch.Tensor:
    """Calibrate -> sub-pixel shift -> accumulate via the stacking kernel.

    On a card the request's coadd is one call into the kernel library
    (``stacking.coadd_fwd``): the sky means, unit cals and shifts are made
    by a hand-written kernel beside the stacking kernel, and the shifts
    travel inside the launch.  The executors are many threads sharing the
    interpreter lock and one stream; the PyTorch calls of ``coadd_params``
    each give up the lock, and its copy of the shifts from pageable memory
    synchronises the shared stream, so each request would wait for the
    work of every other.  This path does neither, and computes the same
    coadd in fp32 (the sky means summed in another order).  On the CPU the
    plain version runs on ``coadd_params``."""
    if tiles.is_cuda:
        return st_kernel.coadd_fwd(
            tiles, draw_shifts(seed_ids, tiles.shape[0]), SKY_FRACTION)
    return st_ops.stack_rois(tiles, *coadd_params(tiles, seed_ids))


def _tiles(files: list) -> torch.Tensor:
    """All tiles of the input files as one (N, H, W) tensor; one file's
    tensor is used as it is (the kernel only reads it)."""
    return files[0] if len(files) == 1 else torch.cat(files, dim=0)


def stack_object(inputs):
    """Flat task: coadd every tile of every input file (``img{i}``) into
    one ROI -- one file (classic) or a whole stack group (k-input join)."""
    tiles = _tiles(list(inputs.values()))
    return _coadd(tiles, [int(oid[3:]) for oid in inputs])


def decode_and_stack(inputs):
    """Flat task that first holds its executor for the paper's host time of
    a request (``HOST_DECODE_S``), then coadds like :func:`stack_object`:
    the service time a pool of executors shares out."""
    time.sleep(HOST_DECODE_S)
    return stack_object(inputs)


def stack_or_mosaic(inputs):
    """Pipeline task: ONE callable for both stages, dispatched on the oids."""
    oids = list(inputs)
    if all(o.split(".")[-1].startswith("stack") for o in oids):
        # mosaic stage: inputs are PRODUCED stacks (h, w); pure coadd
        # through the same kernel (zero sky, unit cal, zero shift)
        tiles = torch.stack(list(inputs.values()))
        n = tiles.shape[0]
        zeros = torch.zeros(n, dtype=torch.float32, device=tiles.device)
        ones = torch.ones(n, dtype=torch.float32, device=tiles.device)
        return st_ops.stack_rois(tiles, zeros, ones, zeros, zeros)
    # stack stage: inputs are catalog files of TILES_PER_FILE tiles
    tiles = _tiles(list(inputs.values()))
    seed_ids = [int(o.split(".")[2][1:]) for o in oids]
    return _coadd(tiles, seed_ids)


# --------------------------------------------------------------------------
# pipeline mode (default): stacking_pyramid DAG, one two-stage task_fn
# --------------------------------------------------------------------------

def pipeline_spec(groups: int, group_size: int, hosts: int,
                  policy: str = "max-compute-util") -> ExperimentSpec:
    return ExperimentSpec(
        name="astro",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=hosts),
        cache=CacheSpec(capacity_bytes=1 << 30),
        policy=policy,
        workload=WorkloadSpec(
            name="astro",
            dag={"kind": "stacking_pyramid", "n_groups": groups,
                 "group_size": group_size, "object_bytes": FILE_BYTES,
                 "stack_bytes": H * W * 4, "mosaic_bytes": H * W * 4,
                 "seed": SEED}),
        seed=SEED)


def run_pipeline(args) -> int:
    spec = pipeline_spec(args.groups, args.group_size, args.hosts, args.policy)
    eng = RuntimeEngine(device=args.device).prepare(spec)
    rep = eng.run(task_fn=stack_or_mosaic, payload_factory=make_tiles,
                  time_scale=args.time_scale, timeout=600.0)
    done = {t.tid: t for t in eng.runtime.dispatcher.completed}
    stacks = [done[f"astro-stack{g}"].result for g in range(args.groups)]
    mosaic = done["astro-mosaic"].result
    assert all(tuple(s.shape) == ROI_SHAPE for s in stacks)
    assert tuple(mosaic.shape) == ROI_SHAPE
    print(f"# wall time {rep.wall_s:.2f}s (time_scale {args.time_scale})",
          file=sys.stderr)
    print(f"stacked {args.groups} groups x {args.group_size} files, then "
          f"mosaicked, on {args.hosts} hosts")
    print(f"  cache hit ratio: {rep.cache_hit_ratio:.2%} "
          f"(mosaic inputs all scheduler-produced)")
    print(f"  slowdown: from-arrival {rep.slowdown_from_arrival:.2f} "
          f"from-ready {rep.slowdown_from_ready:.2f} "
          f"(gap = mosaic dep-wait)")
    cached = (rep.bytes_by_kind["c2c"] + rep.bytes_by_kind["local"]) / 1e6
    print(f"  bytes: store={rep.bytes_by_kind['store_read'] / 1e6:.1f}MB "
          f"cache-served={cached:.1f}MB")
    print(f"  mosaic pixel mean: {float(mosaic.mean()):.2f}")
    eng.shutdown()
    return 0


# --------------------------------------------------------------------------
# flat mode (--flat): the one-stage StackingTrace shape
# --------------------------------------------------------------------------

def flat_spec(objects: int, locality: float, hosts: int,
              policy: str = "max-compute-util",
              stack_width: int = 1) -> ExperimentSpec:
    """Poisson arrivals x §4.3 stacking-trace popularity over an ``img{i}``
    catalog of ``objects / locality`` files, on ``hosts`` 1 GiB-cache
    workers."""
    n_files = max(int(objects / locality), 1)
    return ExperimentSpec(
        name="astro",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=hosts),
        cache=CacheSpec(capacity_bytes=1 << 30),
        policy=policy,
        workload=WorkloadSpec(
            name="astro",
            arrivals={"kind": "PoissonArrivals",
                      "rate_per_s": max(objects / 2.0, 1.0)},
            popularity={"kind": "StackingTrace",
                        "locality": max(int(locality), 1),
                        "shuffle_seed": SEED, "k": stack_width,
                        "corr": 1.0},
            n_tasks=objects, n_objects=n_files,
            object_bytes=FILE_BYTES, object_prefix="img", seed=SEED),
        seed=SEED)


#: the quickstart's elastic provisioner knobs with the ANL/UC testbed's pool
#: of 64 executors
ELASTIC_PROVISIONER = ProvisionerSpec(
    policy="exponential", min_executors=1, max_executors=64,
    queue_threshold=2, idle_timeout_s=4.0, trigger_cooldown_s=1.0,
    period_s=1.0)


def elastic_spec(n_tasks: int, n_files: int, arrivals: dict,
                 provisioner: ProvisionerSpec = ELASTIC_PROVISIONER,
                 ) -> ExperimentSpec:
    """§4.3 stacking-trace requests over an ``img{i}`` catalog of
    ``n_files`` files, arriving as ``arrivals`` (an arrival binding, e.g. a
    ``SineWaveArrivals`` one), on an elastic pool: one 1 GiB-cache executor
    at the start, grown and shrunk by ``provisioner``.  Each request costs
    ``HOST_DECODE_S`` of compute (run it with :func:`decode_and_stack`)."""
    return ExperimentSpec(
        name="astro-elastic",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=1),
        cache=CacheSpec(capacity_bytes=1 << 30),
        policy="max-compute-util",
        provisioner=provisioner,
        workload=WorkloadSpec(
            name="astro",
            arrivals=arrivals,
            popularity={"kind": "StackingTrace",
                        "locality": max(round(n_tasks / n_files), 1),
                        "shuffle_seed": SEED, "k": 1, "corr": 1.0},
            n_tasks=n_tasks, n_objects=n_files,
            object_bytes=FILE_BYTES, object_prefix="img",
            compute_seconds=HOST_DECODE_S, seed=SEED),
        seed=SEED)


def pool_shape(pool_log, period_s: float) -> dict:
    """What a pool log shows under two periods of a phase-0 sine wave
    (peaks at a quarter period, troughs at three quarters): whether the
    pool grew in each period, whether it shrank between the two peaks, and
    its low, its peak and its numbers of rises and falls."""
    steps = list(zip(pool_log, pool_log[1:]))
    grew = [any(n > m and k * period_s <= t < (k + 1) * period_s
                for (_, m), (t, n) in steps) for k in (0, 1)]
    shrank = any(n < m and period_s / 4 <= t < 1.25 * period_s
                 for (_, m), (t, n) in steps)
    return {"grew": grew, "shrank": shrank,
            "low": min(n for _, n in pool_log),
            "peak": max(n for _, n in pool_log),
            "rises": sum(n > m for (_, m), (_, n) in steps),
            "falls": sum(n < m for (_, m), (_, n) in steps)}


def run_flat(args) -> int:
    wl_cfg = workload(args.locality)
    n_files = max(int(args.objects / args.locality), 1)
    spec = flat_spec(args.objects, args.locality, args.hosts, args.policy,
                     args.stack_width)
    eng = RuntimeEngine(device=args.device).prepare(spec)
    rep = eng.run(task_fn=stack_object, payload_factory=make_tiles,
                  time_scale=args.time_scale, timeout=600.0)
    done = {t.tid: t for t in eng.runtime.dispatcher.completed}
    results = [done[f"astro-{i}"].result for i in range(args.objects)]
    assert all(tuple(r.shape) == ROI_SHAPE for r in results)
    ideal = wl_cfg.ideal_cache_hit_ratio
    # deterministic summary -> stdout; wall-clock timing -> stderr
    print(f"# wall time {rep.wall_s:.2f}s (time_scale {args.time_scale})",
          file=sys.stderr)
    print(f"stacked {len(results)} objects over {n_files} files "
          f"(locality {args.locality}) on {args.hosts} hosts")
    print(f"  cache hit ratio: {rep.cache_hit_ratio:.2%} "
          f"(paper ideal 1-1/L = {ideal:.0%}; paper achieves >=90% of it)")
    cached = (rep.bytes_by_kind["c2c"] + rep.bytes_by_kind["local"]) / 1e6
    print(f"  bytes: store={rep.bytes_by_kind['store_read'] / 1e6:.1f}MB "
          f"cache-served={cached:.1f}MB")
    print(f"  sample stacked-pixel mean: {float(results[0].mean()):.2f}")
    eng.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flat", action="store_true",
                    help="one-stage StackingTrace workload instead of the "
                         "stack-then-mosaic pipeline")
    ap.add_argument("--groups", type=int, default=8,
                    help="pipeline: stack tasks (mosaic fan-in)")
    ap.add_argument("--group-size", type=int, default=4,
                    help="pipeline: image files coadded per stack")
    ap.add_argument("--locality", type=float, default=10,
                    choices=[1, 2, 3, 4, 5, 10, 20, 30])
    ap.add_argument("--objects", type=int, default=96,
                    help="flat: number of stacking objects (scaled workload)")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--policy", default="max-compute-util")
    ap.add_argument("--stack-width", type=int, default=1,
                    help="flat: files coadded per request (k-input joins "
                         "over stack groups; 1 = classic one-file tasks)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="wall seconds per workload second for the paced "
                         "submitter (0 = submit as fast as possible)")
    ap.add_argument("--device", default="cuda",
                    help="where executor caches and the kernel run "
                         "(cuda, or cpu for the plain version)")
    args = ap.parse_args(argv)
    return run_flat(args) if args.flat else run_pipeline(args)


if __name__ == "__main__":
    raise SystemExit(main())
