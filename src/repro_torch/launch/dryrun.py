"""Dry run for one card: what every (architecture x input-shape) cell
costs, and whether it fits.

The port of the reference's ``repro.launch.dryrun``.  The reference lowers
and compiles every cell for its 256- and 512-chip TPU meshes; the port runs
on one card, so each cell's step runs once on the ``meta`` device
(``launch.cellrun.run_cell``: FLOPs, argument, output, temp and peak bytes)
and is held against the card's memory.  It prints one ``OK``/``SKIP``
line per cell (``FAIL`` where a cell's meta pass raised), writes one JSON
per cell to ``--out``, and ends with ``dry-run: N ok, N failed, N
skipped``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-15b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-base \\
      --device cpu --memory-gb 80        # without a card

The card's name, power limit and memory are read from the card: without
one it raises, unless it is told ``--device cpu`` and ``--memory-gb``.
``--fast`` skips the depth fit and runs one meta pass at full depth
(exact, but slow for deep Mamba stacks).  The meta passes of the cells
(two a cell: ``cellrun.fit_depths``) run ``WORKERS`` at a time, each in a
process of its own, the Mamba cells' first: their meta passes step
through the sequence in Python, and the depth-3 pass of jamba's
prefill_32k alone takes about 5 minutes of host time.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import pathlib
import sys
from concurrent.futures import ProcessPoolExecutor

WORKERS = 4


def _card(device: str, memory_gb):
    """(label, memory in bytes) of the device the cells are held to."""
    import torch

    from repro_torch.device import describe, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        return describe(dev), float(memory_gb * 1e9 if memory_gb else total)
    if not memory_gb:
        raise ValueError("--device cpu has no card memory to hold the cells "
                         "to: give --memory-gb")
    return f"no card: {memory_gb} GB given", float(memory_gb * 1e9)


def _pass(job: tuple[str, str, int]) -> tuple:
    """One meta pass (arch, shape, depth in blocks) of a cell."""
    from repro_torch.configs import REGISTRY, SHAPES
    from repro_torch.launch.cellrun import depth_pass
    from repro_torch.launch.mesh import make_card_mesh

    arch, shape, k = job
    return depth_pass(REGISTRY[arch], SHAPES[shape], make_card_mesh(), k)


def _longest_first(job: tuple[str, str, int]) -> tuple:
    """The order passes start in: the Mamba layers' sequence loops first
    (decode has none), deepest and longest first."""
    from repro_torch.configs import REGISTRY, SHAPES

    cfg, shape = REGISTRY[job[0]], SHAPES[job[1]]
    scans = (shape.mode != "decode"
             and any(s.kind == "mamba" for s in cfg.pattern))
    return (not scans, -job[2] * cfg.period, -shape.seq_len)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="skip the depth-variant fit: one meta pass at full "
                         "depth (exact, slow for deep Mamba stacks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's memory) or cpu (needs "
                         "--memory-gb)")
    ap.add_argument("--memory-gb", type=float, default=None,
                    help="memory to hold each cell's peak to, in GB (default:"
                         " the card's)")
    args = ap.parse_args(argv)

    from repro_torch.configs import REGISTRY, SHAPES, cells, skip_reason

    card, memory = _card(args.device, args.memory_gb)
    mesh_name = "one_card"
    print(f"dry-run on {card}: {memory / 1e9:.2f} GB", flush=True)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.arch or args.shape:
        archs = [REGISTRY[args.arch]] if args.arch else list(REGISTRY.values())
        shapes = [SHAPES[args.shape]] if args.shape else list(SHAPES.values())
        todo = [(c, s, skip_reason(c, s)) for c in archs for s in shapes]
    else:
        todo = list(cells(include_skipped=True))

    n_ok = n_fail = n_skip = 0
    runs = []
    for cfg, shape, reason in todo:
        tag = f"{cfg.name}__{shape.name}__{mesh_name}"
        path = outdir / f"{tag}.json"
        if reason is not None:
            n_skip += 1
            path.write_text(json.dumps(
                {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                 "ok": False, "skipped": True, "reason": reason}, indent=1))
            print(f"  SKIP {tag}: {reason}", flush=True)
            continue
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("ok"):
                n_ok += 1
                print(f"  CACHED {tag}", flush=True)
                continue
        runs.append((path, cfg, shape))
    from repro_torch.launch.cellrun import fit_depths, run_cell
    from repro_torch.launch.mesh import make_card_mesh

    mesh = make_card_mesh()
    if len(runs) > 1:
        jobs = sorted(((cfg.name, shape.name, k) for _, cfg, shape in runs
                       for k in fit_depths(cfg, not args.fast)),
                      key=_longest_first)
        # spawned, not forked: the parent may hold a CUDA context
        with ProcessPoolExecutor(
                WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {job: pool.submit(_pass, job) for job in jobs}
            results = []
            for _, cfg, shape in runs:
                # a pass's result, or the exception it raised
                passes = {k: (f.exception() or f.result()) for k, f in (
                    (k, futures[(cfg.name, shape.name, k)])
                    for k in fit_depths(cfg, not args.fast))}
                results.append(run_cell(
                    cfg, shape, mesh, mesh_name, loop_correct=not args.fast,
                    memory_bytes=memory, passes=passes).to_dict())
    else:
        results = [run_cell(cfg, shape, mesh, mesh_name,
                            loop_correct=not args.fast, memory_bytes=memory
                            ).to_dict() for _, cfg, shape in runs]
    for (path, *_), d in zip(runs, results):
        d.update(skipped=False, card=card)
        path.write_text(json.dumps(d, indent=1))
        if d["ok"]:
            n_ok += 1
        else:
            n_fail += 1
    print(f"dry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"(documented long_500k skips)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
