"""Seed-paired cartesian sweeps over `ExperimentSpec` fields.

Counterpart of ``repro.experiments.sweep``.  A :class:`Sweep` expands
``{dotted.path: [values...]}`` grids into cells (one spec per combination,
insertion-ordered keys x value order), executes each cell on a fresh
engine, and optionally writes:

  manifest.json   base spec + grid + per-cell overrides/fingerprints --
                  enough to regenerate any cell without the results file
  results.jsonl   one line per cell: {"index", "overrides", "report"}
                  with the full RunReport dict (RunReport.from_dict reads
                  it back)

Seed pairing.  Comparative claims (policy A vs policy B) need every cell
to see the *same arrival sequence and object draws*.  Within one sweep all
cells share the base spec's workload seed (sweeping ``workload.seed``
directly is rejected); the ``seeds=[...]`` axis adds paired replications:
replication r re-runs EVERY cell with ``seed`` and ``workload.seed`` both
set to ``seeds[r]``, so cells stay comparable within each replication.

Workloads are generated once per distinct binding and shared across cells
(a `Workload` is immutable; engines materialise fresh Tasks per run), so an
8-cell policy sweep pays one generation, not eight.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

from .engines import build_workload, make_engine
from .report import RunReport
from .spec import ExperimentSpec, with_overrides


@dataclass(frozen=True)
class SweepCell:
    index: int
    overrides: dict          # dotted path -> value (JSON-able)
    spec: ExperimentSpec


class Sweep:
    def __init__(self, base: ExperimentSpec,
                 grid: Mapping[str, Sequence],
                 *, seeds: Optional[Sequence[int]] = None,
                 engine: str = "sim",
                 name: Optional[str] = None) -> None:
        for key in grid:
            if key in ("workload.seed", "seed"):
                raise ValueError(
                    f"do not sweep {key!r} in the grid -- use seeds=[...] "
                    f"for seed-paired replications (pairing is the point)")
        self.base = base
        self.grid = {k: list(v) for k, v in grid.items()}
        self.seeds = list(seeds) if seeds is not None else None
        self.engine = engine
        self.name = name or f"{base.name}-sweep"

    # ------------------------------------------------------------------
    def cells(self) -> list[SweepCell]:
        keys = list(self.grid)
        value_combos = list(itertools.product(*(self.grid[k] for k in keys)))
        reps = self.seeds if self.seeds is not None else [None]
        out: list[SweepCell] = []
        for seed in reps:
            for combo in value_combos:
                overrides = dict(zip(keys, combo))
                if seed is not None:
                    overrides["seed"] = seed
                    overrides["workload.seed"] = seed
                out.append(SweepCell(
                    index=len(out), overrides=overrides,
                    spec=with_overrides(self.base, overrides)))
        return out

    # ------------------------------------------------------------------
    def run(self, out_dir: Optional[str] = None,
            run_kw: Optional[dict] = None,
            progress: Optional[Callable[[SweepCell, RunReport], None]] = None,
            ) -> list[tuple[SweepCell, RunReport]]:
        """Execute every cell; returns [(cell, report), ...] in cell order.
        ``run_kw`` is forwarded to every engine ``run()`` call."""
        cells = self.cells()
        out_path = Path(out_dir) if out_dir is not None else None
        if out_path is not None:
            out_path.mkdir(parents=True, exist_ok=True)
            (out_path / "manifest.json").write_text(json.dumps({
                "sweep": self.name,
                "engine": self.engine,
                "seed_paired": True,
                "seeds": self.seeds,
                "grid": self.grid,
                "n_cells": len(cells),
                "base": self.base.to_dict(),
                "cells": [{"index": c.index, "overrides": c.overrides,
                           "spec_sha": c.spec.fingerprint()}
                          for c in cells],
            }, indent=2, sort_keys=True) + "\n")
        wl_cache: dict[str, object] = {}
        results: list[tuple[SweepCell, RunReport]] = []
        results_f = (out_path / "results.jsonl").open("w") \
            if out_path is not None else None
        try:
            for cell in cells:
                wkey = json.dumps(dataclasses.asdict(cell.spec.workload),
                                  sort_keys=True)
                if wkey not in wl_cache:
                    wl_cache[wkey] = build_workload(cell.spec.workload)
                eng = make_engine(self.engine)
                try:
                    eng.prepare(cell.spec, workload=wl_cache[wkey])
                    report = eng.run(**(run_kw or {}))
                finally:
                    eng.shutdown()   # runtime workers must not outlive a cell
                results.append((cell, report))
                if results_f is not None:
                    results_f.write(json.dumps({
                        "index": cell.index,
                        "overrides": cell.overrides,
                        "report": report.as_dict(),
                    }, sort_keys=True) + "\n")
                    results_f.flush()
                if progress is not None:
                    progress(cell, report)
        finally:
            if results_f is not None:
                results_f.close()
        return results


def load_results(out_dir: str) -> list[tuple[dict, RunReport]]:
    """Read a sweep's results.jsonl back as [(line dict sans report,
    RunReport), ...]."""
    out = []
    with (Path(out_dir) / "results.jsonl").open() as f:
        for ln in f:
            if not ln.strip():
                continue
            rec = json.loads(ln)
            rep = RunReport.from_dict(rec.pop("report"))
            out.append((rec, rep))
    return out
